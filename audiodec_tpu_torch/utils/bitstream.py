"""Bitstream serialization for RVQ codes: the codec's on-disk/wire format
(the port's copy of audiodec_tpu/utils/bitstream.py; the bytes are the
same).

The reference moves raw index tensors between threads (ref:
utils/audiodec.py:100-106) but never defines a byte format; a deployable
codec needs one.  Frames are packed little-endian at ceil(log2(codebook_size))
bits per code — 10 bits for the canonical 8x1024 setup, giving exactly
48000/300 * 8 * 10 = 12.8 kbps — with a small self-describing header.

Header (little-endian): magic b'ADTC', u8 version, u8 num_q, u16 bits_per,
u32 sample_rate, u32 hop, u64 n_frames.
"""

from __future__ import annotations

import math
import struct
from typing import Tuple

import numpy as np

MAGIC = b"ADTC"
_HDR = struct.Struct("<4sBBHIIQ")


def bits_for(codebook_size: int) -> int:
    return max(1, math.ceil(math.log2(codebook_size)))


def pack_codes(idx: np.ndarray, codebook_size: int, sample_rate: int,
               hop: int) -> bytes:
    """idx: (T, Q) int (non-flattened, each in [0, codebook_size)) -> bytes."""
    idx = np.asarray(idx)
    assert idx.ndim == 2, "expect (T, Q) indices"
    t, q = idx.shape
    bits = bits_for(codebook_size)
    flat = idx.astype(np.uint64).ravel()  # frame-major, quantizer minor
    assert flat.size == 0 or int(flat.max()) < (1 << bits)

    n_bits = flat.size * bits
    buf = np.zeros((n_bits + 7) // 8, np.uint8)
    # little-endian bit packing
    positions = np.arange(flat.size, dtype=np.uint64) * np.uint64(bits)
    for b in range(bits):
        bitvals = ((flat >> np.uint64(b)) & np.uint64(1)).astype(np.uint8)
        pos = positions + np.uint64(b)
        np.bitwise_or.at(buf, (pos // 8).astype(np.int64),
                         bitvals << (pos % np.uint64(8)).astype(np.uint8))
    header = _HDR.pack(MAGIC, 1, q, bits, sample_rate, hop, t)
    return header + buf.tobytes()


def unpack_codes(data: bytes) -> Tuple[np.ndarray, dict]:
    """bytes -> ((T, Q) int32 indices, info dict).

    Raises ValueError on malformed input (bad magic/version, impossible
    field values, or a payload that doesn't match the header) — the header
    is validated BEFORE any size-dependent allocation, so a corrupt or
    hostile packet can't trigger an unbounded allocation on a receiver."""
    if len(data) < _HDR.size:
        raise ValueError("truncated bitstream header")
    magic, version, q, bits, sr, hop, t = _HDR.unpack_from(data, 0)
    if magic != MAGIC or version != 1:
        raise ValueError("bad bitstream header")
    if not (1 <= q <= 255 and 1 <= bits <= 31):
        raise ValueError(f"impossible bitstream fields: q={q} bits={bits}")
    expected = _HDR.size + (t * q * bits + 7) // 8
    if len(data) != expected:
        raise ValueError(f"bitstream length {len(data)} != expected "
                         f"{expected} for {t} frames")
    buf = np.frombuffer(data, np.uint8, offset=_HDR.size)
    n = t * q
    out = np.zeros(n, np.uint64)
    positions = np.arange(n, dtype=np.uint64) * np.uint64(bits)
    for b in range(bits):
        pos = positions + np.uint64(b)
        bitvals = (buf[(pos // 8).astype(np.int64)]
                   >> (pos % np.uint64(8)).astype(np.uint8)) & 1
        out |= bitvals.astype(np.uint64) << np.uint64(b)
    idx = out.reshape(t, q).astype(np.int32)
    return idx, {"num_q": q, "bits_per_code": bits, "sample_rate": sr,
                 "hop": hop, "n_frames": t,
                 "kbps": sr / hop * q * bits / 1000.0}
