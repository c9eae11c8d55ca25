"""WAV I/O in numpy (the port's copy of the numpy path of
audiodec_tpu/data/wav.py; the native csrc/wavio.cpp reader is not ported).

Reads PCM16/24/32 and float32 RIFF files to float32 (T, C) arrays in
[-1, 1], or PCM16 files to their raw int16 samples; writes PCM16.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np


def _parse_header(f) -> Tuple[int, int, int, int, int, int]:
    """-> (format, channels, sample_rate, bits, data_offset, data_size)"""
    riff = f.read(12)
    if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    fmt = None
    data = None
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            break
        cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
        if cid == b"fmt ":
            buf = f.read(size + (size & 1))
            tag, ch, sr = struct.unpack("<HHI", buf[:8])
            bits = struct.unpack("<H", buf[14:16])[0]
            if tag == 0xFFFE and size >= 26:
                tag = struct.unpack("<H", buf[24:26])[0]
            fmt = (tag, ch, sr, bits)
        elif cid == b"data":
            data = (f.tell(), size)
            f.seek(size + (size & 1), 1)
        else:
            f.seek(size + (size & 1), 1)
        if fmt and data:
            break
    if not fmt or not data:
        raise ValueError("missing fmt/data chunk")
    return (*fmt, *data)


def wav_info(path: str) -> Tuple[int, int, int]:
    """-> (sample_rate, channels, frames), from the header only."""
    with open(path, "rb") as f:
        tag, ch, sr, bits, off, size = _parse_header(f)
    return sr, ch, size // (bits // 8) // ch


def wav_is_pcm16(path: str) -> bool:
    """Header-only probe: True iff the file parses as PCM16 WAV."""
    try:
        with open(path, "rb") as f:
            tag, _, _, bits, _, _ = _parse_header(f)
        return tag == 1 and bits == 16
    except (OSError, ValueError):
        return False


def read_wav_pcm16(path: str):
    """-> (int16 array (T, C), sample_rate) if the file is PCM16, else None
    (also on any parse failure: the caller falls back to read_wav).  x /
    32768 on the device is exact in f32, so it equals read_wav's floats."""
    try:
        with open(path, "rb") as f:
            tag, ch, sr, bits, off, size = _parse_header(f)
            if tag != 1 or bits != 16:
                return None
            f.seek(off)
            raw = f.read(size)
        x = np.frombuffer(raw, "<i2", count=len(raw) // 2)
        return x.reshape(-1, ch), sr
    except (OSError, ValueError):
        return None


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """-> (float32 array (T, C) in [-1, 1], sample_rate)"""
    with open(path, "rb") as f:
        tag, ch, sr, bits, off, size = _parse_header(f)
        f.seek(off)
        raw = f.read(size)
    n = size // (bits // 8)
    if tag == 3 and bits == 32:
        x = np.frombuffer(raw, "<f4", count=n).astype(np.float32)
    elif tag == 1 and bits == 16:
        x = np.frombuffer(raw, "<i2", count=n).astype(np.float32) / 32768.0
    elif tag == 1 and bits == 24:
        b = np.frombuffer(raw, np.uint8, count=n * 3).reshape(-1, 3)
        v = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
             | (b[:, 2].astype(np.int32) << 16))
        v = np.where(v & 0x800000, v - 0x1000000, v)
        x = v.astype(np.float32) / 8388608.0
    elif tag == 1 and bits == 32:
        x = (np.frombuffer(raw, "<i4", count=n).astype(np.float32)
             / 2147483648.0)
    else:
        raise ValueError(f"unsupported WAV format tag={tag} bits={bits}")
    return x.reshape(-1, ch), sr


def write_wav(path: str, data: np.ndarray, sample_rate: int) -> None:
    """Write (T,) or (T, C) data as PCM16: float input is scaled by 32768,
    rounded half away from zero and clipped; int16 input (already
    quantized, e.g. on the device) is written as it is."""
    data = np.asarray(data)
    if data.dtype != np.int16:
        data = data.astype(np.float32)
    if data.ndim == 1:
        data = data[:, None]
    data = np.ascontiguousarray(data)
    frames, ch = data.shape
    if data.dtype == np.int16:
        q = data.astype("<i2", copy=False)
    else:
        v = data * 32768.0
        q = np.clip(np.trunc(v + np.where(v >= 0, 0.5, -0.5)),
                    -32768, 32767).astype("<i2")
    payload = q.tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, ch, sample_rate,
                                      sample_rate * ch * 2, ch * 2, 16))
        f.write(b"data" + struct.pack("<I", len(payload)))
        f.write(payload)
