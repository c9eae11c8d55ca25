"""WAV I/O (counterpart of audiodec_tpu/data/wav.py): the native codec
csrc/wavio.cpp through ctypes, beside its plain numpy version.

Reads PCM16/24/32 and float32 RIFF files, WAVE_FORMAT_EXTENSIBLE headers
included, to float32 (T, C) arrays in [-1, 1], or PCM16 files to their
raw int16 samples; writes PCM16.  `read_wav`, `wav_info` and the float
path of `write_wav` go through the native library, which
ops/kernels/_build.py compiles with g++ at first use (a failed build
raises; nothing falls back); `read_wav_plain` and `write_wav_plain` are
the numpy versions it is held to, sample for sample and byte for byte.
The header probes (`wav_is_pcm16`, `read_wav_pcm16`) and int16 writes
are numpy, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from typing import Tuple

import numpy as np

_LOCK = threading.Lock()
_LIB = None


def native() -> ctypes.CDLL:
    """The WAV codec's library, built at the first call (once per
    process; the data loader's threads may race to it)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            from audiodec_tpu_torch.ops.kernels import _build
            lib = _build.load("wavio")
            lib.wav_info.argtypes = [ctypes.c_char_p,
                                     ctypes.POINTER(ctypes.c_int),
                                     ctypes.POINTER(ctypes.c_int),
                                     ctypes.POINTER(ctypes.c_int64)]
            lib.wav_info.restype = ctypes.c_int
            lib.wav_read_f32.argtypes = [ctypes.c_char_p,
                                         ctypes.POINTER(ctypes.c_float),
                                         ctypes.c_int64]
            lib.wav_read_f32.restype = ctypes.c_int64
            lib.wav_write_pcm16.argtypes = [ctypes.c_char_p,
                                            ctypes.POINTER(ctypes.c_float),
                                            ctypes.c_int64, ctypes.c_int,
                                            ctypes.c_int]
            lib.wav_write_pcm16.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def _failed(path: str, what: str, rc: int):
    # the open fails in Python too, with its own OSError; anything else
    # is the file's content, as the numpy reader's ValueError
    open(path, "rb").close()
    raise ValueError(f"{path}: {what} failed (wavio error {rc}): not a "
                     f"readable PCM16/24/32 or float32 WAV file")


def _native_info(path: str) -> Tuple[int, int, int]:
    sr, ch, fr = ctypes.c_int(), ctypes.c_int(), ctypes.c_int64()
    rc = native().wav_info(path.encode(), ctypes.byref(sr), ctypes.byref(ch),
                           ctypes.byref(fr))
    if rc != 0:
        _failed(path, "wav_info", rc)
    return sr.value, ch.value, fr.value


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
    return _native_info(path)


def wav_info_plain(path: str) -> Tuple[int, int, int]:
    """wav_info in numpy."""
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
    """-> (float32 array (T, C) in [-1, 1], sample_rate), read by the
    native codec."""
    sr, ch, frames = _native_info(path)
    out = np.empty((frames, ch), np.float32)
    got = native().wav_read_f32(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        frames)
    if got < 0:
        _failed(path, "wav_read_f32", got)
    return out[:got], sr


def read_wav_plain(path: str) -> Tuple[np.ndarray, int]:
    """read_wav in numpy."""
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


def _pcm16_file(path: str, q: np.ndarray, sample_rate: int) -> None:
    frames, ch = q.shape
    payload = q.astype("<i2", copy=False).tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, ch, sample_rate,
                                      sample_rate * ch * 2, ch * 2, 16))
        f.write(b"data" + struct.pack("<I", len(payload)))
        f.write(payload)


def _as_frames(data) -> np.ndarray:
    data = np.asarray(data)
    if data.dtype != np.int16:
        data = data.astype(np.float32)
    if data.ndim == 1:
        data = data[:, None]
    return np.ascontiguousarray(data)


def write_wav(path: str, data: np.ndarray, sample_rate: int) -> None:
    """Write (T,) or (T, C) data as PCM16: float input is scaled by 32768,
    rounded half away from zero and clipped, by the native codec; int16
    input (already quantized, e.g. on the device) is written as it is."""
    data = _as_frames(data)
    if data.dtype == np.int16:
        _pcm16_file(path, data, sample_rate)
        return
    frames, ch = data.shape
    rc = native().wav_write_pcm16(
        path.encode(), data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        frames, ch, sample_rate)
    if rc != 0:
        raise OSError(f"{path}: wav_write_pcm16 failed (wavio error {rc})")


def write_wav_plain(path: str, data: np.ndarray, sample_rate: int) -> None:
    """write_wav in numpy."""
    data = _as_frames(data)
    if data.dtype != np.int16:
        v = data * 32768.0
        data = np.clip(np.trunc(v + np.where(v >= 0, 0.5, -0.5)),
                       -32768, 32767).astype("<i2")
    _pcm16_file(path, data, sample_rate)
