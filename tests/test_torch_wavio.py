"""The native WAV codec (`audiodec_tpu_torch/csrc/wavio.cpp`, built by
`ops/kernels/_build.py` with g++) behind `data/wav.py`, against the module's
numpy version and the JAX package's numpy reader and writer
(`audiodec_tpu/data/wav.py` with its native library off).

Files: seeded samples as PCM 16/24/32 and float32, mono and stereo, with
a plain `fmt ` chunk and with WAVE_FORMAT_EXTENSIBLE, and a `LIST` chunk
before the data.  Reads compare bit for bit, writes byte for byte.
"""

import struct

import numpy as np
import pytest

from audiodec_tpu.data import wav as jax_wav
from audiodec_tpu_torch.data import wav

SR = 44100
FORMATS = [(1, 16), (1, 24), (1, 32), (3, 32)]


@pytest.fixture
def numpy_jax_wav(monkeypatch):
    monkeypatch.setattr(jax_wav, "_native", lambda: None)
    return jax_wav


def _encode(x, tag, bits):
    if tag == 3:
        return x.astype("<f4").tobytes()
    scale = float(2 ** (bits - 1))
    q = np.clip(np.round(x * scale), -scale, scale - 1).astype(np.int64)
    if bits == 16:
        return q.astype("<i2").tobytes()
    if bits == 32:
        return q.astype("<i4").tobytes()
    q = q.reshape(-1) & 0xFFFFFF
    return np.stack([q & 0xFF, (q >> 8) & 0xFF, q >> 16], -1).astype(
        np.uint8).tobytes()


def _riff(path, x, tag, bits, extensible, extra_chunk):
    ch = x.shape[1]
    payload = _encode(x, tag, bits)
    align = ch * bits // 8
    if extensible:
        fmt = struct.pack("<HHIIHHHHI", 0xFFFE, ch, SR, SR * align, align,
                          bits, 22, bits, 0) + struct.pack("<H", tag) + \
            b"\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71"
    else:
        fmt = struct.pack("<HHIIHH", tag, ch, SR, SR * align, align, bits)
    body = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
    if extra_chunk:
        body += b"LIST" + struct.pack("<I", 5) + b"INFOx\x00"  # odd: padded
    body += b"data" + struct.pack("<I", len(payload)) + payload
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)
    return path


@pytest.mark.parametrize("extensible", [False, True])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("tag,bits", FORMATS)
def test_reads_match_numpy_and_jax(tmp_path, numpy_jax_wav, tag, bits,
                                   channels, extensible):
    rng = np.random.default_rng(bits + 10 * channels + tag)
    x = rng.uniform(-1, 1, (997, channels)).astype(np.float32)
    path = str(_riff(tmp_path / "x.wav", x, tag, bits, extensible,
                     extra_chunk=channels == 2))
    got, sr = wav.read_wav(path)
    plain, sr_plain = wav.read_wav_plain(path)
    want, sr_jax = numpy_jax_wav._py_read(path)
    assert sr == sr_plain == sr_jax == SR
    assert got.dtype == plain.dtype == want.dtype == np.float32
    assert got.shape == (997, channels)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, want)
    assert (wav.wav_info(path) == wav.wav_info_plain(path)
            == numpy_jax_wav.wav_info(path) == (SR, channels, 997))
    assert wav.wav_is_pcm16(path) == ((tag, bits) == (1, 16))


@pytest.mark.parametrize("channels", [1, 2])
def test_writes_match_numpy_and_jax_and_read_back(tmp_path, numpy_jax_wav,
                                                  channels):
    """float input (beyond [-1, 1] and at the half-LSB edges) through the
    native writer, the numpy writer and JAX's: the same bytes, read back
    as the PCM16 samples; int16 input written as it is."""
    rng = np.random.default_rng(channels)
    edges = np.array([0.5, -0.5, 1.5, -1.5, 32767.5, -32768.5, 40000,
                      -40000, 0.49999997 * 2, 0.49999997]) / 32768.0
    x = np.concatenate([rng.uniform(-1.2, 1.2, 1000 * channels - 10),
                        edges]).astype(np.float32).reshape(-1, channels)
    paths = {k: str(tmp_path / f"{k}.wav") for k in ("native", "plain",
                                                     "jax")}
    wav.write_wav(paths["native"], x, SR)
    wav.write_wav_plain(paths["plain"], x, SR)
    numpy_jax_wav.write_wav(paths["jax"], x, SR)
    data = {k: open(p, "rb").read() for k, p in paths.items()}
    assert data["native"] == data["plain"] == data["jax"]
    q, sr = wav.read_wav_pcm16(paths["native"])
    assert sr == SR and q.shape == x.shape
    back, _ = wav.read_wav(paths["native"])
    np.testing.assert_array_equal(back, q.astype(np.float32) / 32768.0)
    assert np.abs(back - np.clip(x, -1, 32767 / 32768)).max() <= 0.5 / 32768
    wav.write_wav(paths["native"], q, SR)
    assert open(paths["native"], "rb").read() == data["plain"]


def test_bad_files_raise(tmp_path):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFX" + b"\x00" * 40)
    for read in (wav.read_wav, wav.wav_info):
        with pytest.raises(ValueError):
            read(str(bad))
        with pytest.raises(OSError):
            read(str(tmp_path / "missing.wav"))
    with pytest.raises(ValueError):
        wav.read_wav_plain(str(bad))
