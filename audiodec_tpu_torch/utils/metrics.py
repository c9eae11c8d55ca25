"""Waveform quality metrics for codec evaluation, in numpy (counterpart of
audiodec_tpu/utils/metrics.py: `snr_db`, `mel_distance`, `mcd_db`).

The log-mel front end is the port's own copy of the JAX package's
`ops/spectral.py mel_spectrogram` as these metrics call it: torch.stft
conventions (center, reflect padding, periodic Hann window), a slaney mel
filterbank (librosa's default), fmin 0, fmax sr / 2, natural log.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

_EPS = 1e-10   # mel_spectrogram's default clamp


def snr_db(reference: np.ndarray, estimate: np.ndarray) -> float:
    """Signal-to-noise ratio of `estimate` against `reference` in dB."""
    reference = np.asarray(reference, np.float64).ravel()
    estimate = np.asarray(estimate, np.float64).ravel()
    n = min(len(reference), len(estimate))
    reference, estimate = reference[:n], estimate[:n]
    noise = reference - estimate
    p_sig = np.sum(reference ** 2)
    p_noise = np.sum(noise ** 2)
    if p_noise == 0:
        return float("inf")
    return float(10.0 * np.log10(p_sig / max(p_noise, 1e-30)))


@lru_cache(maxsize=32)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float,
                   fmax: float) -> np.ndarray:
    """Slaney-scale, slaney-normalized mel filterbank, (1 + n_fft//2,
    n_mels), float32 (librosa.filters.mel(htk=False, norm='slaney').T)."""
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0

    def hz_to_mel(f):
        f = np.asanyarray(f, dtype=np.float64)
        return np.where(f >= min_log_hz,
                        min_log_mel + np.log(np.maximum(f, 1e-10)
                                             / min_log_hz) / logstep,
                        f / f_sp)

    def mel_to_hz(m):
        m = np.asanyarray(m, dtype=np.float64)
        return np.where(m >= min_log_mel,
                        min_log_hz * np.exp(logstep * (m - min_log_mel)),
                        f_sp * m)

    fftfreqs = np.linspace(0, sr / 2.0, 1 + n_fft // 2)
    mel_f = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax),
                                  n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2 + np.arange(n_mels)] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights.T.astype(np.float32)


def log_mel(x: np.ndarray, sr: int, fft_size: int = 2048, hop: int = 300,
            num_mels: int = 80) -> np.ndarray:
    """Natural-log mel spectrogram of a mono waveform (T,) -> (T', M)."""
    x = np.asarray(x, np.float32).ravel()
    xp = np.pad(x, (fft_size // 2, fft_size // 2), mode="reflect")
    n_frames = 1 + (len(xp) - fft_size) // hop
    idx = (np.arange(n_frames)[:, None] * hop
           + np.arange(fft_size)[None, :])
    n = np.arange(fft_size, dtype=np.float64)
    window = (0.5 * (1.0 - np.cos(2.0 * np.pi * n / fft_size))).astype(
        np.float32)
    spec = np.fft.rfft(xp[idx] * window, n=fft_size, axis=-1)
    power = np.real(spec) ** 2 + np.imag(spec) ** 2
    amp = np.sqrt(np.maximum(power, _EPS))
    mel = amp @ mel_filterbank(sr, fft_size, num_mels, 0.0, sr / 2)
    return np.log(np.maximum(mel, _EPS))


def mel_distance(a: np.ndarray, b: np.ndarray, sr: int,
                 fft_size: int = 2048, hop: int = 300,
                 num_mels: int = 80) -> float:
    """Mean L1 log-mel distance between two mono waveforms."""
    n = min(len(a), len(b))
    ma = log_mel(np.asarray(a)[:n], sr, fft_size, hop, num_mels)
    mb = log_mel(np.asarray(b)[:n], sr, fft_size, hop, num_mels)
    return float(np.mean(np.abs(ma - mb)))


def mcd_db(a: np.ndarray, b: np.ndarray, sr: int,
           fft_size: int = 2048, hop: int = 300,
           num_mels: int = 80, n_coef: int = 13) -> float:
    """Mel-cepstral distortion (dB) between two mono waveforms: the log-mel
    spectrogram, an orthonormal DCT-II over the mel axis, coefficients
    1..n_coef (c0 left out), then (10 sqrt(2) / ln 10) times the mean over
    frames of the L2 distance.  Identical signals score 0."""
    n = min(len(a), len(b))
    ma = log_mel(np.asarray(a)[:n], sr, fft_size, hop, num_mels).astype(
        np.float64)
    mb = log_mel(np.asarray(b)[:n], sr, fft_size, hop, num_mels).astype(
        np.float64)
    m_idx = np.arange(num_mels)
    k_idx = np.arange(1, n_coef + 1)
    dct = np.cos(np.pi * k_idx[:, None] * (m_idx[None, :] + 0.5)
                 / num_mels) * np.sqrt(2.0 / num_mels)
    ca, cb = ma @ dct.T, mb @ dct.T
    dist = np.sqrt(np.sum((ca - cb) ** 2, axis=-1))
    return float(10.0 * np.sqrt(2.0) / np.log(10.0) * np.mean(dist))
