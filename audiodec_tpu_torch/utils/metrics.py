"""Waveform quality metrics for codec evaluation, on numpy arrays
(counterpart of audiodec_tpu/utils/metrics.py: `snr_db`, `mel_distance`,
`mcd_db`).

The log-mel front end is ops/spectral.py `mel_spectrogram` as the JAX
package's metrics call it: fmin 0, fmax sr / 2, natural log.
"""

from __future__ import annotations

import numpy as np
import torch

from audiodec_tpu_torch.ops.spectral import mel_spectrogram


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


def log_mel(x: np.ndarray, sr: int, fft_size: int = 2048, hop: int = 300,
            num_mels: int = 80) -> np.ndarray:
    """Natural-log mel spectrogram of a mono waveform (T,) -> (T', M):
    ops/spectral.py mel_spectrogram on the CPU in float32."""
    x = torch.from_numpy(np.ascontiguousarray(x, np.float32).ravel())
    with torch.no_grad():
        mel = mel_spectrogram(x[None], fs=sr, fft_size=fft_size,
                              hop_size=hop, num_mels=num_mels, fmin=0,
                              fmax=sr / 2, log_base=None)
    return mel[0].numpy()


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
