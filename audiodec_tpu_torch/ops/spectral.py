"""Spectral ops: a torch.stft-compatible magnitude STFT and a slaney mel
filterbank (counterpart of audiodec_tpu/ops/spectral.py).

- STFT: center=True reflect-pads by n_fft // 2, after an optional constant
  zero `pad` (torchaudio.spectrogram's); periodic Hann window, zero-padded
  to n_fft when win_length < n_fft; onesided.
- Mel: librosa.filters.mel's defaults (slaney scale, slaney area
  normalization).

Signals are (B, T) tensors; the functions differentiate through
torch.autograd.  The window and the filterbank are built in numpy and kept
per device and dtype (`_window_on`, `_filterbank_on`), so a training step
copies nothing from the host.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int, dtype=np.float32) -> np.ndarray:
    """torch.hann_window (periodic=True)."""
    n = np.arange(win_length, dtype=np.float64)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))
    return w.astype(dtype)


def _padded_window(win_length: int, fft_size: int) -> np.ndarray:
    w = hann_window(win_length)
    if win_length < fft_size:
        left = (fft_size - win_length) // 2
        w = np.pad(w, (left, fft_size - win_length - left))
    return w


@lru_cache(maxsize=32)
def _window_on(win_length: int, fft_size: int, device: torch.device,
               dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(_padded_window(win_length, fft_size)).to(
        device, dtype)


def frame_signal(x: torch.Tensor, fft_size: int, hop_size: int,
                 center: bool = True, pad: int = 0) -> torch.Tensor:
    """x: (B, T) -> frames (B, n_frames, fft_size): constant zero `pad`
    first, then (center) reflect padding of fft_size // 2."""
    if pad:
        x = F.pad(x, (pad, pad))
    if center:
        half = fft_size // 2
        x = F.pad(x[:, None], (half, half), mode="reflect")[:, 0]
    return x.unfold(-1, fft_size, hop_size)


def stft_magnitude(x: torch.Tensor, fft_size: int, hop_size: int,
                   win_length: int, *, center: bool = True, pad: int = 0,
                   eps: float = 0.0) -> torch.Tensor:
    """|STFT| with torch.stft conventions.  x: (B, T) -> (B, n_frames, F).
    eps > 0 takes sqrt(clamp(power, min=eps)), as the reference losses."""
    window = _window_on(win_length, fft_size, x.device, x.dtype)
    frames = frame_signal(x, fft_size, hop_size, center=center, pad=pad)
    spec = torch.fft.rfft(frames * window, n=fft_size, dim=-1)
    power = torch.square(spec.real) + torch.square(spec.imag)
    if eps > 0.0:
        return torch.sqrt(torch.clamp(power, min=eps))
    return torch.sqrt(power)


@lru_cache(maxsize=32)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float,
                   fmax: float) -> np.ndarray:
    """Slaney-scale, slaney-normalized mel filterbank, (1 + n_fft // 2,
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


@lru_cache(maxsize=32)
def _filterbank_on(sr: int, n_fft: int, n_mels: int, fmin: float,
                   fmax: float, device: torch.device,
                   dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(mel_filterbank(sr, n_fft, n_mels, fmin,
                                           fmax)).to(device, dtype)


def mel_spectrogram(x: torch.Tensor, *, fs: int, fft_size: int,
                    hop_size: int, win_length: int | None = None,
                    num_mels: int = 80, fmin: float | None = 80,
                    fmax: float | None = 7600, eps: float = 1e-10,
                    log_base: float | None = 10.0) -> torch.Tensor:
    """Log-mel spectrogram of the reference's MelSpectrogram.
    x: (B, T) -> (B, n_frames, n_mels)."""
    win_length = win_length or fft_size
    fmin = 0.0 if fmin is None else fmin
    fmax = fs / 2.0 if fmax is None else fmax
    amp = stft_magnitude(x, fft_size, hop_size, win_length, eps=eps)
    fb = _filterbank_on(fs, fft_size, num_mels, fmin, fmax, amp.device,
                        amp.dtype)
    mel = torch.clamp(torch.matmul(amp, fb), min=eps)
    if log_base is None:
        return torch.log(mel)
    if log_base == 2.0:
        return torch.log2(mel)
    if log_base == 10.0:
        return torch.log10(mel)
    raise ValueError(f"log_base: {log_base} is not supported.")
