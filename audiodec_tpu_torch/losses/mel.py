"""Multi-resolution log-mel L1 loss (counterpart of
audiodec_tpu/losses/mel.py; ref: losses/mel_loss.py:97-155)."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from audiodec_tpu_torch.ops.spectral import mel_spectrogram


def _rows(y: torch.Tensor) -> torch.Tensor:
    """(B, T, C) waveforms -> (B * C, T) rows, channel-major per item."""
    return y.transpose(1, 2).reshape(-1, y.shape[1])


@dataclasses.dataclass(frozen=True)
class MultiMelSpectrogramLoss:
    fs: int = 22050
    fft_sizes: Sequence[int] = (1024, 2048, 512)
    hop_sizes: Sequence[int] = (120, 240, 50)
    win_lengths: Sequence[int] = (600, 1200, 240)
    num_mels: int = 80
    fmin: float | None = 80
    fmax: float | None = 7600
    log_base: float | None = 10.0

    def __call__(self, y_hat: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """y_hat, y: (B, T, C) waveforms -> scalar L1 log-mel loss."""
        yh, yr = _rows(y_hat), _rows(y)
        loss = 0.0
        for fft, hop, win in zip(self.fft_sizes, self.hop_sizes,
                                 self.win_lengths):
            kw = dict(fs=self.fs, fft_size=fft, hop_size=hop, win_length=win,
                      num_mels=self.num_mels, fmin=self.fmin, fmax=self.fmax,
                      log_base=self.log_base)
            loss = loss + torch.mean(torch.abs(mel_spectrogram(yh, **kw)
                                               - mel_spectrogram(yr, **kw)))
        return loss / len(self.fft_sizes)


def from_config(fs: int, params: dict) -> MultiMelSpectrogramLoss:
    """From a config's mel_loss_params block."""
    return MultiMelSpectrogramLoss(
        fs=params.get("fs", fs),
        fft_sizes=tuple(params.get("fft_sizes", (1024, 2048, 512))),
        hop_sizes=tuple(params.get("hop_sizes", (120, 240, 50))),
        win_lengths=tuple(params.get("win_lengths", (600, 1200, 240))),
        num_mels=params.get("num_mels", 80),
        fmin=params.get("fmin", 80),
        fmax=params.get("fmax", 7600),
        log_base=params.get("log_base", 10.0),
    )
