"""Multi-resolution STFT loss: spectral convergence plus log-magnitude L1
(counterpart of audiodec_tpu/losses/stft.py; ref: losses/stft_loss.py)."""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from audiodec_tpu_torch.losses.mel import _rows
from audiodec_tpu_torch.ops.spectral import stft_magnitude


@dataclasses.dataclass(frozen=True)
class MultiResolutionSTFTLoss:
    fft_sizes: Sequence[int] = (1024, 2048, 512)
    hop_sizes: Sequence[int] = (120, 240, 50)
    win_lengths: Sequence[int] = (600, 1200, 240)

    def __call__(self, y_hat, y) -> Tuple[torch.Tensor, torch.Tensor]:
        """y_hat, y: (B, T, C) -> (sc_loss, mag_loss)."""
        xh, xr = _rows(y_hat), _rows(y)
        sc, mag = 0.0, 0.0
        for fft, hop, win in zip(self.fft_sizes, self.hop_sizes,
                                 self.win_lengths):
            mh = stft_magnitude(xh, fft, hop, win, eps=1e-7)
            mr = stft_magnitude(xr, fft, hop, win, eps=1e-7)
            sc = sc + (torch.linalg.vector_norm(mr - mh)
                       / torch.linalg.vector_norm(mr))
            mag = mag + torch.mean(torch.abs(torch.log(mr) - torch.log(mh)))
        n = len(self.fft_sizes)
        return sc / n, mag / n
