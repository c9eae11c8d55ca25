"""Waveform envelope (shape) loss (counterpart of
audiodec_tpu/losses/waveform.py; ref: losses/waveform_loss.py:15-75)."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F


def _maxpool1d(x: torch.Tensor, winlen: int) -> torch.Tensor:
    """torch MaxPool1d(winlen) over time: kernel = stride = winlen, no
    padding.  x: (B, T, C) -> (B, T // winlen, C)."""
    return F.max_pool1d(x.transpose(1, 2), winlen).transpose(1, 2)


@dataclasses.dataclass(frozen=True)
class MultiWindowShapeLoss:
    winlen: Sequence[int] = (300, 200, 100)

    def __call__(self, y_hat: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """y_hat, y: (B, T, C)."""
        loss = 0.0
        for wl in self.winlen:
            ys = _maxpool1d(torch.abs(y), wl)
            ysh = _maxpool1d(torch.abs(y_hat), wl)
            loss = loss + torch.mean(torch.abs(ysh - ys))
        return loss / len(self.winlen)
