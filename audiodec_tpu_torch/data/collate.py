"""Batch collater: random fixed-length crops (counterpart of
audiodec_tpu/data/collate.py `CollaterAudio`; ref dataloader/collater.py).

Batches are (B, T, C) float32 numpy arrays; with the same seed the crops
are the JAX package's, draw for draw.
"""

from __future__ import annotations

from typing import List

import numpy as np


class CollaterAudio:
    """Random crop to batch_length; clips not longer than batch_length are
    dropped (ref: dataloader/collater.py:18-60)."""

    def __init__(self, batch_length: int, seed: int = 0):
        self.batch_length = batch_length
        self.rng = np.random.default_rng(seed)

    def __call__(self, batch: List[np.ndarray]) -> np.ndarray:
        batch = [b for b in batch if len(b) > self.batch_length]
        if not batch:
            return np.zeros((0, self.batch_length, 1), np.float32)
        xs = []
        for b in batch:
            start = int(self.rng.integers(0, len(b) - self.batch_length))
            xs.append(b[start:start + self.batch_length])
        return np.stack(xs).astype(np.float32)
