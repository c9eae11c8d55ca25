"""Batch collaters: random fixed-length crops (counterpart of
audiodec_tpu/data/collate.py `CollaterAudio`, `CollaterAudioPair`; ref
dataloader/collater.py).

Batches are (B, T, C) float32 numpy arrays; with the same seed the crops
are the JAX package's, draw for draw.
"""

from __future__ import annotations

from typing import List, Tuple

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


class CollaterAudioPair:
    """One crop offset per (noisy, clean) pair, applied to both; pairs of
    unequal lengths or not longer than batch_length are dropped (ref:
    dataloader/collater.py:63-87) -> (noisy, clean) batches."""

    def __init__(self, batch_length: int, seed: int = 0):
        self.batch_length = batch_length
        self.rng = np.random.default_rng(seed)

    def __call__(self, batch) -> Tuple[np.ndarray, np.ndarray]:
        bl = self.batch_length
        batch = [b for b in batch if len(b[0]) > bl and len(b[0]) == len(b[1])]
        if not batch:
            z = np.zeros((0, bl, 1), np.float32)
            return z, z
        noisy, clean = [], []
        for n, c in batch:
            start = int(self.rng.integers(0, len(c) - bl))
            noisy.append(n[start:start + bl])
            clean.append(c[start:start + bl])
        return (np.stack(noisy).astype(np.float32),
                np.stack(clean).astype(np.float32))
