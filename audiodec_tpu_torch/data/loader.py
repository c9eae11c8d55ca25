"""Threaded prefetching data loader (counterpart of
audiodec_tpu/data/loader.py; ref codecTrain.py:68-86 num_workers).

Worker threads read and collate batches while the training step runs; the
batches come out in order.  The collater's random crops are drawn in batch
order whatever the number of threads (each thread reads its batch, then
waits for its turn to collate), so the same seeds give the same batches for
any `num_workers`: the JAX package's batches with one thread (its threads
draw in whichever order they run), and the same global batch on every rank
of a data-parallel run.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np

_PREFETCH = 4  # collated batches waiting for the training step


class DataLoader:
    def __init__(self, dataset, collate_fn: Callable, batch_size: int,
                 shuffle: bool = True, num_workers: int = 2, seed: int = 0):
        self.dataset = dataset
        self.collate_fn = collate_fn
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        """Whole batches per epoch: a ragged last batch is dropped."""
        return len(self.dataset) // self.batch_size

    def _epoch_indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        return idx

    def __iter__(self) -> Iterator:
        """One pass over the dataset with threaded prefetch."""
        idx = self._epoch_indices()
        batches = [idx[i:i + self.batch_size]
                   for i in range(0, len(self) * self.batch_size,
                                  self.batch_size)]
        work: queue.Queue = queue.Queue()
        out: queue.Queue = queue.Queue(maxsize=_PREFETCH)
        for i, b in enumerate(batches):
            work.put((i, b))
        turn = [0]
        turns = threading.Condition()

        def worker():
            while True:
                try:
                    i, b = work.get_nowait()
                except queue.Empty:
                    return
                items = [self.dataset[int(j)] for j in b]
                with turns:
                    turns.wait_for(lambda: turn[0] == i)
                    batch = self.collate_fn(items)
                    turn[0] += 1
                    turns.notify_all()
                out.put((i, batch))

        for _ in range(self.num_workers):
            threading.Thread(target=worker, daemon=True).start()
        results, next_i = {}, 0
        for _ in range(len(batches)):
            i, batch = out.get()
            results[i] = batch
            while next_i in results:
                yield results.pop(next_i)
                next_i += 1

    def infinite(self) -> Iterator:
        """Endless epoch-cycling iterator (step-driven training)."""
        while True:
            yield from self
