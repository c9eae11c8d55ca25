"""Profiling helpers: a torch.profiler trace around a block, and named
wall-clock scopes (counterpart of audiodec_tpu/utils/profiling.py:
`device_trace`, `Timers`).

JAX's `enable_compile_cache` (its persistent compile cache and the
`jax_platforms` override) has no counterpart: the port compiles nothing
per shape, and its kernels are built once per source (ops/kernels/_build.py).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import numpy as np
import torch


@contextlib.contextmanager
def device_trace(outdir: Optional[str], device=None):
    """Trace the block with torch.profiler and write a Chrome trace
    (`trace-<pid>-<ms>.json`, readable in Perfetto or chrome://tracing)
    into `outdir`; nothing when outdir is None.  CPU activity always, CUDA
    activity on a CUDA device (default: when CUDA is available)."""
    if not outdir:
        yield
        return
    cuda = (torch.cuda.is_available() if device is None
            else torch.device(device).type == "cuda")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(outdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        outdir, f"trace-{os.getpid()}-{int(time.time() * 1000)}.json"))


class Timers:
    """Named wall-clock accumulators, with the mean and std of each as the
    reference streamer prints them at exit."""

    def __init__(self):
        self._records: Dict[str, list] = {}

    @contextlib.contextmanager
    def scope(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._records.setdefault(name, []).append(
                time.perf_counter() - t0)

    def summary(self) -> Dict[str, dict]:
        return {
            k: {"mean_ms": float(np.mean(v) * 1000),
                "std_ms": float(np.std(v) * 1000),
                "count": len(v)}
            for k, v in self._records.items()
        }
