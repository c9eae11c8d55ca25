"""Profiling: the port's spans, and a torch.profiler trace around a block
(counterpart of audiodec_tpu/utils/profiling.py: `device_trace`; `span`
takes the place of JAX's `Timers`).

A span names a stretch of the program's work: `with span("encoder",
device): ...`.  Tracing is on while a torch profiler records, and only
then; there is no other switch.  Off, a span is one check of the
profiler's own flag and a shared no-op context.  On, it opens
`record_function("audiodec/<name>")`, so that spans nest in the
profiler's trace on the kernels' clock, and it adds the span's host time
(`time.perf_counter`) and its device time to a process-wide tally by name.
On a CUDA device the device time is that between two CUDA events recorded
on the current stream as the span opens and closes, read as the events
complete (`Event.query`), so that no span waits for the device; on the CPU
it is the host time.

The tally holds the spans of the latest unbroken stretch of tracing: a
span that opens with tracing on after one ran with it off starts it
afresh.  `span_totals()` reads it, waiting for the device time of the
spans still in flight.

JAX's `enable_compile_cache` (its persistent compile cache and the
`jax_platforms` override) has no counterpart: the port compiles nothing
per shape, and its kernels are built once per source (ops/kernels/_build.py).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import Dict, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

PREFIX = "audiodec/"


class _Tally:
    """Per span name [count, host ms, device ms], the CUDA event pairs
    whose device time is still to be read, and a pool of free events."""

    def __init__(self):
        self.totals: Dict[str, list] = {}
        self.pending: deque = deque()
        self.free: list = []
        self.stale = True       # a span ran with tracing off since

    def restart(self):
        self.totals.clear()
        while self.pending:
            _, a, b = self.pending.popleft()
            self.free += (a, b)
        self.stale = False

    def event(self) -> torch.cuda.Event:
        return (self.free.pop() if self.free
                else torch.cuda.Event(enable_timing=True))

    def resolve(self, wait: bool = False):
        """Adds the device time of the completed event pairs, oldest
        first; with wait, of every pair."""
        while self.pending:
            name, a, b = self.pending[0]
            if wait:
                b.synchronize()
            elif not b.query():
                return
            self.pending.popleft()
            self.totals[name][2] += a.elapsed_time(b)
            self.free += (a, b)


_TALLY = _Tally()
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "stream", "scope", "t0", "start")

    def __init__(self, name: str, device):
        self.name = name
        self.stream = (torch.cuda.current_stream(device)
                       if device is not None
                       and torch.device(device).type == "cuda" else None)

    def __enter__(self):
        if _TALLY.stale:
            _TALLY.restart()
        self.scope = _autograd_profiler.record_function(PREFIX + self.name)
        self.scope.__enter__()
        if self.stream is not None:
            self.start = _TALLY.event()
            self.start.record(self.stream)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        host_ms = (time.perf_counter() - self.t0) * 1e3
        row = _TALLY.totals.setdefault(self.name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += host_ms
        if self.stream is None:
            row[2] += host_ms
        else:
            end = _TALLY.event()
            end.record(self.stream)
            _TALLY.pending.append((self.name, self.start, end))
            _TALLY.resolve()
        self.scope.__exit__(*exc)
        return False


def span(name: str, device=None):
    """A context that times the block as span `name` while a torch profiler
    records (device: where the block's work runs; None is the host)."""
    if _autograd_profiler._is_profiler_enabled:
        return _Span(name, device)
    _TALLY.stale = True
    return _OFF


def span_totals() -> Dict[str, dict]:
    """{name: {"count", "host_ms", "device_ms"}} of the latest stretch of
    tracing; waits for the device time of the spans still in flight."""
    _TALLY.resolve(wait=True)
    return {k: {"count": c, "host_ms": h, "device_ms": d}
            for k, (c, h, d) in _TALLY.totals.items()}


@contextlib.contextmanager
def device_trace(outdir: Optional[str], device=None):
    """Trace the block with torch.profiler and write a Chrome trace
    (`trace-<pid>-<ms>.json`, readable in Perfetto or chrome://tracing)
    into `outdir`; nothing when outdir is None.  CPU activity always, CUDA
    activity on a CUDA device (default: when CUDA is available).  The
    port's spans show in it as `audiodec/<name>`."""
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
