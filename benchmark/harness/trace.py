"""The traced run's reductions: torch.profiler over a few steps run after
the measured window (the same calls on the same program), kept in memory
and reduced to kernel intervals, the benchmark's own spans and the numbers
the per-layer readers and the `breakdown` take.

Device busy time is the union of the kernels' intervals (a copy of
chip_smoke.py's `device_busy_ms`); an idle gap is a stretch of the traced
window in which no kernel ran, named by the innermost of the benchmark's
spans (`record_function("bench/<name>")`) that covers its middle on the
host's timeline ("step" where only the step's own span does), else by the
CUDA call the host was in ("cudaStreamSynchronize", ...), or "host" where
none was.

A tracer records the host's operators too (`host=True`, the spans and the
window they bound), or the device alone (`host=False`): where a step
launches hundreds of small kernels, recording every operator on the host
slows the host's launch path enough to open gaps on the device that an
untraced step does not have.  Without the host the device is drained as
the traced steps start and end, and the window runs from the first traced
kernel's start to the last one's end.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function, \
    schedule

PREFIX = "bench/"


def span(name: str, on: bool):
    """A span of the benchmark's own around a call into a layer; nothing
    where the run is not traced."""
    return record_function(PREFIX + name) if on else contextlib.nullcontext()


def _is_kernel(e) -> bool:
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))


def union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


@dataclass
class Trace:
    """Times in microseconds on the profiler's clock."""
    kernels: List[Tuple[str, float, float]]
    spans: List[Tuple[str, float, float]]
    start: float
    end: float
    steps: int
    calls: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def clipped(self) -> List[Tuple[str, float, float]]:
        return [(n, max(a, self.start), min(b, self.end))
                for n, a, b in self.kernels if b > self.start
                and a < self.end]

    def busy_s(self) -> float:
        return union_us((a, b) for _, a, b in self.clipped()) / 1e6

    def kernels_named(self, pattern) -> List[Tuple[str, float, float]]:
        return [k for k in self.clipped() if pattern.search(k[0])]

    def top_ops(self, n: int = 10) -> list:
        by: Dict[str, float] = {}
        for name, a, b in self.clipped():
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return sorted(([k[:120], v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        merged: List[List[float]] = []
        for a, b in sorted((a, b) for _, a, b in self.clipped()):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        edges = [self.start] + [x for ab in merged for x in ab] + [self.end]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self.host_at((a + b) / 2), (b - a) / 1e6]
                for a, b in gaps[:n]]

    def host_at(self, t: float) -> str:
        for named in (self.spans, self.calls):
            inner: Optional[Tuple[str, float, float]] = None
            for s in named:
                if s[1] <= t <= s[2] and (
                        inner is None or s[2] - s[1] < inner[2] - inner[1]):
                    inner = s
            if inner:
                return inner[0]
        return "host"


class Tracer:
    """torch.profiler over `active` steps after `wait` steps and one
    warm-up step (the tracer misses launches at the start of the window it
    has just opened).  Call `step()` after each step.  host=False: the
    device's activity alone, drained at the traced steps' two ends."""

    def __init__(self, wait: int, active: int, host: bool = True):
        host = host or not torch.cuda.is_available()    # the CPU tests
        self.wait, self.active, self.host, self.n = wait, active, host, 0
        activities = [ProfilerActivity.CUDA]
        if host:
            activities.insert(0, ProfilerActivity.CPU)
        self.prof = profile(
            activities=activities,
            schedule=schedule(wait=wait, warmup=1, active=active, repeat=1))

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)

    def step(self):
        self.n += 1
        if not self.host and self.n in (self.wait + 1,
                                        self.wait + 1 + self.active):
            torch.cuda.synchronize()
        self.prof.step()

    def reduce(self) -> Optional[Trace]:
        """The trace, or None where no step was traced whole."""
        try:
            events = self.prof.events()
        except (AssertionError, RuntimeError):
            return None
        if not events:
            return None
        kernels, spans, calls = [], [], []
        for e in events:
            at = (e.time_range.start, e.time_range.end)
            if _is_kernel(e):
                kernels.append((e.name, *at))
            elif e.name.startswith(PREFIX):
                spans.append((e.name[len(PREFIX):], *at))
            elif e.name.startswith("cuda"):
                calls.append((e.name, *at))
        if not kernels:
            return None
        if not self.host:
            return Trace(kernels, spans, min(k[1] for k in kernels),
                         max(k[2] for k in kernels), self.active, calls)
        # a step's span can come more than once (a training step's reads
        # ten), so the steps are the schedule's, and the spans bound them
        steps = [s for s in spans if s[0] == "step"]
        if len(steps) < self.active:
            return None
        return Trace(kernels, spans, min(s[1] for s in steps),
                     max(s[2] for s in steps), self.active, calls)
