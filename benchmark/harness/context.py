"""What one run of a cell carries from its set-up through its window to its
check, and the small statistics the drivers and readers share."""

from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

BENCH = Path(__file__).resolve().parents[1]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def config(name: str) -> dict:
    return load_json(BENCH / "configs" / f"{name}.json")


def percentile(values, q: float) -> float:
    """The q-th percentile by linear interpolation between order
    statistics (numpy's default)."""
    v = sorted(values)
    if not v:
        return math.nan
    at = q / 100 * (len(v) - 1)
    lo = math.floor(at)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (at - lo)


@dataclass
class Check:
    """One number compared, beside its limit: correct when value <= limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit    # NaN is never ok


@dataclass
class Context:
    workload: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    traced: bool
    device: Any
    configs: Any = config          # name -> configuration dict
    variant: str = "program"       # or a control (benchmark/controls.py)
    # filled by the driver
    e2e: Dict[str, float] = field(default_factory=dict)
    attempted: int = 0
    counters: Dict[str, float] = field(default_factory=dict)
    timings: Dict[str, List[float]] = field(default_factory=dict)
    trace: Optional[Any] = None    # harness/trace.py Trace
    window_s: float = 0.0
    state: Dict[str, Any] = field(default_factory=dict)
    setup_phases: Dict[str, float] = field(default_factory=dict)
    _mark: float = field(default_factory=time.perf_counter)

    def setup_marks(self, phase: str):
        """Seconds since the last mark, under `phase` (set-up's split)."""
        now = time.perf_counter()
        self.setup_phases[phase] = now - self._mark
        self._mark = now

    @property
    def params(self) -> dict:
        return self.traffic["params"]

    def limits(self) -> Dict[str, float]:
        return self.workload["limits"]

    def checks(self, readings: Dict[str, float]) -> List[Check]:
        lim = self.limits()
        return [Check(k, float(v), float(lim[k])) for k, v in
                readings.items()]


def summary(checks: List[Check]) -> Tuple[bool, Dict[str, dict]]:
    return (all(c.ok for c in checks),
            {c.name: {"value": c.value, "limit": c.limit} for c in checks})
