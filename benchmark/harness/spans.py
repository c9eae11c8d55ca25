"""The port's own spans (audiodec_tpu_torch/utils/profiling.py `span`) as
the per-layer readers take them: the tally of the traced steps, which are
the last the program's spans ran under a profiler in a run (the window's
spans run untraced, so the tally starts afresh with the traced steps).  A
program without the tally, or a cell without the span, reads nothing."""

from __future__ import annotations

from typing import Dict, Iterable, Optional


def totals() -> Dict[str, dict]:
    """{span: {"count", "host_ms", "device_ms"}}, or {} where the program
    keeps no tally."""
    from audiodec_tpu_torch.utils import profiling
    read = getattr(profiling, "span_totals", None)
    return read() if read else {}


def device_ms_per_span(name: str) -> Optional[float]:
    """Device ms of one `name` span, on average."""
    row = totals().get(name)
    return row["device_ms"] / row["count"] if row and row["count"] else None


def host_ms_per_step(names: Iterable[str],
                     step: str = "adv_step") -> Optional[float]:
    """Host ms of the `names` spans together per `step` span."""
    tot = totals()
    names = list(names)
    if not all(tot.get(n, {}).get("count") for n in names + [step]):
        return None
    return sum(tot[n]["host_ms"] for n in names) / tot[step]["count"]
