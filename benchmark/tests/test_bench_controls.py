"""On the card, at each cell's own sizes: the program's checks pass their
limits, and each control (benchmark/controls.py) fails one of them, on
three seeds."""

from __future__ import annotations

import pytest

from benchmark import controls
from benchmark.harness.context import load_json
from conftest import ROOT

CONTROLS = {
    "symad.transcode.b16x10s": ["cli:--dtype bfloat16", "fp8_decode"],
    "ad_v1.transcode.b16x10s": ["cli:--dtype bfloat16", "fp8_decode"],
    "symad.train_adv.b16x9600": ["tf32_reference", "fault:half_batch",
                                 "fault:state_unchanged"],
}
SEEDS = [2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103]


def _limits(cell):
    return load_json(ROOT / "benchmark" / "workloads" / f"{cell}.json"
                     )["limits"]


@pytest.mark.card
@pytest.mark.parametrize("cell", list(CONTROLS))
def test_program_passes(cell, card):
    lim = _limits(cell)
    for rec in controls.readings(cell, "program", SEEDS, 1.0, card):
        assert all(rec["readings"][k] <= lim[k] for k in lim), rec


@pytest.mark.card
@pytest.mark.parametrize("cell,variant", [(c, v) for c, vs in
                                          CONTROLS.items() for v in vs])
def test_control_fails(cell, variant, card):
    lim = _limits(cell)
    for rec in controls.readings(cell, variant, SEEDS, 1.0, card):
        assert any(not rec["readings"][k] <= lim[k] for k in lim), rec
