"""The readers of the port's own spans (`program_span` metrics,
harness/spans.py): a traced run at CPU-test widths reads a positive number
for each of them in the cells BENCHMARK.json lists it for and nothing in
the others, the result line carries them, and an untraced run leaves the
port's tally empty."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from benchmark import run
from conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
SPANS = [m for m in SPEC["per_layer"] if m["source"] == "program_span"]
SEED = 2 ** 31 + 29

UNTRACED = r"""
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import torch
torch.set_num_threads(1)
from conftest import tiny_overrides
from benchmark import run
from audiodec_tpu_torch.utils.profiling import span_totals
for cell in ("symad.transcode.b16x10s", "symad.train_adv.b16x9600"):
    run.run_cell(cell, 5, 0.3, False, torch.device("cpu"),
                 overrides=tiny_overrides(cell))
print(json.dumps(span_totals()))
"""


def test_six_span_metrics_are_declared():
    assert len(SPANS) == 6
    assert all(m["workloads"] for m in SPANS)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_span_metrics_read_in_their_cells(cell, tiny):
    out = run.run_cell(cell, SEED, 0.5, True, torch.device("cpu"),
                       overrides=tiny(cell))
    assert out["correct"], out["checks"]
    for m in SPANS:
        value = run.reader(m["name"]).read(None)
        if cell in m["workloads"]:
            assert value is not None and value > 0, m["name"]
            assert out["metrics"][m["name"]]["value"] == value
        else:
            assert value is None, m["name"]
            assert m["name"] not in out["metrics"]


def test_untraced_run_leaves_the_tally_empty():
    proc = subprocess.run(
        [sys.executable, "-c", UNTRACED.format(
            root=str(ROOT), tests=str(ROOT / "benchmark" / "tests"))],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {}
