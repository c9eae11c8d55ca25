"""BENCHMARK.json against the files it names: every cell resolves to a
configuration, a traffic mix and a driver, every per-layer metric to a
reader that moves the metric it says, and the names and limits keep the
benchmark's format."""

from __future__ import annotations

import json
import re

import pytest

from conftest import ROOT

BENCH = ROOT / "benchmark"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w["name"] for w in SPEC["workloads"]]
    names += [c["name"] for c in SPEC["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("wl", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(wl):
    from benchmark.run import cell
    assert len(wl["why"]) <= 200 and "\n" not in wl["why"]
    spec_wl, cfg, traffic, driver = cell(wl["name"])
    assert {k: spec_wl[k] for k in wl} == wl, "the cell file agrees"
    assert cfg["name"] == wl["config"]
    for fn in ("setup", "window", "release", "check"):
        assert callable(getattr(driver, fn))
    e2e = [m for m in SPEC["end_to_end"]
           if wl["name"] in m.get("workloads", [wl["name"]])]
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    layer = [m for m in SPEC["per_layer"]
             if wl["name"] in m.get("workloads", [wl["name"]])]
    assert layer
    e2e_names = {m["name"] for m in e2e}
    assert all(m["moves"] in e2e_names for m in layer)
    assert spec_wl["limits"] and all(0 < v < 1 for v in
                                     spec_wl["limits"].values())


@pytest.mark.parametrize("m", SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_reader(m):
    from benchmark.run import reader
    mod = reader(m["name"])
    # a reader shared by a quantity's `<quantity>.<kind>` metrics names no
    # MOVES: each of them moves its cells' own (test_cell_resolves)
    own = (BENCH / "metrics" / f"{m['name']}.py").exists()
    assert mod.MOVES == (m["moves"] if own else None)
    assert callable(mod.read)
    if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
        assert m["name"].endswith("_roofline") or "mfu" in m["name"]


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(c):
    cfg = json.loads((ROOT / c["file"]).read_text())
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"] == []
    assert c["file"].startswith("benchmark/configs/")
