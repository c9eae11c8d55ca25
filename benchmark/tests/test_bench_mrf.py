"""The cell `ad_v0.transcode.b16x10s` on the CPU at CPU-test widths: its
files resolve and its readers load; a sound run is correct and a traced
one reads the MRF span; the MRF readers read nothing in the cells that
came before it; and a run with the timed path broken underneath comes out
not correct, once for each fault: an altered index, a vocoder that sums
its three resblocks without the mean or drops the k = 3 one."""

from __future__ import annotations

import dataclasses
import types

import pytest
import torch

from benchmark import run
from benchmark.harness.context import load_json
from conftest import DATA, ROOT

V0 = "ad_v0.transcode.b16x10s"
SEED = 2 ** 31 + 13


def _run(traced=False):
    sym = load_json(DATA / "tiny_symad.json")
    configs = {"symAD_vctk_48000_hop300": sym, "tiny_symad": sym,
               "AudioDec_v0_symAD_vctk_48000_hop300":
                   load_json(DATA / "tiny_ad_v0.json")}
    overrides = {"config": configs["AudioDec_v0_symAD_vctk_48000_hop300"],
                 "configs": configs.__getitem__,
                 "traffic": load_json(DATA / "tiny_transcode.json")}
    return run.run_cell(V0, SEED, 0.5, traced, torch.device("cpu"),
                        overrides=overrides)


def test_files_resolve():
    wl, cfg, traffic, mod = run.cell(V0)
    assert traffic["driver"] == "transcode_mrf"
    assert mod.__name__.endswith("transcode_mrf")
    assert cfg["name"] == wl["config"] and cfg["reduced"] == []
    for m in run.listed("per_layer", V0):
        assert callable(run.reader(m["name"]).read)
    vp = cfg["generator_params"]
    assert (vp["resblock_kernel_sizes"], vp["groups"]) == ([3, 7, 11], 1)
    assert traffic["params"] == load_json(
        ROOT / "benchmark" / "traffic" / "transcode.b16x10s.json")["params"]


def test_sound_run_is_correct():
    out = _run()
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


def test_traced_v0_reads_the_mrf_span():
    out = _run(traced=True)
    assert out["correct"], out["checks"]
    assert out["metrics"]["vocoder.mrf_ms"]["value"] > 0
    assert out["metrics"]["transcode_mrf_mfu"]["value"] > 0
    # the CPU launches no kernel: nothing to read
    assert "mrf_stack_roofline" not in out["metrics"]


def _altered(enc):
    def encode(self, x):
        idx = enc(self, x).clone()
        idx[0, 0, 0] = (idx[0, 0, 0] + 1) % 16
        return idx
    return encode


def _fusion_fault(fusion, fault):
    """fusion_bct with a MultiReceptiveField fault: the resblocks summed
    without the mean, or the k = 3 one left out of it."""
    def faulty(p, x, cfg, resblock):
        if cfg.grouped:
            return fusion(p, x, cfg, resblock)
        if fault == "sum":
            return fusion(p, x, cfg, resblock) * len(
                cfg.resblock_kernel_sizes)
        keep = [i for i, k in enumerate(cfg.resblock_kernel_sizes) if k != 3]
        cut = dataclasses.replace(
            cfg, resblock_kernel_sizes=tuple(
                cfg.resblock_kernel_sizes[i] for i in keep),
            resblock_dilations=tuple(cfg.resblock_dilations[i]
                                     for i in keep))
        return fusion({"blocks": [p["blocks"][i] for i in keep]}, x, cut,
                      resblock)
    return faulty


@pytest.mark.parametrize("fault", ["altered_index", "sum", "drop_k3"])
def test_v0_fault_is_caught(fault, monkeypatch):
    from audiodec_tpu_torch.bin.codec_test import BatchTranscoder
    from audiodec_tpu_torch.models import fast, vocoder
    if fault == "altered_index":
        monkeypatch.setattr(BatchTranscoder, "encode",
                            _altered(BatchTranscoder.encode))
    else:
        faulty = _fusion_fault(vocoder.fusion_bct, fault)
        monkeypatch.setattr(vocoder, "fusion_bct", faulty)
        monkeypatch.setattr(fast, "fusion_bct", faulty)
    out = _run()
    assert not out["correct"], out["checks"]


# a vocoder-mode B1 launch as AD v1's k = 11 resblocks name it in a trace
V1_LAUNCH = ("void stack_kernel<32, 0, 11, 11, 1>(...)", 0.0, 2000.0)


@pytest.mark.parametrize("cell", ["symad.transcode.b16x10s",
                                  "ad_v1.transcode.b16x10s",
                                  "symad.train_adv.b16x9600"])
def test_mrf_readers_read_nothing_in_the_other_cells(cell, tiny,
                                                      monkeypatch):
    seen = {}
    reader = run.reader

    def spy(name):
        mod = reader(name)

        def read(ctx):
            seen["ctx"] = ctx
            return mod.read(ctx)
        return types.SimpleNamespace(read=read)

    monkeypatch.setattr(run, "reader", spy)
    out = run.run_cell(cell, SEED, 0.5, True, torch.device("cpu"),
                       overrides=tiny(cell))
    assert out["correct"], out["checks"]
    ctx = seen["ctx"]
    assert reader("vocoder.mrf_ms").read(ctx) is None
    # even with a vocoder-mode launch in the trace: these cells' drivers
    # count no launches by kernel size
    ctx.trace = types.SimpleNamespace(steps=1,
                                      kernels_named=lambda _: [V1_LAUNCH])
    assert reader("mrf_stack_roofline").read(ctx) is None
