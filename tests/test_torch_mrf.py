"""The AD v0 receiver (the causal HiFiGAN with MultiReceptiveField blocks)
in the port against the benchmark's plain reference
(benchmark/reference/mrf.py) on seeded random weights at small widths, the
benchmark's frozen arithmetic of it (benchmark/arith/mrf.py) against the
port's FLOP count, the `mrf` spans, and B1's vocoder-mode launch counter by
kernel size.  The CPU only; no JAX.  The CUDA kernel at these unit shapes is
held to its plain version on the card by
benchmark/tests/test_bench_mrf_card.py."""

import contextlib
import dataclasses
import json
import os
import sys
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from audiodec_tpu_torch.models import fast, vocoder
from audiodec_tpu_torch.models.vocoder import VocoderConfig
from audiodec_tpu_torch.ops.kernels import folded_stack
from audiodec_tpu_torch.utils import bridge, profiling
from audiodec_tpu_torch.utils.config import generator_config
from audiodec_tpu_torch.utils import flops as port_flops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.arith import bounds, mrf as arith  # noqa: E402
from benchmark.harness import weights as W  # noqa: E402
from benchmark.reference import layout as L  # noqa: E402
from benchmark.reference import mrf as M  # noqa: E402

torch.set_num_threads(1)

CONFIGS = os.path.join(ROOT, "benchmark", "configs")
V0 = json.load(open(os.path.join(
    CONFIGS, "AudioDec_v0_symAD_vctk_48000_hop300.json")))
V1 = json.load(open(os.path.join(
    CONFIGS, "AudioDec_v1_symAD_vctk_48000_hop300.json")))
# the v0 vocoder at small widths: the stages at 16 / 8 / 4 / 2 channels
SMALL = dict(V0, generator_params=dict(V0["generator_params"],
                                       in_channels=8, channels=32))
SPANS = ("mrf", "mrf_k3", "mrf_k7", "mrf_k11")


def _state(cfg, seed=7):
    """(reference-layout state dict, the port's params and config)."""
    sd = W.state_dict(M.mrf_layout(cfg["generator_params"]), cfg["init"],
                      seed, "vocoder", "cpu")
    vcfg = generator_config(cfg)
    return sd, bridge.vocoder_params_from_reference_sd(W.to_numpy(sd),
                                                       vcfg), vcfg


def _codes(seed=3, frames=6):
    return 0.5 * torch.randn(2, frames, 8,
                             generator=torch.Generator().manual_seed(seed))


def test_config_is_mrf():
    vcfg = generator_config(V0)
    assert isinstance(vcfg, VocoderConfig) and not vcfg.grouped
    assert vcfg.resblock_kernel_sizes == (3, 7, 11)
    assert {r.key for r in M.mrf_layout(V0["generator_params"])} >= {
        "blocks.3.blocks.2.convs2.2.conv.weight_v", "mean", "scale"}


@pytest.mark.parametrize("route", ["plain", "folded"])
def test_decode_matches_reference(route):
    """vocoder_apply (the plain route) and vocoder_apply_folded with f32
    dots (the kernel route's structure through fusion_bct; on the CPU the
    kernel wrapper runs its plain version) against vocode_mrf."""
    sd, params, vcfg = _state(SMALL)
    zq = _codes()
    if route == "plain":
        y = vocoder.vocoder_apply(params, zq, vcfg)
    else:
        y = fast.vocoder_apply_folded(params, zq, vcfg, bf16_dots=False)
    ref = M.vocode_mrf(zq.transpose(1, 2), M.fold_weight_norm(sd),
                       SMALL["generator_params"])
    assert y.shape == (2, 6 * 300, 1)
    torch.testing.assert_close(y.transpose(1, 2), ref, rtol=1e-5, atol=1e-6)


def test_reference_tells_the_branches_apart():
    """Without its k = 3 branch the vocoder gives another waveform, by far
    more than the port's rounding against the reference (1e-5): a dropped
    branch cannot pass for the whole block."""
    sd, params, vcfg = _state(SMALL)
    zq = _codes()
    y = vocoder.vocoder_apply(params, zq, vcfg).transpose(1, 2)
    two = dataclasses.replace(vcfg, resblock_kernel_sizes=(7, 11),
                              resblock_dilations=vcfg.resblock_dilations[1:])
    p2 = dict(params, blocks=[{"blocks": b["blocks"][1:]}
                              for b in params["blocks"]])
    y2 = vocoder.vocoder_apply(p2, zq, two).transpose(1, 2)
    assert float((y2 - y).norm() / y.norm()) > 1e-2


def test_flops_match_the_port():
    """The frozen MRF arithmetic against utils/flops.py at the cell's
    shapes, and the B1 bounds of the k = 3 / 7 / 11 stacks."""
    n = 480000 // 300
    frozen = arith.mrf_vocoder_flops(V0["generator_params"], n)
    assert sum(frozen.values()) == port_flops.vocoder_flops(
        generator_config(V0), n)
    assert round(16 * sum(frozen.values()) / 1e12, 2) == 9.69
    assert round(16 * sum(v for k, v in frozen.items()
                          if k.startswith("mrf")) / 1e12, 2) == 9.38
    assert arith.kernel_stages(V0["generator_params"], n, 32) == [
        (3, 32, 480000)]
    ms = [arith.mrf_stack_bound_s(V0["generator_params"], 16, 32, 480000, k,
                                  bounds.BF16) * 1e3 for k in (3, 7, 11)]
    assert ms == pytest.approx([0.293, 0.668, 1.050], abs=5e-4)


def _spans(params, cfg, apply):
    """The port's spans of one decode under a CPU profiler: the count of
    each in the profiler's events, and the tally (started afresh)."""
    with profiling.span("untraced"):     # no profiler: the tally goes stale
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        apply(params, _codes(), cfg)
    names = [e.name[len(profiling.PREFIX):] for e in prof.events()
             if e.name.startswith(profiling.PREFIX)]
    return {n: names.count(n) for n in names}, profiling.span_totals()


@pytest.mark.parametrize("apply", [vocoder.vocoder_apply,
                                   fast.vocoder_apply_folded],
                         ids=["plain", "folded"])
def test_mrf_spans(apply):
    """Each MultiReceptiveField block (one per upsampling stage) runs
    under `mrf`, each resblock under `mrf_k<k>`; a grouped vocoder (AD v1)
    has none of them, and without a profiler nothing is tallied."""
    _, params, vcfg = _state(SMALL)
    events, tot = _spans(params, vcfg, apply)
    assert events == dict.fromkeys(SPANS, 4)
    assert {s: tot[s]["count"] for s in SPANS} == dict.fromkeys(SPANS, 4)
    assert tot["mrf"]["host_ms"] >= sum(tot[s]["host_ms"]
                                        for s in SPANS[1:])
    v1 = dict(V1, generator_params=dict(V1["generator_params"],
                                        in_channels=8, channels=32))
    sd1 = W.state_dict(L.vocoder_layout(v1["generator_params"]),
                       v1["init"], 7, "vocoder", "cpu")
    vcfg1 = generator_config(v1)
    p1 = bridge.vocoder_params_from_reference_sd(W.to_numpy(sd1), vcfg1)
    assert _spans(p1, vcfg1, apply)[0] == {}
    before = profiling.span_totals()
    apply(params, _codes(), vcfg)
    assert profiling.span_totals() == before


def test_voc_launches_by_k(monkeypatch):
    """B1's vocoder mode counted by kernel size: one MRF block at C = 32
    through the kernel route launches once per resblock, each under its
    k, with the launch itself stubbed (the CPU has no kernel); the total
    counter moves as before."""
    calls = []

    def launch(*args):
        calls.append(args[10:12])    # kernel_size, kernel_size2
        return 0

    monkeypatch.setattr(folded_stack, "_mma_kernel", lambda: launch)
    monkeypatch.setattr(folded_stack, "_sm_count", lambda index: 132)
    monkeypatch.setattr(folded_stack, "mma_voc_launches_by_k", {})
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))

    def via_kernel(x, units, *, dilations, kernel_size, kernel_size2, act,
                   act_param, biases, bf16_dots):
        mode = folded_stack._mode(kernel_size, kernel_size2, act, biases,
                                  False)
        return folded_stack._mma_stack(x, units, dilations, kernel_size,
                                       kernel_size2, act, act_param, biases,
                                       mode)

    monkeypatch.setattr(fast, "folded_residual_stack", via_kernel)
    cfg = generator_config(SMALL)
    gen = torch.Generator().manual_seed(1)
    before = folded_stack.mma_voc_launches
    x = torch.randn(1, 32, 64, generator=gen)
    block = {"blocks": [
        {name: [{"w": 0.01 * torch.randn(32, 32, k, generator=gen),
                 "b": torch.zeros(32)} for _ in range(3)]
         for name in ("convs1", "convs2")} for k in (3, 7, 11)]}
    fast._voc_fusion_auto(block, x, cfg)
    assert folded_stack.mma_voc_launches_by_k == {3: 1, 7: 1, 11: 1}
    assert folded_stack.mma_voc_launches == before + 3
    assert calls == [(3, 3), (7, 7), (11, 11)]
