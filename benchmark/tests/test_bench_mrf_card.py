"""On the card: B1's vocoder mode (csrc/folded_stack_mma.cu) at the AD v0
cell's k = k2 = 3 and 7 resblocks, (16, 32, 480000) with bf16 storage and
biases, against its plain version and its exact-sum form at chip_smoke.py's
tolerances (a relative L2 within the larger of 5e-4 and 1.5 times the
plain version's own distance from exact sums; a largest error under 1e-2
of the peak), each call one launch counted under its k; and the new cell's
checks: the program within its limits and the control past one of them,
on three seeds.  Run with `python -m pytest benchmark/tests -m card -s`
(`-s` prints each kernel call's ms)."""

from __future__ import annotations

import pytest
import torch

from benchmark import controls
from benchmark.harness.context import load_json
from conftest import ROOT

CONTROLS = {"ad_v0.transcode.b16x10s": ["fp8_vocode"]}
SEEDS = [2 ** 31 + 201, 2 ** 31 + 202, 2 ** 31 + 203]
MMA_RL2, FLOOR_FACTOR, BF16_REL = 5e-4, 1.5, 1e-2


def _sq(a, b=None) -> float:
    a = a.double() if b is None else a.double() - b.double()
    return float((a * a).sum())


@pytest.mark.card
@pytest.mark.parametrize("k", [3, 7])
def test_voc_kernel_vs_plain(k, card):
    from audiodec_tpu_torch.ops.kernels import folded_stack as fs
    gen = torch.Generator(device=card).manual_seed(4100 + k)
    c, dil = 32, (1, 3, 5)
    units = tuple((torch.randn(c, c, k, generator=gen, device=card)
                   .div((k * c) ** 0.5).bfloat16(),
                   torch.randn(c, c, k, generator=gen, device=card)
                   .div((k * c) ** 0.5).bfloat16()) for _ in dil)
    biases = tuple((0.5 * torch.randn(c, generator=gen, device=card)
                    .bfloat16(),
                    0.5 * torch.randn(c, generator=gen, device=card)
                    .bfloat16()) for _ in dil)
    kw = dict(dilations=dil, kernel_size=k, kernel_size2=k,
              act="leaky_relu", act_param=0.1, biases=biases)
    x = torch.randn(16, c, 480000, generator=gen, device=card).bfloat16()
    before = dict(fs.mma_voc_launches_by_k)
    out = fs.folded_residual_stack(x, units, **kw)
    torch.cuda.synchronize()
    assert fs.mma_voc_launches_by_k[k] == before.get(k, 0) + 1
    assert not fs.mma_geometry(c, k, k, dil).wgmma
    plain = {e: fs.folded_residual_stack_plain(
        x, units, dil, True, act="leaky_relu", act_param=0.1,
        biases=biases, exact_sums=e) for e in (False, True)}
    ref, exact = plain[False], plain[True]
    o = out.float()
    assert torch.isfinite(o).all() and not torch.equal(o, x.float())
    rl2 = (_sq(out, ref) / _sq(ref)) ** 0.5
    exact_rl2 = (_sq(out, exact) / _sq(exact)) ** 0.5
    bar = max(MMA_RL2, FLOOR_FACTOR * (_sq(ref, exact) / _sq(exact)) ** 0.5)
    err, peak = float((o - ref.float()).abs().max()), float(
        ref.float().abs().max())
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(5):
        fs.folded_residual_stack(x, units, **kw)
    ev[1].record()
    torch.cuda.synchronize()
    print(f"vocoder k={k} (16, 32, 480000) bf16: "
          f"{ev[0].elapsed_time(ev[1]) / 5:.3f} ms a call, rel L2 "
          f"{rl2:.3g} / exact {exact_rl2:.3g} (bar {bar:.3g}), max "
          f"{err / peak:.3g} of the peak, {torch.cuda.get_device_name()}")
    assert max(rl2, exact_rl2) <= bar and err < BF16_REL * peak


def _limits(cell):
    return load_json(ROOT / "benchmark" / "workloads" / f"{cell}.json"
                     )["limits"]


@pytest.mark.card
@pytest.mark.parametrize("cell", list(CONTROLS))
def test_program_passes(cell, card):
    lim = _limits(cell)
    for rec in controls.readings(cell, "program", SEEDS, 1.0, card):
        over = {k: v for k, v in rec["readings"].items()
                if not v <= lim[k]}
        assert not over, (rec["seed"], over)


@pytest.mark.card
@pytest.mark.parametrize("cell,variant", [(c, v) for c, vs in
                                          CONTROLS.items() for v in vs])
def test_control_fails(cell, variant, card):
    lim = _limits(cell)
    for rec in controls.readings(cell, variant, SEEDS, 1.0, card):
        assert any(not rec["readings"][k] <= lim[k] for k in lim), rec
