"""The port's folded-stack probe (bin/folded_probe.py, counterpart of
tools/folded_probe.py) on the CPU at tiny shapes: its records, the tool's
grid of folds and tiles, its chain against the tool's XLA stack, and the
launch counts chip_smoke.py expects of it on the card."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodec_tpu.models.autoencoder import _res_unit_apply
from audiodec_tpu_torch.bin import folded_probe
from audiodec_tpu_torch.ops.kernels import folded_stack

torch.set_num_threads(1)

KEYS = {"C", "T", "dtype", "fold", "tile_rows", "chain_ms", "folded_ms",
        "speedup", "rel_max_err", "bound_ms", "batch", "device"}
INT8_KEYS = {"int8_ms", "int8_rel_err", "int8_speedup_vs_chain", "int8t_ms",
             "int8t_rel_err", "int8t_speedup_vs_chain"}


def test_main_with_int8_on_cpu():
    records = folded_probe.main(["--device", "cpu", "--int8", "--batch", "1",
                                 "--shapes", "32:960,64:320"])
    assert [(r["C"], r["fold"], r["tile_rows"]) for r in records] == [
        (32, 4, 1024), (32, 8, 1024), (32, 16, 512),
        (64, 2, 1024), (64, 4, 1024), (64, 8, 512)]
    for r in records:
        assert set(r) == KEYS | INT8_KEYS
        assert r["device"] == "cpu" and r["dtype"] == "float32"
        assert set(r["bound_ms"]) == {"folded", "int8", "int8t"}
        # bf16 operands: bf16-class; int8 codes: a few % of the peak
        assert 0 < r["rel_max_err"] < 0.02
        assert 0 < r["int8_rel_err"] < 0.1 and 0 < r["int8t_rel_err"] < 0.1
        assert all(math.isfinite(r[k]) and r[k] > 0 for k in
                   ("chain_ms", "folded_ms", "int8_ms", "int8t_ms"))
    assert folded_stack.int8_tile_launches == folded_stack.mma_launches == 0


def test_main_bf16_without_int8():
    records = folded_probe.main(["--device", "cpu", "--dtype", "bfloat16",
                                 "--batch", "1", "--shapes", "128:160"])
    assert [r["fold"] for r in records] == [1, 2, 4]
    for r in records:
        assert set(r) == KEYS and set(r["bound_ms"]) == {"folded"}
        assert r["dtype"] == "bfloat16" and 0 < r["rel_max_err"] < 0.03


def test_folds_and_tiles_follow_the_tool():
    """The tool's folds (f * C = 128, 256, 512, at least 1, dividing T) and
    tile_rows (1024, 512, 256 by f * C) at the symAD shapes."""
    assert [folded_probe.folds(c, t) for c, t in folded_probe.SHAPES] == [
        [4, 8, 16], [2, 4, 8], [1, 2, 4], [1, 2]]
    assert folded_probe.folds(32, 1002) == []
    assert [folded_probe.tile_rows(f, c) for f, c in
            ((4, 32), (8, 32), (16, 32), (8, 64), (4, 128), (2, 256),
             (8, 128))] == [1024, 1024, 512, 512, 512, 512, 256]


def test_chain_is_the_tools_xla_stack():
    """The probe's chain against the tool's `xla_stack` (JAX
    `_res_unit_apply`, causal, jax.nn.elu) on the probe's inputs, f32."""
    units, x = folded_probe.probe_inputs(32, 96, 2, torch.float32, "cpu")
    v = jnp.asarray(x.transpose(1, 2).numpy())
    for (w1, w2), d in zip(units, folded_probe.DILATIONS):
        p = {"conv1": {"w": jnp.asarray(w1.permute(2, 1, 0).numpy())},
             "conv2": {"w": jnp.asarray(w2.permute(2, 1, 0).numpy())}}
        v = _res_unit_apply(p, v, dilation=d, act=jax.nn.elu, mode="causal")
    out = folded_probe.chain(x, units).transpose(1, 2).numpy()
    np.testing.assert_allclose(out, np.asarray(v), rtol=1e-5,
                               atol=1e-5 * float(np.abs(v).max()))


@pytest.mark.parametrize("shapes,want", [
    (folded_probe.SHAPES, {"mma": 60, "wide": 160, "int8": 220,
                           "int8_tile": 220}),
    (((32, 960),), {"mma": 60, "int8": 60, "int8_tile": 60})])
def test_chip_smoke_expects_the_probes_launches(shapes, want):
    """chip_smoke.py's count for one --int8 run of main: per (C, fold) and
    mode 2 + 3 x 6 wrapper calls, C = 32 in csrc/folded_stack_mma.cu
    (bf16 dots) and wider in csrc/resunit_stack.cu."""
    import chip_smoke

    got = chip_smoke.probe_launches(shapes)
    assert {k: n for k, n in got.items() if n} == want
