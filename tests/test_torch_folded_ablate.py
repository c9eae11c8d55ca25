"""The port's ablation stack against the JAX probe `tools/folded_ablate.py`.

On the CPU the port's wrapper runs its plain PyTorch version; JAX runs the
tool's `build`, unedited, in TPU interpret mode, on the same numpy inputs.
The CUDA kernel (csrc/ablate_stack.cu) is held to the plain version on the
card by chip_smoke.py with the same bar.

The bar is relative L2 <= 5e-4 and max |diff| <= 1e-2 of the output's
peak, not a tight max: the variants round their dot operands to bf16
(y1 = bf16(ELU(v)), a2 = bf16(ELU(acc))), and one ulp of an f32 sum or of
`exp` taken elsewhere (XLA's against PyTorch's, another order of the sums)
can move an intermediate across a bf16 rounding boundary, about 4e-3
relative, which the 1x1 conv carries on.  Such flips are spread over the
whole signal; at two TPU tiles (T = 8192) they gave a relative L2 of
8.3e-5 to 1.4e-4, a sixth to a third of the bar.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from audiodec_tpu.ops.pallas.folded_stack import (
    _fold_offsets,
    fold_1x1_weight as jax_fold_1x1,
    fold_conv_weight as jax_fold_conv,
)
from audiodec_tpu_torch.bin import folded_ablate
from audiodec_tpu_torch.ops.kernels import ablate_stack as port
from audiodec_tpu_torch.ops.kernels import fold

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
DILATIONS = (1, 3, 9)
RL2, MAX_REL = 5e-4, 1e-2


@functools.cache
def _tool():
    """tools/folded_ablate.py as a module.  It sets JAX's compilation cache
    options when imported; they are put back as they were."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    spec = importlib.util.spec_from_file_location(
        "folded_ablate_tool", ROOT / "tools" / "folded_ablate.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


def _case(b, t, c, seed=0):
    """The tool's recipe in numpy: weights 0.1 * N(0, 1) in JAX's (k, in,
    out) layout, x 0.3 * N(0, 1) as (B, T, C)."""
    rng = np.random.default_rng(seed)
    units = [(0.1 * rng.standard_normal((7, c, c)).astype(np.float32),
              0.1 * rng.standard_normal((1, c, c)).astype(np.float32))
             for _ in DILATIONS]
    x = (0.3 * rng.standard_normal((b, t, c))).astype(np.float32)
    return x, units


def _port_units(units):
    # JAX (k, in, out) -> torch (out, in, k)
    return [(torch.from_numpy(w1).permute(2, 1, 0),
             torch.from_numpy(w2).permute(2, 1, 0)) for w1, w2 in units]


def _check(b, t, c, variant):
    x, units = _case(b, t, c)
    with pltpu.force_tpu_interpret_mode():
        ref = _tool().build(jnp.asarray(x), tuple(
            (jnp.asarray(a), jnp.asarray(w)) for a, w in units), DILATIONS,
            ablate=variant)
    ref = np.asarray(ref)
    out = port.ablate_stack(torch.from_numpy(x).transpose(1, 2),
                            _port_units(units), DILATIONS, variant)
    assert out.dtype == torch.float32 and out.shape == (b, c, t)
    out = out.transpose(1, 2).numpy()
    assert np.abs(ref - x).max() > 0.1   # the stack did change x
    rl2 = np.linalg.norm(out - ref) / np.linalg.norm(ref)
    err = np.abs(out - ref).max() / np.abs(ref).max()
    assert rl2 <= RL2 and err <= MAX_REL, (rl2, err)


@pytest.mark.parametrize("variant", port.VARIANTS)
def test_variant_matches_jax_build(variant):
    _check(1, 256, 32, variant)


@pytest.mark.parametrize("variant", ["default", "noshift"])
def test_variant_at_two_tpu_tiles(variant):
    _check(1, 8192, 32, variant)


def test_noshift_at_c16():
    """C = 16 folds f = 8 samples per row, which moves noshift's reads."""
    _check(1, 256, 16, "noshift")


@pytest.mark.parametrize("k,d,f", [(7, 1, 4), (7, 3, 4), (7, 9, 4),
                                   (7, 9, 8), (7, 3, 32), (3, 5, 1)])
def test_fold_helpers_match_jax(k, d, f):
    c = 128 // f if f > 1 else 8
    w = np.random.default_rng(k + d + f).standard_normal(
        (k, c, c)).astype(np.float32)
    assert fold.fold_offsets(k, d, f) == _fold_offsets(k, d, f)
    np.testing.assert_array_equal(
        fold.fold_conv_weight(torch.from_numpy(w), d, f).numpy(),
        np.asarray(jax_fold_conv(jnp.asarray(w), d, f)))
    np.testing.assert_array_equal(
        fold.fold_1x1_weight(torch.from_numpy(w[:1]), f).numpy(),
        np.asarray(jax_fold_1x1(jnp.asarray(w[:1]), f)))


@pytest.mark.parametrize("shape,variant,exc", [
    ((1, 32, 258), "default", ValueError),     # T not a multiple of f = 4
    ((1, 16, 260), "noshift", ValueError),     # f = 8
    ((1, 48, 257), "default", ValueError),     # f = 2 at a wide C
    ((1, 32, 256), "shift", ValueError),       # unknown variant
])
def test_bad_calls_raise(shape, variant, exc):
    b, c, t = shape
    units = _port_units(_case(1, 8, c)[1])
    with pytest.raises(exc):
        port.ablate_stack(torch.zeros(b, c, t), units, DILATIONS, variant)


def test_bf16_storage_runs_and_returns_bf16():
    x, units = _case(1, 256, 32)
    xt = torch.from_numpy(x).transpose(1, 2).to(torch.bfloat16)
    out = port.ablate_stack(xt, _port_units(units))
    assert out.dtype == torch.bfloat16 and out.shape == xt.shape
    assert not torch.equal(out, xt)
    assert port.launches == 0


def test_other_devices_raise():
    units = _port_units(_case(1, 8, 32)[1])
    meta = [(a.to("meta"), b.to("meta")) for a, b in units]
    with pytest.raises(ValueError, match="no kernel"):
        port.ablate_stack(torch.zeros(1, 32, 256, device="meta"), meta)
    assert port.launches == 0


def test_probe_main_on_cpu():
    records = folded_ablate.main(["--device", "cpu", "--batch", "1",
                                  "--samples", "256"])
    assert [r["ablate"] for r in records] == [
        *port.VARIANTS, "torch_single_elu_pass", "folded_stack_bf16_dots"]
    assert all(r["device"] == "cpu" and r["ms"] > 0 and r["bound_ms"] > 0
               for r in records)
