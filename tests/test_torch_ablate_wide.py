"""The port's ablation stack at every width and in bf16 storage, against
the JAX probe `tools/folded_ablate.py`'s `build`, unedited, in TPU
interpret mode, on the same numpy inputs (the bar and its reason:
tests/test_torch_folded_ablate.py).

The fold is f = max(1, 128 // C): C = 33 folds 3 samples per row (f*C =
99), C = 48 and 64 two, C = 96 one.  In bf16 storage the TPU statement
`v = v[o_span:, :] + y2.astype(v.dtype)` (`tools/folded_ablate.py:129`)
is computed as XLA computes it, the next unit's ELU reading the f32 sum
(`folded_stack.storage_residual`).  The CUDA kernel is held to the plain
version on the card by chip_smoke.py with the same bar.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from audiodec_tpu_torch.ops.kernels import ablate_stack as port
from tests.test_torch_folded_ablate import (
    DILATIONS,
    MAX_REL,
    RL2,
    _case,
    _port_units,
    _tool,
)

torch.set_num_threads(1)


def _check(c, t, variant, dtype):
    x, units = _case(1, t, c, seed=c)
    xj = jnp.asarray(x).astype(dtype)
    with pltpu.force_tpu_interpret_mode():
        ref = _tool().build(xj, tuple(
            (jnp.asarray(a), jnp.asarray(w)) for a, w in units), DILATIONS,
            ablate=variant)
    assert ref.dtype == xj.dtype
    ref = np.asarray(ref.astype(jnp.float32))
    xt = torch.from_numpy(x).transpose(1, 2).to(getattr(torch, dtype))
    out = port.ablate_stack(xt, _port_units(units), DILATIONS, variant)
    assert out.dtype == xt.dtype and out.shape == (1, c, t)
    out = out.float().transpose(1, 2).numpy()
    assert np.abs(ref - x).max() > 0.1   # the stack did change x
    rl2 = np.linalg.norm(out - ref) / np.linalg.norm(ref)
    err = np.abs(out - ref).max() / np.abs(ref).max()
    assert rl2 <= RL2 and err <= MAX_REL, (rl2, err)


# (C, T, storage): T a multiple of f, 192-384 samples
WIDTHS = [(48, 256, "float32"), (96, 192, "float32"), (33, 255, "float32"),
          (32, 256, "bfloat16"), (64, 256, "bfloat16")]


@pytest.mark.parametrize("variant", ["default", "noshift"])
@pytest.mark.parametrize("c,t,dtype", WIDTHS)
def test_variant_matches_jax_build(c, t, dtype, variant):
    _check(c, t, variant, dtype)


@pytest.mark.parametrize("variant", ["tree", "im2col", "noelu"])
def test_other_variants_at_c48(variant):
    _check(48, 256, variant, "float32")


@pytest.mark.parametrize("c", [48, 80])
def test_packed_weights_layout_and_padding(c):
    """The kernel's weights, [u][tap][c_out][c_in] zero-padded to the next
    multiple of 32, give the plain stack's result on the first C channels
    of a zero-padded input and keep the padded channels at zero (C = 80
    and its padding to 96 both fold f = 1; C = 48 pads to 64, f = 2)."""
    cp = port.padded_channels(c)
    _, units = _case(1, 8, c, seed=c)
    units = _port_units(units)
    w1, w2 = port.packed_weights(units, c)
    assert cp == 32 * -(-c // 32)
    assert w1.dtype == w2.dtype == torch.bfloat16
    assert w1.shape == (3, 7, cp, cp) and w2.shape == (3, cp, cp)
    assert not w1[:, :, c:].any() and not w1[:, :, :, c:].any()
    packed = [(a.float().permute(1, 2, 0), b.float()[:, :, None])
              for a, b in zip(w1, w2)]
    x = torch.from_numpy(_case(1, 96, c, seed=1)[0]).transpose(1, 2)
    xp = torch.nn.functional.pad(x, (0, 0, 0, cp - c))
    out = port.ablate_stack_plain(xp, packed, DILATIONS)
    if port.fold_factor(cp) == port.fold_factor(c):
        torch.testing.assert_close(out[:, :c],
                                   port.ablate_stack_plain(x, units,
                                                           DILATIONS),
                                   rtol=1e-6, atol=1e-6)
    assert not out[:, c:].any()


def test_packed_weights_are_cached_until_changed():
    _, units = _case(1, 8, 64, seed=3)
    units = _port_units(units)
    first = port.packed_weights(units, 64)
    assert all(a is b for a, b in zip(first, port.packed_weights(units, 64)))
    units[0][0].mul_(2.0)  # an in-place update must repack
    assert not torch.equal(port.packed_weights(units, 64)[0], first[0])


@pytest.mark.parametrize("dilation", [1, 3, 9])
@pytest.mark.parametrize("variant", port.VARIANTS)
def test_wide_geometry_fits_every_width(variant, dilation):
    """csrc/ablate_stack.cu's wide route takes every C from 33 to 1312 in
    every variant: the geometry's blocks fit a block's shared memory, its
    passes cover the channels, its warps and tiles stay within the
    variant's register sets, and its sum is `ablate_wide_smem`'s."""
    cap = port.WIDE_MTW.get(variant, port.WIDE_MTW_DEFAULT)
    for c in range(33, 1313):
        g = port.ablate_wide_geometry(c, variant, (1, dilation, dilation))
        groups = g.cp // port.WIDE_WARP_N
        assert g.cp == port.padded_channels(c)
        assert g.passes == -(-groups // g.warps_n)
        assert g.warps_m * g.warps_n <= port.wide_max_warps(variant, g.mtw)
        assert g.mtw in (1, 2, 4) and g.mtw <= cap
        assert g.rows == 16 * g.mtw * g.warps_m <= port.WIDE_MAX_ROWS
        assert g.cp % g.kc == 0 and g.kc % 16 == 0 and g.buffers in (2, 3)
        f = port.fold_factor(c)
        assert g.look == port.unit_look(dilation, f, variant) >= 6 * dilation
        assert g.smem == port.ablate_wide_smem(
            g.cp, g.rows + g.look, g.rows if g.passes > 1 else 0, g.warps_n,
            g.kc, g.buffers) <= port.BLOCK_SMEM


@pytest.mark.parametrize("c,variant,dil", [(1313, "default", (1, 3, 9)),
                                           (2048, "im2col", (1, 3, 9)),
                                           (256, "tree", (1, 3, 400)),
                                           (64, "noshift", (1, 3, 2000))])
def test_wide_geometry_raises_where_nothing_fits(c, variant, dil):
    with pytest.raises(ValueError, match=f"C={c}"):
        port.ablate_wide_geometry(c, variant, dil)


def test_wide_geometry_at_the_symad_stacks():
    """One pass over the channels at the symAD stacks' widths: in the
    default variant two m16 tiles a warp and 16 warps; noshift four tiles
    and 8 warps (its two register sets of four tiles); im2col four and up
    to 16 warps."""
    for c, rows in ((64, 256), (128, 128), (256, 64)):
        g = port.ablate_wide_geometry(c)
        assert (g.passes, g.mtw, g.rows) == (1, 2, rows)
        assert g.warps_m * g.warps_n == 16
        g = port.ablate_wide_geometry(c, "noshift")
        assert (g.passes, g.mtw, g.warps_m * g.warps_n) == (1, 4, 8)
        assert port.ablate_wide_geometry(c, "im2col").mtw == 4
