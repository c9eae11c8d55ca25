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
