"""The port's archived fused residual stack against the JAX Pallas kernel
`audiodec_tpu/archive/resunit_kernel.py fused_residual_stack`.

On the CPU the port's wrapper runs its plain PyTorch version; JAX runs its
kernel in interpret mode, at tests/test_pallas_resunit.py's cases and at
other conv widths and unit counts.  The CUDA kernel (csrc/resunit_stack.cu)
is held to the plain version on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiodec_tpu.archive.resunit_kernel import (
    fused_residual_stack as jax_stack,
    res_stack_params as jax_res_stack_params,
)
from audiodec_tpu.models.autoencoder import _res_unit_init
from audiodec_tpu_torch.archive import resunit_kernel as port
from audiodec_tpu_torch.utils.bridge import unit_params_from_jax

torch.set_num_threads(1)

DILATIONS = (1, 3, 9)


def _units(c, k=7, n=3):
    """tests/test_pallas_resunit.py's units (k = 7, three units): JAX init,
    weights x10."""
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    units = [_res_unit_init(keys[i], c, k) for i in range(n)]
    units = jax.tree_util.tree_map(lambda w: np.asarray(w * 10.0), units)
    return jax_res_stack_params({"res": units})


@pytest.mark.parametrize("c,t,tile", [(8, 256, 128), (16, 300, 100),
                                      (8, 100, 1024)])
def test_plain_matches_jax_kernel(c, t, tile):
    units = _units(c)
    x = np.random.default_rng(0).standard_normal((2, t, c)).astype(np.float32)
    ref = np.asarray(jax_stack(jnp.asarray(x), tuple(
        (jnp.asarray(a), jnp.asarray(b)) for a, b in units),
        dilations=DILATIONS, tile_t=tile, interpret=True))
    out = port.fused_residual_stack(torch.from_numpy(x),
                                    unit_params_from_jax(units),
                                    dilations=DILATIONS, tile_t=tile)
    assert out.dtype == torch.float32 and out.shape == x.shape
    # true f32 on both sides: only the order of the sums differs
    # (tests/test_pallas_resunit.py)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("k,dilations", [(3, DILATIONS), (5, DILATIONS),
                                         (7, (1, 3, 9, 27))])
def test_plain_matches_jax_kernel_at_unit_shapes(k, dilations):
    """Other conv widths and four units, which csrc/resunit_stack.cu takes on
    the card: true f32, rtol 1e-4 and atol 5e-5 of the peak."""
    c, t = 8, 300
    units = _units(c, k, len(dilations))
    x = np.random.default_rng(k).standard_normal((2, t, c)) \
        .astype(np.float32)
    ref = np.asarray(jax_stack(jnp.asarray(x), tuple(
        (jnp.asarray(a), jnp.asarray(b)) for a, b in units),
        dilations=dilations, kernel_size=k, tile_t=100, interpret=True))
    out = port.fused_residual_stack(torch.from_numpy(x),
                                    unit_params_from_jax(units),
                                    dilations=dilations, kernel_size=k)
    assert out.dtype == torch.float32 and out.shape == x.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4,
                               atol=5e-5 * float(np.abs(ref).max()))


def test_bct_entry_equals_public_entry():
    units = unit_params_from_jax(_units(8))
    x = torch.from_numpy(np.random.default_rng(1)
                         .standard_normal((2, 200, 8)).astype(np.float32))
    out = port.fused_residual_stack(x, units)
    out_bct = port.fused_residual_stack_bct(x.transpose(1, 2).contiguous(),
                                            units)
    assert torch.equal(out, out_bct.transpose(1, 2))
    # tile_t changes nothing
    assert torch.equal(out, port.fused_residual_stack(x, units, tile_t=7))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
def test_non_f32_input_raises(dtype):
    units = unit_params_from_jax(_units(8))
    x = torch.zeros(1, 8, 50, dtype=dtype)
    with pytest.raises(TypeError, match="float32"):
        port.fused_residual_stack_bct(x, units)


def test_no_kernel_off_cuda_and_cpu():
    """A tensor that is on neither the CPU nor a CUDA device has no kernel
    and no plain fallback."""
    units = unit_params_from_jax(_units(8))
    x = torch.zeros(1, 8, 50, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        port.fused_residual_stack_bct(x, units)
    assert port.launches == 0
