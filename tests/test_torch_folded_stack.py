"""The port's fused residual stack against the JAX folded kernel.

On the CPU the port's wrapper runs its plain PyTorch version; JAX runs its
Pallas kernel in interpret mode.  The same numpy inputs feed both.  The
CUDA kernel itself is held to the plain version on the card by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiodec_tpu.ops.pallas.folded_stack import (
    folded_residual_stack as jax_stack,
)
from audiodec_tpu_torch.ops.kernels import folded_stack as port

torch.set_num_threads(1)

DILATIONS = (1, 3, 9)


def _case(c, t, seed):
    rng = np.random.default_rng(seed)
    units = [(0.3 * rng.standard_normal((7, c, c)).astype(np.float32),
              0.3 * rng.standard_normal((1, c, c)).astype(np.float32))
             for _ in DILATIONS]
    x = rng.standard_normal((2, t, c)).astype(np.float32)
    return x, units


def _port_units(units):
    # JAX (K, I, O) -> torch (O, I, K)
    return [(torch.from_numpy(w1).permute(2, 1, 0),
             torch.from_numpy(w2).permute(2, 1, 0)) for w1, w2 in units]


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("bf16_dots", [True, False])
@pytest.mark.parametrize("c,t", [(8, 1920), (32, 1920), (8, 1799),
                                 (32, 1799), (8, 50), (32, 50)])
def test_plain_matches_jax_kernel(c, t, bf16_dots, storage):
    x, units = _case(c, t, seed=c + t)
    ref = jax_stack(jnp.asarray(x).astype(storage),
                    tuple((jnp.asarray(a), jnp.asarray(b)) for a, b in units),
                    dilations=DILATIONS, bf16_dots=bf16_dots,
                    interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    xt = torch.from_numpy(x).transpose(1, 2).to(getattr(torch, storage))
    out = port.folded_residual_stack(xt, _port_units(units),
                                     dilations=DILATIONS, bf16_dots=bf16_dots)
    assert out.dtype == xt.dtype and out.shape == xt.shape
    out = out.float().transpose(1, 2).numpy()
    scale = float(np.max(np.abs(ref)))
    if storage == "float32" and not bf16_dots:
        # true f32 on both sides: only the order of the sums differs
        # (tests/test_folded_stack.py:73-75)
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=5e-5 * scale)
    else:
        # bf16 operands or storage: bf16-class error
        # (tests/test_folded_stack.py:89)
        assert float(np.max(np.abs(out - ref))) / scale < 0.03


@pytest.mark.parametrize("kwargs", [
    {"act": "leaky_relu", "act_param": 0.1},
    {"biases": ((torch.zeros(8), torch.zeros(8)),) * 3},
    {"kernel_size2": 7},
    {"int8_dots": True},
])
def test_off_path_modes_raise(kwargs):
    x, units = _case(8, 64, seed=0)
    with pytest.raises(NotImplementedError):
        port.folded_residual_stack(torch.from_numpy(x).transpose(1, 2),
                                   _port_units(units), **kwargs)


def test_cpu_call_launches_no_kernel():
    x, units = _case(8, 64, seed=1)
    before = port.launches
    port.folded_residual_stack(torch.from_numpy(x).transpose(1, 2),
                               _port_units(units))
    assert port.launches == before == 0


def test_bad_shapes_raise():
    x, units = _case(8, 64, seed=2)
    with pytest.raises(ValueError):
        port.folded_residual_stack(torch.from_numpy(x).transpose(1, 2),
                                   _port_units(units)[:2])
    with pytest.raises(ValueError):
        port.folded_residual_stack(torch.from_numpy(x)[:, :, :4]
                                   .transpose(1, 2), _port_units(units))


@pytest.mark.parametrize("rounded", [True, False])
@pytest.mark.parametrize("c", [4, 12])
def test_packed_weights_layout_and_padding(c, rounded):
    """The kernel's weights, [u][k][i][o] zero-padded to the next built
    width, give the plain stack's result on the first C channels of a
    zero-padded input and keep the padded channels at exactly zero."""
    cp = next(p for p in port.PADDED_CHANNELS if c <= p)
    x, units = _case(c, 200, seed=c)
    units = _port_units(units)
    w1, w2 = port._pack_weights(units, c, cp, rounded)
    assert w1.shape == (3, 7, cp, cp) and w2.shape == (3, cp, cp)
    packed = [(a.permute(2, 1, 0), b.t()[:, :, None]) for a, b in zip(w1, w2)]
    xt = torch.from_numpy(x).transpose(1, 2)
    xp = torch.nn.functional.pad(xt, (0, 0, 0, cp - c))
    out = port.folded_residual_stack_plain(xp, packed, DILATIONS, rounded)
    ref = port.folded_residual_stack_plain(xt, units, DILATIONS, rounded)
    torch.testing.assert_close(out[:, :c], ref, rtol=1e-6, atol=1e-6)
    assert not out[:, c:].any()


def test_packed_weights_are_cached_until_changed():
    _, units = _case(8, 64, seed=3)
    units = _port_units(units)
    first = port._packed_weights(units, 8, 8, True)
    again = port._packed_weights(units, 8, 8, True)
    assert all(a is b for a, b in zip(first, again))
    assert port._packed_weights(units, 8, 8, False)[0] is not first[0]
    units[0][0].mul_(2.0)  # an in-place update must repack
    changed = port._packed_weights(units, 8, 8, True)
    assert not torch.equal(changed[0], first[0])
