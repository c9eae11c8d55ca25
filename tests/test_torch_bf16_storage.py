"""The folded stack's bf16 storage against the JAX folded kernel.

The TPU kernel's residual statement `v = v + y2.astype(v.dtype)`
(`audiodec_tpu/ops/pallas/folded_stack.py:367`) is followed by the next
unit's activation (`:344`).  XLA keeps that bf16 sum's excess precision
for the activation and rounds it only where the residual is stored, so the
port's plain version does the same (`folded_stack.storage_residual`) in
every mode.  A port that rounds the sum before the next activation is
about 3e-3 off in relative L2 (61-69% of the outputs bit-equal); with the
rule it is within 1e-3 (99.4-99.8% bit-equal): what remains are bf16
operand flips after reordered f32 sums.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from audiodec_tpu.ops.pallas.folded_stack import (
    folded_residual_stack as jax_stack,
)
from audiodec_tpu_torch.ops.activations import elu_exp
from audiodec_tpu_torch.ops.kernels import folded_stack as port
from tests.test_torch_folded_stack import (
    DILATIONS,
    VOC_DILATIONS,
    _case,
    _port_biases,
    _port_units,
    _voc_case,
)

torch.set_num_threads(1)

RL2 = 1e-3


def _jax_units(units):
    return tuple((jnp.asarray(a), jnp.asarray(b)) for a, b in units)


def _rel_l2(out, ref):
    out = out.float().transpose(1, 2).numpy()
    return float(np.linalg.norm(out - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("c,t", [(32, 1920), (8, 1799)])
def test_autoencoder_mode_matches_jax_in_bf16_storage(c, t):
    x, units = _case(c, t, seed=c + t)
    ref = jax_stack(jnp.asarray(x).astype("bfloat16"), _jax_units(units),
                    dilations=DILATIONS, interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    xt = torch.from_numpy(x).transpose(1, 2).to(torch.bfloat16)
    out = port.folded_residual_stack(xt, _port_units(units),
                                     dilations=DILATIONS)
    assert out.dtype == torch.bfloat16
    assert _rel_l2(out, ref) <= RL2


def test_vocoder_mode_matches_jax_in_bf16_storage():
    k, c, t = 11, 32, 1920
    x, units, biases = _voc_case(c, t, k, True, seed=k + c + t)
    ref = jax_stack(
        jnp.asarray(x).astype("bfloat16"), _jax_units(units),
        dilations=VOC_DILATIONS, kernel_size=k, kernel_size2=k,
        act="leaky_relu", act_param=0.1, biases=_jax_units(biases),
        interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    xt = torch.from_numpy(x).transpose(1, 2).to(torch.bfloat16)
    out = port.folded_residual_stack(
        xt, _port_units(units), dilations=VOC_DILATIONS, kernel_size=k,
        kernel_size2=k, act="leaky_relu", act_param=0.1,
        biases=_port_biases(biases))
    assert out.dtype == torch.bfloat16
    assert _rel_l2(out, ref) <= RL2


def test_residual_keeps_the_f32_sum():
    """bf16(v) + bf16(y2) in f32, not rounded: 1 + 2^-9 is no bf16 value
    (bf16 steps by 2^-7 at 1), and the residual keeps it."""
    v = torch.tensor([1.0, 3.0])
    y = torch.tensor([2.0 ** -9, 1.0 + 2.0 ** -12])
    s = port.storage_residual(v, y, True)
    assert s.tolist() == [1.0 + 2.0 ** -9, 4.0]
    assert port.storage_residual(v, y, False).tolist() == \
        [1.0 + 2.0 ** -9, 4.0 + 2.0 ** -12]


def _unit(v, w1, w2, d):
    """One autoencoder unit by hand on the f32 sum v, bf16 operands:
    returns the next f32 sum bf16(v) + bf16(y2)."""
    r = lambda t: t.to(torch.bfloat16).float()
    a = r(elu_exp(v))
    acc = F.conv1d(F.pad(a, (6 * d, 0)), r(w1), dilation=d)
    y2 = F.conv1d(r(elu_exp(acc)), r(w2))
    return r(v) + r(y2)


def test_next_unit_reads_the_f32_sum():
    """Two units in bf16 storage: the second unit's activation reads the
    first unit's f32 sum; rounding that sum to bf16 first gives another
    output."""
    x, units = _case(4, 96, seed=5)
    units = _port_units(units)[:2]
    xt = torch.from_numpy(x).transpose(1, 2).to(torch.bfloat16)
    out = port.folded_residual_stack_plain(xt, units, (1, 3))
    s = _unit(xt.float(), *units[0], 1)
    assert torch.equal(out, _unit(s, *units[1], 3).to(torch.bfloat16))
    rounded = _unit(s.to(torch.bfloat16).float(), *units[1], 3)
    assert not torch.equal(out, rounded.to(torch.bfloat16))
