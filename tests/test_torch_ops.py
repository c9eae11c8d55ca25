"""The port's ops against the JAX package's: causal convs, activations, RVQ.

The port's convs take its (B, C, T) layout and torch's weight orientation;
the test feeds both packages the same numpy arrays and transposes at the
call.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiodec_tpu.ops import activations as jax_act
from audiodec_tpu.ops import conv as jax_conv
from audiodec_tpu.ops import vq as jax_vq
from audiodec_tpu_torch.ops import activations, conv, vq

torch.set_num_threads(1)


def _bct(x):
    return torch.from_numpy(x).transpose(1, 2)


@pytest.mark.parametrize("k,stride,dilation,bias", [
    (7, 1, 1, False), (7, 1, 9, False), (6, 3, 1, True), (10, 5, 1, True),
    (3, 1, 1, False)])
def test_causal_conv1d_matches_jax(k, stride, dilation, bias):
    rng = np.random.default_rng(k + stride + dilation)
    x = rng.standard_normal((2, 300, 6)).astype(np.float32)
    w = rng.standard_normal((k, 6, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    jp = {"w": jnp.asarray(w)}
    pp = {"w": torch.from_numpy(w).permute(2, 1, 0)}
    if bias:
        jp["b"], pp["b"] = jnp.asarray(b), torch.from_numpy(b)
    ref = np.asarray(jax_conv.causal_conv1d(jnp.asarray(x), jp, stride=stride,
                                            dilation=dilation))
    out = conv.causal_conv1d(_bct(x), pp, stride=stride, dilation=dilation)
    np.testing.assert_allclose(out.transpose(1, 2).numpy(), ref, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("k,stride", [(10, 5), (8, 4), (6, 3), (4, 4)])
def test_causal_conv_transpose1d_matches_jax(k, stride):
    # k > stride: ceil(k/s)-1 = 1 frame of replication padding;
    # k == stride: none
    rng = np.random.default_rng(k * stride)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    x[:, 0] += 3.0  # a first frame unlike zeros shows the replication pad
    w = rng.standard_normal((k, 6, 5)).astype(np.float32)  # gathering (K,I,O)
    b = rng.standard_normal(5).astype(np.float32)
    ref = np.asarray(jax_conv.causal_conv_transpose1d(
        jnp.asarray(x), {"w": jnp.asarray(w), "b": jnp.asarray(b)},
        stride=stride))
    # torch (I, O, K) with the K axis flipped
    wt = torch.from_numpy(np.ascontiguousarray(
        np.transpose(w[::-1], (1, 2, 0))))
    out = conv.causal_conv_transpose1d(
        _bct(x), {"w": wt, "b": torch.from_numpy(b)}, stride=stride)
    assert out.is_contiguous()
    np.testing.assert_allclose(out.transpose(1, 2).numpy(), ref, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name,params", [
    ("ELU", None), ("ELU", {"alpha": 0.5}),
    ("LeakyReLU", {"negative_slope": 0.1}), ("LeakyReLU", None)])
def test_activations_match_jax(name, params):
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    ref = np.asarray(jax_act.get_activation(name, params)(jnp.asarray(x)))
    out = activations.get_activation(name, params)(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-7)


def test_vq_nearest_planted_tie_picks_lowest_index():
    rng = np.random.default_rng(0)
    embed = rng.standard_normal((16, 4)).astype(np.float32)
    embed[11] = embed[5]  # two equal codes: distances tie exactly
    z = embed[[5, 11, 2]] + 0.0
    idx = vq.vq_nearest(torch.from_numpy(z), torch.from_numpy(embed))
    assert idx.dtype == torch.int32
    assert idx.tolist() == [5, 5, 2]
    ref = jax_vq.vq_nearest(jnp.asarray(z), jnp.asarray(embed))
    assert np.asarray(ref).tolist() == [5, 5, 2]


@pytest.mark.parametrize("flatten", [False, True])
def test_rvq_matches_jax_bit_exact(flatten):
    rng = np.random.default_rng(3)
    q, n, d = 4, 64, 16
    embed = rng.standard_normal((q, n, d)).astype(np.float32)
    z = (1.5 * rng.standard_normal((2, 50, d))).astype(np.float32)
    jzq, jidx = jax_vq.rvq_forward_index(jnp.asarray(z),
                                         {"embed": jnp.asarray(embed)},
                                         flatten=flatten)
    params = {"embed": torch.from_numpy(embed)}
    zq, idx = vq.rvq_forward_index(torch.from_numpy(z), params,
                                   flatten=flatten)
    assert idx.dtype == torch.int32 and idx.shape == (2, 50, q)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(zq.numpy(), np.asarray(jzq), rtol=1e-5,
                               atol=1e-5)
    ref = np.asarray(jax_vq.rvq_lookup(jidx, {"embed": jnp.asarray(embed)},
                                       flattened=flatten))
    out = vq.rvq_lookup(idx, params, flattened=flatten)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
