"""`archive/blocked.py` and the blocked encoder and decoder of
`archive/fast_experiments.py` against the JAX package's
(`audiodec_tpu/archive/blocked.py`, `archive/fast_experiments.py:33, :49`),
at `tests/test_blocked.py`'s shapes and on gen_small's widths.

The port's blocked layout is (B, P*C, T/P), JAX's (B, T/P, P*C); the
tests carry inputs and weights across and compare in JAX's layout.
Tolerances: `tests/test_blocked.py`'s rtol 1e-4, atol 1e-4 for the
convs on weights scaled by 50 and the stack on weights scaled by 10; the
codec within rtol 1e-5, atol 1e-6 of JAX's and the indices equal.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiodec_tpu.archive import blocked as jax_blocked
from audiodec_tpu.archive import fast_experiments as jax_fx
from audiodec_tpu.models.autoencoder import GeneratorConfig as JaxConfig
from audiodec_tpu.models.autoencoder import _res_unit_init
from audiodec_tpu.ops.conv import conv1d_init
from audiodec_tpu.utils.torch_import import import_autoencoder
from audiodec_tpu_torch.archive import blocked, fast_experiments
from audiodec_tpu_torch.models.autoencoder import (
    GeneratorConfig,
    decoder_apply,
    encoder_apply,
)
from audiodec_tpu_torch.ops.conv import causal_conv1d
from audiodec_tpu_torch.utils.bridge import params_from_jax

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
SMALL = dict(encode_channels=4, decode_channels=4, code_dim=16,
             codebook_num=4, codebook_size=32)
CONVS = [(32, 7, 1, 4), (32, 7, 3, 4), (32, 7, 9, 4), (64, 7, 1, 2),
         (32, 1, 1, 4), (16, 3, 1, 8)]


def _port_conv(p):
    out = {"w": torch.from_numpy(np.asarray(p["w"]).transpose(2, 1, 0)
                                 .copy())}
    if "b" in p:
        out["b"] = torch.from_numpy(np.asarray(p["b"]).copy())
    return out


def _bct(a):
    return torch.from_numpy(np.asarray(a).transpose(0, 2, 1).copy())


@pytest.mark.parametrize("c,k,d,p", CONVS)
def test_blocked_conv_matches_jax(c, k, d, p):
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda w: np.asarray(w) * 50.0,
        conv1d_init(jax.random.PRNGKey(0), k, c, c, bias=True))
    x = rng.standard_normal((2, 16 * p, c)).astype(np.float32)
    want = np.asarray(jax_blocked.blocked_causal_conv1d(
        jax_blocked.block_time(jnp.asarray(x), p), params["w"], dilation=d,
        p=p, b_bias=params["b"]))
    pc = _port_conv(params)
    xb = blocked.block_time(_bct(x), p)
    # the port's (B, P*C, T/P) holds JAX's (B, T/P, P*C), transposed
    np.testing.assert_array_equal(
        xb.numpy().transpose(0, 2, 1),
        np.asarray(jax_blocked.block_time(jnp.asarray(x), p)))
    yb = blocked.blocked_causal_conv1d(xb, pc["w"], dilation=d, p=p,
                                       b_bias=pc["b"])
    np.testing.assert_allclose(yb.numpy().transpose(0, 2, 1), want,
                               rtol=1e-4, atol=1e-4)
    flat = causal_conv1d(_bct(x), pc, dilation=d)
    np.testing.assert_allclose(blocked.unblock_time(yb, p).numpy(),
                               flat.numpy(), rtol=1e-4, atol=1e-4)
    wp = np.asarray(jax_blocked.pack_weights(jnp.asarray(params["w"]), d, p))
    np.testing.assert_array_equal(
        blocked.pack_weights(pc["w"], d, p).numpy(), wp.transpose(2, 1, 0))


@pytest.mark.parametrize("t", [1200, 1201])
def test_blocked_res_stack_matches_jax(t):
    """test_blocked.py's stack (C = 32, k = 7, dilations 1/3/9, weights
    x10); 1201 is not a multiple of P = 4."""
    cfg = JaxConfig()
    keys = jax.random.split(jax.random.PRNGKey(1), 3)
    units = jax.tree_util.tree_map(
        lambda w: np.asarray(w) * 10.0,
        [_res_unit_init(keys[i], 32, 7) for i in range(3)])
    x = np.random.default_rng(3).standard_normal((2, t, 32)).astype(
        np.float32)
    want = np.asarray(jax_blocked.blocked_res_stack(
        jnp.asarray(x), units, dilations=(1, 3, 9), act=cfg.act))
    port_units = [{k: _port_conv(v) for k, v in u.items()} for u in units]
    got = blocked.blocked_res_stack(_bct(x), port_units, dilations=(1, 3, 9),
                                    act=GeneratorConfig().act)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1), want,
                               rtol=1e-4, atol=1e-4)


def test_pack_factor():
    for c in (1, 4, 16, 32, 64, 100, 128, 256):
        assert blocked.pack_factor(c) == jax_blocked.pack_factor(c)
    assert [blocked.pack_factor(c) for c in (32, 64, 128, 256)] == [
        4, 2, 1, 1]


@pytest.fixture(scope="module")
def codec():
    data = np.load(os.path.join(GOLDEN, "gen_small.npz"))
    sd = {k[len("sd__"):]: data[k] for k in data.files
          if k.startswith("sd__")}
    jcfg = JaxConfig(**SMALL)
    jparams = jax.tree_util.tree_map(np.asarray,
                                     import_autoencoder(sd, jcfg))
    rng = np.random.default_rng(5)
    x = (0.3 * rng.standard_normal((2, 24 * 300, 1))).astype(np.float32)
    zq = (0.5 * rng.standard_normal((2, 24, 16))).astype(np.float32)

    # eager: JAX's pack_weights is jitted per (dilation, P) already, and
    # one jit of the whole codec compiles for about 20 s
    h = np.asarray(jax_fx.encoder_apply_blocked(jparams["encoder"], x, jcfg))
    y = np.asarray(jax_fx.decoder_apply_blocked(jparams["decoder"], zq,
                                                jcfg))
    return params_from_jax(jparams), x, zq, h, y


def test_blocked_codec_matches_jax(codec):
    """encoder_apply_blocked / decoder_apply_blocked on gen_small (C = 4 to
    64: P = 32 to 2) against JAX's and the flat encoder and decoder."""
    params, x, zq, h, y = codec
    cfg = GeneratorConfig(**SMALL)
    xt, zt = torch.from_numpy(x), torch.from_numpy(zq)
    got_h = fast_experiments.encoder_apply_blocked(params["encoder"], xt, cfg)
    got_y = fast_experiments.decoder_apply_blocked(params["decoder"], zt, cfg)
    assert got_h.shape == h.shape and got_y.shape == y.shape
    np.testing.assert_allclose(got_h.numpy(), h, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_y.numpy(), y, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        got_h.numpy(), encoder_apply(params["encoder"], xt, cfg).numpy(),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        got_y.numpy(), decoder_apply(params["decoder"], zt, cfg).numpy(),
        rtol=1e-5, atol=1e-6)
