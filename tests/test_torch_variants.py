"""The batch autoencoder's other variants in the port: the noncausal convs
and mode, the activate_audiodec codec, other stride pyramids (the hop-320
config's among them), `receptive_field`, and `BatchTranscoder(stack=
"folded")` on every config, against the JAX package and the goldens.

Tolerances as tests/test_generator_parity.py and tests/test_noncausal.py:
z and zq rtol 1e-4 and atol 1e-4, waveforms rtol 1e-3 and atol 1e-4 against
a golden; against JAX on the same weights, indices equal and waveforms
rtol 1e-4, atol 1e-5.
"""

import dataclasses
import os
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiodec_tpu.models import autoencoder as jax_ae
from audiodec_tpu.ops import conv as jax_conv
from audiodec_tpu_torch.bin.codec_test import BatchTranscoder
from audiodec_tpu_torch.models import autoencoder as ae
from audiodec_tpu_torch.models import fast
from audiodec_tpu_torch.models.autoencoder import GeneratorConfig
from audiodec_tpu_torch.ops import conv
from audiodec_tpu_torch.ops.vq import rvq_forward_index, rvq_lookup
from audiodec_tpu_torch.utils.bridge import (
    params_from_reference_sd,
    params_to_jax,
)
from audiodec_tpu_torch.utils.config import generator_config, load_config

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
SMALL = dict(encode_channels=4, decode_channels=4, code_dim=16,
             codebook_num=4, codebook_size=32)
# tests/test_variants.py:21-37
VARIANTS = {
    "c16_hop320": dict(encode_channels=2, decode_channels=2, code_dim=8,
                       codebook_num=4, codebook_size=16,
                       enc_strides=(2, 4, 5, 8), dec_strides=(8, 5, 4, 2)),
    "uneven": dict(encode_channels=2, decode_channels=2, code_dim=8,
                   codebook_num=2, codebook_size=8, enc_ratios=(2, 4, 8),
                   dec_ratios=(8, 4, 2), enc_strides=(4, 5, 6),
                   dec_strides=(6, 5, 4)),
    "two_stage": dict(encode_channels=2, decode_channels=2, code_dim=8,
                      codebook_num=2, codebook_size=8, enc_ratios=(2, 4),
                      dec_ratios=(4, 2), enc_strides=(3, 4),
                      dec_strides=(4, 3)),
}


def _golden(name, cfg):
    data = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    sd = {k[len("sd__"):]: data[k] for k in data.files
          if k.startswith("sd__")}
    return data, params_from_reference_sd(sd, cfg)


def _bct(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1)))


# ---------------------------------------------------------------------------
# the noncausal convs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stride", [1, 2, 3, 4, 5, 8])
def test_noncausal_convs_match_jax(stride):
    """noncausal_conv1d (k = 2s strided, and k = 7 at dilation 3) and
    noncausal_conv_transpose1d (k = 2s, padding (s+1)//2, output_padding
    s % 2) against JAX's, at odd and even strides: the same lengths,
    values within rtol 1e-5, atol 1e-6."""
    rng = np.random.default_rng(stride)
    cin, cout, t = 3, 4, 8 * stride
    x = rng.standard_normal((2, t, cin)).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    cases = [(2 * stride, stride, 1), (7, 1, 3)]
    for k, s, d in cases:
        w = (0.3 * rng.standard_normal((cout, cin, k))).astype(np.float32)
        y = conv.noncausal_conv1d(_bct(x), {"w": torch.from_numpy(w),
                                            "b": torch.from_numpy(b)},
                                  stride=s, dilation=d)
        jy = jax_conv.noncausal_conv1d(
            jnp.asarray(x), {"w": jnp.asarray(w.transpose(2, 1, 0)),
                             "b": jnp.asarray(b)}, stride=s, dilation=d)
        assert y.shape[-1] == jy.shape[1]
        np.testing.assert_allclose(y.numpy().transpose(0, 2, 1),
                                   np.asarray(jy), rtol=1e-5, atol=1e-6)
    k = 2 * stride
    w = (0.3 * rng.standard_normal((cin, cout, k))).astype(np.float32)
    y = conv.noncausal_conv_transpose1d(
        _bct(x[:, :8]), {"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
        stride=stride)
    jw = np.ascontiguousarray(np.transpose(w, (2, 0, 1))[::-1])
    jy = jax_conv.noncausal_conv_transpose1d(
        jnp.asarray(x[:, :8]), {"w": jnp.asarray(jw), "b": jnp.asarray(b)},
        stride=stride)
    assert y.shape[-1] == jy.shape[1]
    np.testing.assert_allclose(y.numpy().transpose(0, 2, 1), np.asarray(jy),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the goldens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,cfg", [
    ("gen_noncausal", GeneratorConfig(**SMALL, mode="noncausal")),
    ("gen_symaad", GeneratorConfig(**SMALL, codec="activate_audiodec")),
])
def test_batch_golden(name, cfg):
    """The batch forward (eval): z and zq within 1e-4, y within rtol 1e-3,
    atol 1e-4; BatchTranscoder(stack="plain") gives the same indices and
    waveform as the plain functions."""
    data, params = _golden(name, cfg)
    x = _bct(data["x"])
    h = ae.encoder_apply(params["encoder"], x, cfg)
    z = ae.projector_apply(params["projector"], h, cfg)
    zq, idx = rvq_forward_index(z, params["quantizer"])
    y = ae.decoder_apply(params["decoder"], zq, cfg)
    np.testing.assert_allclose(z.numpy().transpose(0, 2, 1), data["z"],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(zq.numpy().transpose(0, 2, 1), data["zq"],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(y.numpy().transpose(0, 2, 1), data["y"],
                               rtol=1e-3, atol=1e-4)
    idx_t, y_t = BatchTranscoder(params, cfg, stack="plain",
                                 device="cpu")(x)
    assert torch.equal(idx_t, idx)
    np.testing.assert_allclose(y_t.numpy(),
                               ae.decoder_apply(params["decoder"],
                                                rvq_lookup(idx,
                                                           params["quantizer"]),
                                                cfg).numpy(),
                               rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the repair: stack="folded" takes every config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,cfg", [
    ("gen_symaad", GeneratorConfig(**SMALL, codec="activate_audiodec")),
    ("gen_noncausal", GeneratorConfig(**SMALL, mode="noncausal")),
    ("symAAD_vctk_48000_hop300", "configs/autoencoder/"
     "symAAD_vctk_48000_hop300.yaml"),
])
def test_folded_stack_runs_every_config(name, cfg, monkeypatch):
    """BatchTranscoder(stack="folded") on an activate_audiodec or noncausal
    config runs the plain encoder and decoder, as JAX does
    (audiodec_tpu/bin/codec_test.py:226-227): the same indices and
    waveform as stack="plain", and no call of the folded stack.  (Before,
    `_check_supported` raised NotImplementedError.)  The repo's symAAD
    config is read with its own loader and narrowed to gen_small's widths,
    with gen_symaad's weights."""
    if isinstance(cfg, str):
        cfg = dataclasses.replace(
            generator_config(load_config(os.path.join(ROOT, cfg))), **SMALL)
        assert cfg.codec == "activate_audiodec"
        _, params = _golden("gen_symaad", cfg)
    else:
        _, params = _golden(name, cfg)
    monkeypatch.setattr(fast, "folded_residual_stack", None)
    x = (0.3 * np.random.default_rng(0)
         .standard_normal((2, 6 * cfg.hop_length, 1))).astype(np.float32)
    idx, y = BatchTranscoder(params, cfg, stack="folded", device="cpu")(x)
    idx_p, y_p = BatchTranscoder(params, cfg, stack="plain", device="cpu")(x)
    assert idx.shape == (2, 6, cfg.codebook_num)
    assert torch.equal(idx, idx_p)
    assert torch.equal(y, y_p)
    with pytest.warns(UserWarning, match="int8-decode cannot be honored"):
        tc = BatchTranscoder(params, cfg, stack="folded", int8_decode=True,
                             device="cpu")
    assert not tc.int8_decode
    assert torch.equal(tc(x)[1], y)


def test_folded_path_refuses_other_configs():
    """encoder_apply_folded / decoder_apply_folded take the causal audiodec
    codec only, as JAX asserts (audiodec_tpu/models/fast.py:82, :97)."""
    cfg = GeneratorConfig(**SMALL, mode="noncausal")
    _, params = _golden("gen_noncausal", cfg)
    with pytest.raises(ValueError):
        fast.encoder_apply_folded(params["encoder"],
                                  torch.zeros(1, 600, 1), cfg)
    with pytest.raises(ValueError):
        fast.decoder_apply_folded(params["decoder"],
                                  torch.zeros(1, 2, cfg.code_dim), cfg)


# ---------------------------------------------------------------------------
# other stride pyramids (tests/test_variants.py on the port)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_matches_jax_and_streams(name):
    """The port's generator_init weights (JAX's shapes and scales) in both
    packages: the batch indices equal JAX's and the waveform within rtol
    1e-4, atol 1e-5; the port's streaming encoder, one hop per call, equals
    its batch encoder within rtol 1e-4, atol 1e-5; the streaming decode
    gives one hop per frame."""
    jcfg = jax_ae.GeneratorConfig(**VARIANTS[name])
    cfg = GeneratorConfig(**VARIANTS[name])
    params = ae.generator_init(cfg, torch.Generator().manual_seed(0))
    jparams = jax.tree_util.tree_map(jnp.asarray, params_to_jax(params))
    hop, n = cfg.hop_length, 5
    x = (0.3 * np.random.default_rng(0)
         .standard_normal((1, n * hop, 1))).astype(np.float32)
    # jitted: one compile each, where eager JAX runs op by op
    jidx = jax.jit(partial(jax_ae.generator_encode, cfg=jcfg))(
        jparams, jnp.asarray(x))
    jy = jax.jit(partial(jax_ae.generator_decode, cfg=jcfg))(jparams, jidx)
    idx = ae.generator_encode(params, torch.from_numpy(x), cfg)
    y = ae.generator_decode(params, idx, cfg)
    assert tuple(idx.shape) == (1, n, cfg.codebook_num)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-5)

    h = ae.encoder_apply(params["encoder"], torch.from_numpy(x), cfg)
    state = ae.codec_state_init(1, cfg)
    enc_state, dec_state, hs, ys = state["encoder"], state["decoder"], [], []
    zq = rvq_lookup(idx, params["quantizer"])
    for i in range(n):
        hi, enc_state = ae.encoder_apply(
            params["encoder"], torch.from_numpy(x[:, i * hop:(i + 1) * hop]),
            cfg, state=enc_state)
        hs.append(hi)
        yi, dec_state = ae.decoder_apply(params["decoder"], zq[:, i:i + 1],
                                         cfg, state=dec_state)
        ys.append(yi)
    np.testing.assert_allclose(torch.cat(hs, dim=1).numpy(), h.numpy(),
                               rtol=1e-4, atol=1e-5)
    assert tuple(torch.cat(ys, dim=1).shape) == (1, n * hop, 1)


@pytest.mark.parametrize("kw", [
    {}, SMALL, *VARIANTS.values(),
    {"res_kernel_size": 5, "res_dilations": (1, 2)},
    {"kernel_size": 5},
])
def test_receptive_field_matches_jax(kw):
    """GeneratorConfig.receptive_field equals JAX's (7209 for symAD)."""
    assert (GeneratorConfig(**kw).receptive_field
            == jax_ae.GeneratorConfig(**kw).receptive_field)
    assert GeneratorConfig().receptive_field == 7209
