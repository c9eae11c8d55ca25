"""The slice as a whole: the port's batch transcode against the JAX
package's, and against the reference goldens.

A small config (encode_channels=4, as `gen_small`) sends every residual
stack through the fused-stack path at T=2400; JAX runs its folded kernel in
interpret mode, the port its plain version on the CPU.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiodec_tpu.bin.codec_test import BatchTranscoder as JaxTranscoder
from audiodec_tpu.models import fast as jax_fast
from audiodec_tpu.models import autoencoder as jax_ae
from audiodec_tpu.models.autoencoder import GeneratorConfig as JaxConfig
from audiodec_tpu.utils.torch_import import import_autoencoder
from audiodec_tpu_torch.bin.codec_test import BatchTranscoder
from audiodec_tpu_torch.models import autoencoder, fast
from audiodec_tpu_torch.models.autoencoder import GeneratorConfig
from audiodec_tpu_torch.utils.bridge import (
    params_from_jax,
    params_from_reference_sd,
)

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
SMALL = dict(encode_channels=4, decode_channels=4, code_dim=16,
             codebook_num=4, codebook_size=32)


def _golden(name):
    data = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    sd = {k[len("sd__"):]: data[k] for k in data.files
          if k.startswith("sd__")}
    return data, sd


@pytest.fixture(scope="module")
def small():
    _, sd = _golden("gen_small")
    jcfg = JaxConfig(**SMALL)
    jparams = jax.tree_util.tree_map(np.asarray, import_autoencoder(sd, jcfg))
    x = (0.3 * np.random.default_rng(0)
         .standard_normal((2, 2400, 1))).astype(np.float32)
    return jcfg, jparams, GeneratorConfig(**SMALL), params_from_jax(jparams), x


def test_config_copy_matches_jax():
    assert ({f.name: getattr(GeneratorConfig(), f.name)
             for f in dataclasses.fields(GeneratorConfig)}
            == {f.name: getattr(JaxConfig(), f.name)
                for f in dataclasses.fields(JaxConfig)})


def test_bridges_agree(small):
    """params_from_jax(import_autoencoder(sd)) == params_from_reference_sd(sd)."""
    _, sd = _golden("gen_small")
    a = params_from_reference_sd(sd, GeneratorConfig(**SMALL))
    b = small[3]

    def leaves(t, path=""):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from leaves(t[k], f"{path}/{k}")
        elif isinstance(t, list):
            for i, v in enumerate(t):
                yield from leaves(v, f"{path}/{i}")
        else:
            yield path, t

    la, lb = dict(leaves(a)), dict(leaves(b))
    assert set(la) == set(lb)
    for k in la:
        assert torch.equal(la[k], lb[k]), k


def test_folded_encoder_decoder_match_jax(small, monkeypatch):
    jcfg, jparams, cfg, params, x = small
    calls = []
    real = fast.folded_residual_stack
    monkeypatch.setattr(fast, "folded_residual_stack",
                        lambda *a, **k: calls.append(a[0].shape) or
                        real(*a, **k))
    ref_h = np.asarray(jax_fast.encoder_apply_folded(
        jparams["encoder"], jnp.asarray(x), jcfg, interpret=True))
    h = fast.encoder_apply_folded(params["encoder"], torch.from_numpy(x), cfg)
    np.testing.assert_allclose(h.numpy(), ref_h, rtol=5e-2, atol=5e-3)
    z = (0.3 * np.random.default_rng(1)
         .standard_normal((2, 8, cfg.code_dim))).astype(np.float32)
    ref_y = np.asarray(jax_fast.decoder_apply_folded(
        jparams["decoder"], jnp.asarray(z), jcfg, interpret=True))
    y = fast.decoder_apply_folded(params["decoder"], torch.from_numpy(z), cfg)
    np.testing.assert_allclose(y.numpy(), ref_y, rtol=5e-2, atol=5e-3)
    # every stack (4 encoder, 4 decoder, C = 4..32) took the kernel path
    assert sorted(s[1] for s in calls) == [4, 4, 8, 8, 16, 16, 32, 32]


def test_batch_transcoder_matches_jax(small):
    jcfg, jparams, cfg, params, x = small
    jidx, jy = JaxTranscoder(jax.tree_util.tree_map(jnp.asarray, jparams),
                             jcfg, stack="folded")(x)
    idx, y = BatchTranscoder(params, cfg, stack="folded", device="cpu")(x)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=5e-2,
                               atol=5e-3)


def test_plain_path_matches_jax(small):
    """Unfused path: generator_encode/decode against JAX's, and
    BatchTranscoder(stack="plain") against both."""
    jcfg, jparams, cfg, params, x = small
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    jidx = np.asarray(jax_ae.generator_encode(jp, jnp.asarray(x), jcfg))
    jy = np.asarray(jax_ae.generator_decode(jp, jnp.asarray(jidx), jcfg))
    idx = autoencoder.generator_encode(params, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    y = autoencoder.generator_decode(params, idx, cfg)
    np.testing.assert_allclose(y.numpy(), jy, rtol=1e-4, atol=1e-5)
    idx_b, y_b = BatchTranscoder(params, cfg, stack="plain", device="cpu")(x)
    assert torch.equal(idx_b, idx)
    np.testing.assert_allclose(y_b.numpy(), jy, rtol=1e-4, atol=1e-5)


def test_full_width_golden_parity():
    """Full symAD width from the reference state dict: true-f32 stacks give
    the golden indices and waveform; the default bf16-operand stacks give
    the golden indices too (the claim of tests/test_folded_stack.py)."""
    data, sd = _golden("gen_symad")
    cfg = GeneratorConfig()
    params = params_from_reference_sd(sd, cfg)
    x = data["x"].transpose(0, 2, 1)
    idx, y = BatchTranscoder(params, cfg, stack="folded", bf16_dots=False,
                             device="cpu")(x)
    # idx_stream is (Q, T') in the reference's flat format (layer q
    # offset by q*N)
    flat = np.arange(cfg.codebook_num)[:, None] * cfg.codebook_size
    np.testing.assert_array_equal(idx[0].numpy().T + flat,
                                  data["idx_stream"])
    np.testing.assert_allclose(y.numpy().transpose(0, 2, 1), data["y"],
                               rtol=1e-3, atol=1e-4)
    idx16 = BatchTranscoder(params, cfg, stack="folded",
                            device="cpu").encode(x)
    np.testing.assert_array_equal(idx16[0].numpy().T + flat,
                                  data["idx_stream"])


@pytest.mark.parametrize("name,projector", [("gen_small", "conv1d"),
                                            ("gen_symad_bn", "conv1d_bn")])
def test_projector_matches_golden(name, projector):
    """Encoder + projector (conv1d, and conv1d_bn with running-stat BN)
    against the reference's eval-mode z."""
    data, sd = _golden(name)
    cfg = GeneratorConfig(projector=projector, **SMALL)
    params = params_from_reference_sd(sd, cfg)
    assert ("bn" in params["projector"]) == (projector == "conv1d_bn")
    x = torch.from_numpy(data["x"].transpose(0, 2, 1))
    h = autoencoder.encoder_apply(params["encoder"], x, cfg)
    z = autoencoder.projector_apply(params["projector"], h, cfg)
    np.testing.assert_allclose(z.numpy().transpose(0, 2, 1), data["z"],
                               rtol=1e-4, atol=1e-4)


def test_mixed_mode_keeps_f32_indices(small):
    """Mixed mode (f32 encoder and RVQ, bf16 decoder) encodes exactly as
    f32 mode and decodes within bf16 error of it."""
    _, _, cfg, params, x = small
    idx, y = BatchTranscoder(params, cfg, device="cpu")(x)
    idx_m, y_m = BatchTranscoder(params, cfg, dec_dtype=torch.bfloat16,
                                 device="cpu")(x)
    assert torch.equal(idx, idx_m)
    assert y_m.dtype == torch.float32
    rel = float((y_m - y).abs().max() / y.abs().max())
    assert rel < 0.05


def test_generator_encode_folds_channels():
    """A multi-channel waveform is folded into the batch as JAX's
    generator_encode does (`_channel_fold`, consecutive channels grouped):
    (1, 1200, 2) gives indices (2, 4, 2), equal to JAX's."""
    narrow = dict(encode_channels=2, decode_channels=2, code_dim=8,
                  codebook_num=2, codebook_size=16)
    jcfg = JaxConfig(**narrow)
    jp = jax.tree_util.tree_map(
        np.array, jax_ae.generator_init(jax.random.PRNGKey(0), jcfg))
    x = (0.3 * np.random.default_rng(0)
         .standard_normal((1, 1200, 2))).astype(np.float32)
    jidx = np.asarray(jax_ae.generator_encode(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x), jcfg))
    idx = autoencoder.generator_encode(params_from_jax(jp),
                                       torch.from_numpy(x),
                                       GeneratorConfig(**narrow))
    assert jidx.shape == (2, 4, 2)
    np.testing.assert_array_equal(idx.numpy(), jidx)
