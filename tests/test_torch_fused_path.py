"""The slice as a whole: the fused transcode of tools/fused_probe.py in the
port against the JAX package's, and against the reference golden.

The narrow config is tests/test_fast_paths.py's; JAX runs its archived
kernels in interpret mode, the port their plain versions on the CPU.  The
CUDA kernels are held to the plain versions on the card by chip_smoke.py.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiodec_tpu.archive import fast_experiments as jax_fe
from audiodec_tpu.archive.vq_kernel import rvq_encode_pallas as jax_rvq
from audiodec_tpu.models import autoencoder as jax_ae
from audiodec_tpu.models.autoencoder import GeneratorConfig as JaxConfig
from audiodec_tpu.train import checkpoint as jax_ckpt
from audiodec_tpu_torch.archive import fast_experiments
from audiodec_tpu_torch.bin import fused_probe
from audiodec_tpu_torch.models.autoencoder import (
    GeneratorConfig,
    generator_init,
)
from audiodec_tpu_torch.utils.bridge import (
    params_from_jax,
    params_from_reference_sd,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(encode_channels=2, decode_channels=2, code_dim=8,
              codebook_num=2, codebook_size=16)


@functools.cache
def _jax_params(key, cfg=None):
    """JAX generator_init of `cfg` (the narrow config by default) as numpy;
    cached, since JAX compiles its random draws per shape."""
    return jax.tree_util.tree_map(
        np.array, jax_ae.generator_init(jax.random.PRNGKey(key),
                                        cfg or JaxConfig(**NARROW)))


def test_fused_encoder_matches_jax():
    jp = _jax_params(0)
    x = (0.3 * np.random.default_rng(0)
         .standard_normal((1, 4 * 300, 1))).astype(np.float32)
    ref = np.asarray(jax_fe.encoder_apply_fused(
        jax.tree_util.tree_map(jnp.asarray, jp["encoder"]), jnp.asarray(x),
        JaxConfig(**NARROW), tile_t=300, interpret=True))
    out = fast_experiments.encoder_apply_fused(
        params_from_jax(jp)["encoder"], torch.from_numpy(x),
        GeneratorConfig(**NARROW))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_fused_decoder_matches_jax():
    jp = _jax_params(1)
    z = (0.3 * np.random.default_rng(1)
         .standard_normal((1, 4, NARROW["code_dim"]))).astype(np.float32)
    ref = np.asarray(jax_fe.decoder_apply_fused(
        jax.tree_util.tree_map(jnp.asarray, jp["decoder"]), jnp.asarray(z),
        JaxConfig(**NARROW), tile_t=512, interpret=True))
    out = fast_experiments.decoder_apply_fused(
        params_from_jax(jp)["decoder"], torch.from_numpy(z),
        GeneratorConfig(**NARROW))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)


def _jax_fused_path(params, x, cfg):
    """tools/fused_probe.py's fused_path, with the kernels interpreted."""
    h = jax_fe.encoder_apply_fused(params["encoder"], x, cfg, tile_t=4800,
                                   interpret=True)
    z = jax_ae.projector_apply(params["projector"], h, cfg)
    zq, idx = jax_rvq(z, params["quantizer"]["embed"], interpret=True)
    y = jax_fe.decoder_apply_fused(params["decoder"], zq, cfg, tile_t=4800,
                                   interpret=True)
    return idx, y


def test_fused_path_matches_jax():
    jp = _jax_params(0)
    x = (0.3 * np.random.default_rng(2)
         .standard_normal((2, 4 * 300, 1))).astype(np.float32)
    jidx, jy = _jax_fused_path(jax.tree_util.tree_map(jnp.asarray, jp),
                               jnp.asarray(x), JaxConfig(**NARROW))
    idx, y = fused_probe.fused_path(params_from_jax(jp), torch.from_numpy(x),
                                    GeneratorConfig(**NARROW))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-5)


def test_full_width_fused_path_golden():
    """gen_symad through the full-width fused path: the golden's indices
    with 0 flips, the waveform within the golden bar."""
    data = np.load(os.path.join(ROOT, "tests", "golden", "gen_symad.npz"))
    sd = {k[len("sd__"):]: data[k] for k in data.files
          if k.startswith("sd__")}
    cfg = GeneratorConfig()
    params = params_from_reference_sd(sd, cfg)
    x = torch.from_numpy(data["x"].transpose(0, 2, 1).copy())
    idx, y = fused_probe.fused_path(params, x, cfg)
    flat = np.arange(cfg.codebook_num)[:, None] * cfg.codebook_size
    np.testing.assert_array_equal(idx[0].numpy().T + flat,
                                  data["idx_stream"])
    np.testing.assert_allclose(y.numpy().transpose(0, 2, 1), data["y"],
                               rtol=1e-3, atol=1e-4)


@pytest.fixture(scope="module")
def narrow_checkpoint(tmp_path_factory):
    """JAX generator_init(PRNGKey(0)) of the narrow config as a JAX-written
    checkpoint, its config.yml an `inherit:` of the symAD config."""
    d = tmp_path_factory.mktemp("exp")
    with open(os.path.join(ROOT, "configs", "autoencoder",
                           "symAD_vctk_48000_hop300.yaml")) as f:
        (d / "base.yaml").write_text(f.read())
    (d / "config.yml").write_text(
        "inherit: base.yaml\ngenerator_params:\n"
        + "".join(f"    {k}: {v}\n" for k, v in NARROW.items()))
    path = str(d / "checkpoint-1.ckpt")
    jax_ckpt.save_checkpoint(path, {"gen": _jax_params(0)}, 1)
    return path


def test_probe_main_on_cpu(narrow_checkpoint, capsys):
    result = fused_probe.main(["--device", "cpu", "--checkpoint",
                               narrow_checkpoint, "--batch", "1",
                               "--seconds", "0.025", "--iters", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("plain: ") and lines[1].startswith("fused: ")
    assert lines[2] == "indices equal: True"
    printed = json.loads(lines[-1])
    assert printed == result
    assert printed["device"] == "cpu" and printed["samples"] == 1200
    assert printed["index_flips"] == 0 and printed["indices"] == 4 * 2
    assert printed["plain_ms"] > 0 and printed["fused_rtf"] > 0


@pytest.mark.parametrize("projector", ["conv1d", "conv1d_bn"])
def test_generator_init_mirrors_jax_tree(projector):
    """The port's generator_init: JAX's keys, shapes and dtypes (in torch's
    orientation), with the JAX init's scales."""
    jcfg = JaxConfig(projector=projector, **NARROW)
    ref = params_from_jax(_jax_params(0, jcfg))
    p = generator_init(GeneratorConfig(projector=projector, **NARROW),
                       torch.Generator().manual_seed(0))

    def leaves(t, path=""):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from leaves(t[k], f"{path}/{k}")
        elif isinstance(t, list):
            for i, v in enumerate(t):
                yield from leaves(v, f"{path}/{i}")
        else:
            yield path, t

    la, lb = dict(leaves(p)), dict(leaves(ref))
    assert set(la) == set(lb)
    for k in la:
        assert la[k].shape == lb[k].shape and la[k].dtype == lb[k].dtype, k
    # normal weights at 0.01, zero biases, unit-normal codebooks
    assert abs(float(p["decoder"]["conv1"]["w"].std()) - 0.01) < 2e-3
    assert not p["encoder"]["blocks"][0]["conv"]["b"].any()
    assert abs(float(p["quantizer"]["embed"].std()) - 1.0) < 0.1
    assert torch.equal(p["quantizer"]["embed_avg"], p["quantizer"]["embed"])
