"""The port's HiFiGAN vocoder (the AD v0/v1/v2 receivers) against the JAX
package's and against the reference goldens.

On the CPU the port's kernel wrapper runs its plain PyTorch version; JAX
runs its folded Pallas kernel in interpret mode.  The same numpy inputs and
weights feed both.  The CUDA kernel itself is held to the plain version on
the card by chip_smoke.py.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from audiodec_tpu.bin.codec_test import BatchTranscoder as JaxTranscoder
from audiodec_tpu.models import fast as jax_fast
from audiodec_tpu.models import vocoder as jax_voc
from audiodec_tpu.models.autoencoder import GeneratorConfig as JaxConfig
from audiodec_tpu.utils.config import generator_config, load_config
from audiodec_tpu.utils.torch_import import import_autoencoder, import_vocoder
from audiodec_tpu_torch.bin.codec_test import BatchTranscoder
from audiodec_tpu_torch.models import fast
from audiodec_tpu_torch.models.autoencoder import GeneratorConfig
from audiodec_tpu_torch.models.vocoder import (
    VocoderConfig,
    config_from_yaml,
    vocoder_apply,
    vocoder_init,
)
from audiodec_tpu_torch.ops.kernels import folded_stack
from audiodec_tpu_torch.utils.bridge import (
    params_from_jax,
    vocoder_params_from_jax,
    vocoder_params_from_reference_sd,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
VOC_YAML = os.path.join(ROOT, "configs", "vocoder",
                        "AudioDec_{}_symAD_vctk_48000_hop300_clean.yaml")

# the goldens' configs (tests/test_vocoder_parity.py:20-37), as the card's
# smoke run holds them
GOLDEN_CFGS = chip_smoke.VOC_GOLDENS
# the grouped and MRF configs of tests/test_folded_stack.py:200-238
FOLDED_CFGS = {
    "grouped": dict(in_channels=16, channels=64,
                    upsample_scales=(5, 5, 4, 3),
                    upsample_kernel_sizes=(10, 10, 8, 6),
                    resblock_kernel_sizes=(11,),
                    resblock_dilations=((1, 3, 5),), groups=3, stats=True),
    "mrf": dict(in_channels=16, channels=64, upsample_scales=(5, 5, 4, 3),
                upsample_kernel_sizes=(10, 10, 8, 6),
                resblock_kernel_sizes=(3, 7),
                resblock_dilations=((1, 3), (1, 3)), groups=1),
}


def _golden(name):
    data = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    sd = {k[len("sd__"):]: data[k] for k in data.files
          if k.startswith("sd__")}
    # the trained golden's input is its analyzer's zq, the others' is c
    c = data["zq"] if "zq" in data.files else data["c"]
    return data, sd, c.transpose(0, 2, 1)


def _random_jax_vocoder(cfg, seed):
    """JAX vocoder params with fan-in scaled weights, nonzero biases and
    stats, so the waveform is far from zero (the package's own init, at
    scale 0.01, decodes to about 1e-12) and far from tanh's saturation (at
    gain 1.5 the network saturates, and bf16 operands move it by 0.7)."""
    rng = np.random.default_rng(seed)
    tree = jax_voc.vocoder_init(jax.random.PRNGKey(seed), cfg)

    def draw(path, a):
        name = path[-1].key
        if name == "w":
            fan_in = int(np.prod(a.shape[:-1]))
            return (rng.standard_normal(a.shape) * 0.6 / np.sqrt(fan_in)
                    ).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def _leaves(t, path=""):
    if isinstance(t, dict):
        for k in sorted(t):
            yield from _leaves(t[k], f"{path}/{k}")
    elif isinstance(t, list):
        for i, v in enumerate(t):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, t


def test_config_copy_matches_jax():
    assert ({f.name: getattr(VocoderConfig(), f.name)
             for f in dataclasses.fields(VocoderConfig)}
            == {f.name: getattr(jax_voc.VocoderConfig(), f.name)
                for f in dataclasses.fields(jax_voc.VocoderConfig)})


@pytest.mark.parametrize("version", ["v0", "v1", "v2"])
def test_config_from_yaml_matches_jax(version):
    config = load_config(VOC_YAML.format(version))
    gp = config["generator_params"]
    ours = config_from_yaml(gp, stats=gp.get("stats") is not None)
    ref = generator_config(config)
    assert {f.name: getattr(ours, f.name)
            for f in dataclasses.fields(VocoderConfig)} == \
        {f.name: getattr(ref, f.name)
         for f in dataclasses.fields(jax_voc.VocoderConfig)}
    assert ours.grouped == ref.grouped


def test_chip_smoke_ad_v1_config_is_the_yaml():
    config = load_config(VOC_YAML.format("v1"))
    assert chip_smoke.AD_V1_VOCODER == config["generator_params"]


@pytest.mark.parametrize("name", list(GOLDEN_CFGS))
def test_bridges_agree(name):
    """vocoder_params_from_jax(import_vocoder(sd)) ==
    vocoder_params_from_reference_sd(sd)."""
    _, sd, _ = _golden(name)
    cfg = VocoderConfig(**GOLDEN_CFGS[name])
    a = vocoder_params_from_reference_sd(sd, cfg)
    jtree = jax.tree_util.tree_map(
        np.asarray, import_vocoder(sd, jax_voc.VocoderConfig(
            **GOLDEN_CFGS[name])))
    la, lb = dict(_leaves(a)), dict(_leaves(vocoder_params_from_jax(jtree)))
    assert set(la) == set(lb)
    assert ("/mean" in la) == cfg.stats
    for k in la:
        assert torch.equal(la[k], lb[k]), k


@pytest.mark.parametrize("folded", [False, True])
@pytest.mark.parametrize("name", list(GOLDEN_CFGS))
def test_vocoder_matches_golden(name, folded, monkeypatch):
    """Batch `y` of the reference (tests/test_vocoder_parity.py:56,85), by
    the plain path and by the kernel path in true f32; the trained golden's
    biases exercise the masking before t=0."""
    data, sd, c = _golden(name)
    cfg = VocoderConfig(**GOLDEN_CFGS[name])
    assert cfg.grouped == (name != "voc_mrf")
    p = vocoder_params_from_reference_sd(sd, cfg)
    calls = []
    real = fast.folded_residual_stack
    monkeypatch.setattr(fast, "folded_residual_stack",
                        lambda *a, **k: calls.append(a[0].shape[1]) or
                        real(*a, **k))
    c = torch.from_numpy(c)
    y = (fast.vocoder_apply_folded(p, c, cfg, bf16_dots=False) if folded
         else vocoder_apply(p, c, cfg))
    np.testing.assert_allclose(y.numpy().transpose(0, 2, 1), data["y"],
                               rtol=1e-3, atol=1e-5)
    if folded:
        # the stages at C <= 32 whose length the JAX rule accepts
        want = {"voc_mrf": [16] * 3 + [4] * 3, "voc_group": [16] * 3 + [4] * 3,
                "voc_v1_small_trained": [32] * 3 + [16] * 3 + [8] * 3}
        assert calls == want[name]
    else:
        assert not calls


@pytest.mark.parametrize("name", ["voc_group", "voc_v1_small_trained"])
def test_vocoder_matches_jax(name):
    """The port's vocoder_apply against the JAX vocoder_apply on bridged
    weights (f32 on both sides)."""
    _, sd, c = _golden(name)
    jcfg = jax_voc.VocoderConfig(**GOLDEN_CFGS[name])
    jtree = jax.tree_util.tree_map(np.asarray, import_vocoder(sd, jcfg))
    ref = np.asarray(jax_voc.vocoder_apply(
        jax.tree_util.tree_map(jnp.asarray, jtree), jnp.asarray(c), jcfg))
    y = vocoder_apply(vocoder_params_from_jax(jtree), torch.from_numpy(c),
                      VocoderConfig(**GOLDEN_CFGS[name]))
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", list(FOLDED_CFGS))
def test_folded_vocoder_matches_jax(name):
    """vocoder_apply_folded against JAX's (its folded kernel in interpret
    mode), both with bf16 operands in the kernel stages, on weights that
    decode far from zero: the two round the same operands and differ only
    where f32 sums taken in another order round to another bf16 value (MRF:
    3e-6 here, where the f32 path differs from JAX's bf16 one by 4e-5)."""
    jcfg = jax_voc.VocoderConfig(**FOLDED_CFGS[name])
    jtree = _random_jax_vocoder(jcfg, seed=2)
    zq = (0.5 * np.random.default_rng(3)
          .standard_normal((2, 12, 16))).astype(np.float32)
    ref = np.asarray(jax_fast.vocoder_apply_folded(
        jax.tree_util.tree_map(jnp.asarray, jtree), jnp.asarray(zq), jcfg,
        interpret=True))
    assert np.max(np.abs(ref)) > 0.05
    y = fast.vocoder_apply_folded(vocoder_params_from_jax(jtree),
                                  torch.from_numpy(zq),
                                  VocoderConfig(**FOLDED_CFGS[name]))
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_vocoder_init_structure():
    """vocoder_init mirrors the JAX tree: same leaves, same shapes (in
    torch's orientation), zero biases, unit stats, weights at scale 0.01."""
    cfg = VocoderConfig(**FOLDED_CFGS["grouped"])
    p = vocoder_init(cfg, torch.Generator().manual_seed(0))
    jtree = jax.tree_util.tree_map(
        np.asarray, jax_voc.vocoder_init(jax.random.PRNGKey(0),
                                         jax_voc.VocoderConfig(
                                             **FOLDED_CFGS["grouped"])))
    lp, lj = dict(_leaves(p)), dict(_leaves(vocoder_params_from_jax(jtree)))
    assert set(lp) == set(lj)
    for k in lp:
        assert lp[k].shape == lj[k].shape, k
    assert all(not v.any() for k, v in lp.items() if k.endswith("/b"))
    assert torch.equal(lp["/scale"], torch.ones(16))
    w = torch.cat([v.flatten() for k, v in lp.items() if k.endswith("/w")])
    assert abs(float(w.std()) - 0.01) < 1e-3


SMALL = dict(encode_channels=4, decode_channels=4, code_dim=16,
             codebook_num=4, codebook_size=32)


def test_batch_transcoder_with_vocoder_matches_jax(monkeypatch):
    """The receiver end to end at small widths, in the slice's mixed mode
    (f32 encoder and RVQ, bf16 vocoder): gen_small's encoder and a grouped
    vocoder (every stage, C = 32..4, through the kernel path) against the
    JAX transcoder with stack="folded".  Indices are equal; the waveform's
    error relative to its peak is held at the bf16 storage class, 3e-2
    (with f32 storage the two differ by 1.4e-3 of the peak, as much as
    JAX's jitted and unjitted decodes of the same codes differ, since
    both round the kernel stages' operands to bf16 and f32 sums taken in
    another order can round to another bf16 value)."""
    data = np.load(os.path.join(GOLDEN, "gen_small.npz"))
    sd = {k[len("sd__"):]: data[k] for k in data.files
          if k.startswith("sd__")}
    jcfg = JaxConfig(**SMALL)
    jparams = jax.tree_util.tree_map(np.asarray, import_autoencoder(sd, jcfg))
    vcfg = dict(FOLDED_CFGS["grouped"])
    jvcfg = jax_voc.VocoderConfig(**vcfg)
    jvoc = _random_jax_vocoder(jvcfg, seed=4)
    x = (0.3 * np.random.default_rng(0)
         .standard_normal((2, 2400, 1))).astype(np.float32)
    jidx, jy = JaxTranscoder(
        jax.tree_util.tree_map(jnp.asarray, jparams), jcfg,
        voc=(jax.tree_util.tree_map(jnp.asarray, jvoc), jvcfg),
        stack="folded", dec_dtype=jnp.bfloat16)(x)
    calls = []
    real = fast.folded_residual_stack
    monkeypatch.setattr(fast, "folded_residual_stack",
                        lambda *a, **k: calls.append(
                            (a[0].shape[1], a[0].dtype, k.get("act", "elu")))
                        or real(*a, **k))
    tc = BatchTranscoder(params_from_jax(jparams), GeneratorConfig(**SMALL),
                         voc=(vocoder_params_from_jax(jvoc),
                              VocoderConfig(**vcfg)),
                         stack="folded",
                         dec_dtype=torch.bfloat16,
                         device="cpu")
    idx, y = tc(x)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert y.dtype == torch.float32 and y.shape == x.shape
    jy = np.asarray(jy)
    scale = float(np.max(np.abs(jy)))
    assert scale > 0.01
    rel = float(np.max(np.abs(y.numpy() - jy))) / scale
    assert rel < 3e-2, rel
    voc_calls = [cl for cl in calls if cl[2] == "leaky_relu"]
    assert sorted(voc_calls, key=lambda cl: -cl[0]) == \
        [(ch, torch.bfloat16, "leaky_relu")
         for ch in (32, 16, 8, 4) for _ in range(3)]
    assert folded_stack.mma_voc_launches == 0  # the CPU runs no kernel


@pytest.mark.parametrize("stack", ["plain", "folded"])
def test_batch_transcoder_with_vocoder_f32_matches_jax(stack):
    """The receiver in f32 (not mixed): gen_small's encoder and the grouped
    vocoder against the JAX transcoder.  stack="plain" against JAX
    stack="xla" with the encoder's batch fold off is true f32 on both
    sides: equal indices, waveform within f32 tolerance.  stack="folded"
    rounds the kernel stages' dot operands to bf16 on both sides, so the
    waveform is held at that class (as the mixed test above, 3e-2 of the
    peak)."""
    data = np.load(os.path.join(GOLDEN, "gen_small.npz"))
    sd = {k[len("sd__"):]: data[k] for k in data.files
          if k.startswith("sd__")}
    jcfg = JaxConfig(**SMALL)
    jparams = jax.tree_util.tree_map(np.asarray, import_autoencoder(sd, jcfg))
    vcfg = dict(FOLDED_CFGS["grouped"])
    jvcfg = jax_voc.VocoderConfig(**vcfg)
    jvoc = _random_jax_vocoder(jvcfg, seed=4)
    x = (0.3 * np.random.default_rng(0)
         .standard_normal((2, 2400, 1))).astype(np.float32)
    jkw = ({"stack": "xla", "encode_fold": False} if stack == "plain"
           else {"stack": "folded"})
    jidx, jy = JaxTranscoder(
        jax.tree_util.tree_map(jnp.asarray, jparams), jcfg,
        voc=(jax.tree_util.tree_map(jnp.asarray, jvoc), jvcfg), **jkw)(x)
    idx, y = BatchTranscoder(params_from_jax(jparams),
                             GeneratorConfig(**SMALL),
                             voc=(vocoder_params_from_jax(jvoc),
                                  VocoderConfig(**vcfg)),
                             stack=stack, device="cpu")(x)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    jy = np.asarray(jy)
    scale = float(np.max(np.abs(jy)))
    assert y.dtype == torch.float32 and scale > 0.01
    if stack == "plain":
        np.testing.assert_allclose(y.numpy(), jy, rtol=1e-4,
                                   atol=1e-5 * scale)
    else:
        assert float(np.max(np.abs(y.numpy() - jy))) / scale < 3e-2
