"""The port's vocoder training (`train/steps.py` `analyzer_codes`,
`make_vocoder_steps`; the weight-normed init; the reference importer with
fold=False) against the JAX package and the reference trainer's golden
(tests/golden/voc_train_step.npz): the analyzer's codes, one metric and one
adversarial step against JAX's jitted steps (one compile per step kind, in
a module-scoped fixture), and the reference's schedule with
tests/test_train_step_parity.py's bars.

Tolerances: codes within a relative 1e-5 of the largest entry; weights
carried or reparametrized within 1e-6; parameters after a step per leaf at
the parity test's bars (median |diff| <= 5e-7, q99 <= 5e-6, max <= 1.05 x
the learning-rate budget); records within a relative 1e-4; the stats
buffers and the analyzer bit-equal to their start.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodec_tpu.models import vocoder as jax_voc
from audiodec_tpu.models.discriminators import hifigan_discriminator_apply
from audiodec_tpu.ops import norms as jax_norms
from audiodec_tpu.train import steps as jax_steps
from audiodec_tpu.train.criterion import build_criterion as jax_criterion
from audiodec_tpu.train.optim import make_optimizer
from audiodec_tpu.utils.torch_import import (
    import_autoencoder,
    import_hifigan_discriminator,
    import_vocoder,
)
from audiodec_tpu_torch.models import discriminators as D
from audiodec_tpu_torch.models import vocoder as voc
from audiodec_tpu_torch.ops import norms
from audiodec_tpu_torch.train.criterion import build_criterion
from audiodec_tpu_torch.train.optim import tree_leaves
from audiodec_tpu_torch.train.steps import (
    analyzer_codes,
    is_buffer,
    make_vocoder_steps,
    train_state,
)
from audiodec_tpu_torch.utils import bridge
from tests.test_torch_train_step import (
    PORT_DISC_CFG,
    PORT_GEN_CFG,
    _bars,
    _close,
    _copy,
    _records_close,
)
from tests.test_train_step_parity import (
    DISC_CFG,
    GEN_CFG,
    VOC_CFG,
    VOC_CONFIG,
    _sub,
)

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

PORT_VOC_CFG = voc.VocoderConfig(
    in_channels=16, out_channels=1, channels=32, kernel_size=7,
    upsample_scales=(5, 5, 4, 3), upsample_kernel_sizes=(10, 10, 8, 6),
    resblock_kernel_sizes=(3,), resblock_dilations=((1, 3),), groups=2,
    stats=True)


@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(GOLDEN, "voc_train_step.npz"))


def _port_voc(data, key):
    return bridge.vocoder_params_from_reference_sd(_sub(data, key),
                                                   PORT_VOC_CFG, fold=False)


def _port_disc(data, key):
    return bridge.hifigan_disc_params_from_reference_sd(
        _sub(data, key), PORT_DISC_CFG, fold=False)


def _port_steps():
    return make_vocoder_steps(
        PORT_VOC_CFG, PORT_GEN_CFG,
        lambda p, x: D.hifigan_discriminator_apply(p, x, PORT_DISC_CFG),
        VOC_CONFIG, build_criterion(VOC_CONFIG))


def _batches(data):
    return data["x_all"].transpose(0, 1, 3, 2).copy()


def test_reference_import_keeps_weight_norm(golden):
    """fold=False keeps every weight-normed conv as {v, g, b}, transposed
    upsamples included, and gives JAX's import_vocoder(fold=False) through
    the bridge; fold=True gives the folded one."""
    sd = _sub(golden, "sd0_gen__")
    for fold in (False, True):
        ours = bridge.vocoder_params_to_jax(
            bridge.vocoder_params_from_reference_sd(sd, PORT_VOC_CFG,
                                                    fold=fold))
        theirs = dict(tree_leaves(_copy(import_vocoder(sd, VOC_CFG,
                                                       fold=fold))))
        ours = dict(tree_leaves(ours))
        assert sorted(ours) == sorted(theirs)
        for p in ours:
            np.testing.assert_allclose(ours[p], theirs[p], rtol=1e-6,
                                       atol=1e-7, err_msg=p)
    assert {"v", "g", "b"} <= set(_port_voc(golden, "sd0_gen__")
                                  ["upsamples"][0])


def test_weight_norm_tree_matches_jax_on_a_grouped_vocoder():
    """apply_weight_norm_tree on an AD v1 style vocoder (grouped fusion
    convs, transposed upsamples) against JAX's with its transposed_paths:
    the upsamples' preserved axis is their input channels, a grouped
    conv's its output channels."""
    cfg = voc.VocoderConfig(in_channels=16, channels=24, kernel_size=7,
                            upsample_scales=(5, 4, 3),
                            upsample_kernel_sizes=(10, 8, 6),
                            resblock_kernel_sizes=(11,),
                            resblock_dilations=((1, 3, 5),), groups=3,
                            stats=True)
    assert cfg.grouped
    jtree = bridge.vocoder_params_to_jax(
        voc.vocoder_init(cfg, torch.Generator().manual_seed(2)))
    tp = tuple(f"upsamples/{i}" for i in range(len(cfg.upsample_scales)))
    want = dict(tree_leaves(_copy(jax.jit(
        lambda t: jax_norms.apply_weight_norm_tree(
            t, transposed_paths=tp))(jtree))))
    port = norms.apply_weight_norm_tree(bridge.vocoder_params_from_jax(jtree))
    got = dict(tree_leaves(bridge.vocoder_params_to_jax(port)))
    assert sorted(got) == sorted(want)
    for p in got:
        np.testing.assert_allclose(got[p], want[p], rtol=1e-6, atol=1e-7,
                                   err_msg=p)
    assert port["upsamples"][0]["g"].shape == (24, 1, 1)
    assert want["upsamples/0/g"].shape == (1, 24, 1)


def test_stats_and_analyzer_are_buffers(golden):
    state = train_state(_port_voc(golden, "sd0_gen__"),
                        _port_disc(golden, "sd0_disc__"), VOC_CONFIG,
                        analyzer=bridge.params_from_reference_sd(
                            _sub(golden, "sd_analyzer__"), PORT_GEN_CFG))
    assert is_buffer("mean") and is_buffer("scale")
    assert "mean" not in state["gen_opt"].params
    assert "input_conv/v" in state["gen_opt"].params
    assert sorted(state) == ["analyzer", "disc", "disc_opt", "gen",
                             "gen_opt"]


def test_analyzer_codes_match_jax(golden):
    analyzer = _copy(import_autoencoder(_sub(golden, "sd_analyzer__"),
                                        GEN_CFG))
    x = _batches(golden)[1]
    want = jax.jit(lambda p, v: jax_steps.analyzer_codes(p, v, GEN_CFG))(
        analyzer, jnp.asarray(x))
    got = analyzer_codes(bridge.params_from_jax(analyzer),
                         torch.from_numpy(x), PORT_GEN_CFG)
    assert not got.requires_grad
    _close(got, want)


@pytest.fixture(scope="module")
def jax_two_steps(golden):
    """JAX's metric step on batch 1, then its adversarial step on batch 2,
    from the golden's init."""
    x = _batches(golden)
    analyzer = _copy(import_autoencoder(_sub(golden, "sd_analyzer__"),
                                        GEN_CFG))
    gen = _copy(import_vocoder(_sub(golden, "sd0_gen__"), VOC_CFG,
                               fold=False))
    disc = _copy(import_hifigan_discriminator(_sub(golden, "sd0_disc__"),
                                              DISC_CFG, fold=False))
    gen_opt = make_optimizer(VOC_CONFIG, "generator")
    disc_opt = make_optimizer(VOC_CONFIG, "discriminator")
    steps = jax_steps.make_vocoder_steps(
        VOC_CFG, GEN_CFG, lambda p, v: hifigan_discriminator_apply(
            p, v, DISC_CFG), VOC_CONFIG, jax_criterion(VOC_CONFIG),
        gen_opt, disc_opt, jit=True)
    state = {"gen": gen, "disc": disc, "analyzer": analyzer,
             "gen_opt": gen_opt.init(gen), "disc_opt": disc_opt.init(disc)}
    state, rec_m = steps["metric"](state, jnp.asarray(x[1]))
    after_metric = _copy(state["gen"]), _copy(rec_m)
    state, rec_a = steps["adv"](state, jnp.asarray(x[2]))
    rec_e = steps["eval"](state, jnp.asarray(x[3]))
    return after_metric, (_copy(state["gen"]), _copy(state["disc"]),
                          _copy(rec_a), _copy(rec_e))


def test_metric_adv_and_eval_steps_match_jax(golden, jax_two_steps):
    (gen_m, rec_m), (gen_a, disc_a, rec_a, rec_e) = jax_two_steps
    x = torch.from_numpy(_batches(golden))
    state = train_state(_port_voc(golden, "sd0_gen__"),
                        _port_disc(golden, "sd0_disc__"), VOC_CONFIG,
                        analyzer=bridge.params_from_reference_sd(
                            _sub(golden, "sd_analyzer__"), PORT_GEN_CFG))
    steps = _port_steps()
    state, rec = steps["metric"](state, x[1])
    _records_close(rec, rec_m)
    _bars(bridge.vocoder_params_to_jax(state["gen"]), gen_m, 2 * 1e-4,
          "metric:")
    state, rec = steps["adv"](state, x[2])
    _records_close(rec, rec_a)
    _bars(bridge.vocoder_params_to_jax(state["gen"]), gen_a,
          2 * (1e-4 + 5e-5), "adv:gen:")
    _bars(bridge.disc_params_to_jax(state["disc"]), disc_a, 2 * 2e-4,
          "adv:disc:")
    _records_close(steps["eval"](state, x[3]), rec_e)


def test_golden_schedule_meets_parity_bars(golden):
    """The reference's schedule without its no-op first step (the `>`
    gate at step 0): metric on batch 1, adversarial on batches 2 and 3
    (gen StepLR(1) halving every update, disc MultiStepLR halving between
    its two), against the reference trainer's parameters."""
    analyzer = bridge.params_from_reference_sd(_sub(golden, "sd_analyzer__"),
                                               PORT_GEN_CFG)
    an0 = {p: t.clone() for p, t in tree_leaves(analyzer)}
    gen = _port_voc(golden, "sd0_gen__")
    stats0 = gen["mean"].clone(), gen["scale"].clone()
    state = train_state(gen, _port_disc(golden, "sd0_disc__"), VOC_CONFIG,
                        analyzer=analyzer)
    steps = _port_steps()
    x = torch.from_numpy(_batches(golden))
    state, rec = steps["metric"](state, x[1])
    assert np.isfinite(float(rec["generator_loss"]))
    _bars(state["gen"], _port_voc(golden, "sdm_gen__"), 2 * 1e-4,
          "voc:metric:")
    for i in (2, 3):
        state, rec = steps["adv"](state, x[i])
        assert np.isfinite(float(rec["generator_loss"]))
        assert np.isfinite(float(rec["discriminator_loss"]))
    _bars(state["gen"], _port_voc(golden, "sda_gen__"),
          2 * (1e-4 + 5e-5 + 2.5e-5), "voc:adv:gen:")
    _bars(state["disc"], _port_disc(golden, "sda_disc__"),
          2 * (2e-4 + 1e-4), "voc:adv:disc:")
    assert torch.equal(state["gen"]["mean"], stats0[0])
    assert torch.equal(state["gen"]["scale"], stats0[1])
    np.testing.assert_array_equal(state["gen"]["mean"].numpy(),
                                  golden["sd0_gen__mean"])
    for p, t in tree_leaves(state["analyzer"]):
        assert torch.equal(t, an0[p]), p
    start = _port_voc(golden, "sd0_gen__")
    assert float(torch.max(torch.abs(state["gen"]["input_conv"]["v"].detach()
                                     - start["input_conv"]["v"]))) > 1e-7
