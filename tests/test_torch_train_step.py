"""The port's training forward and steps against the JAX package and the
reference trainer's golden: `rvq_forward` with its EMA update, the
projector's train-mode BN, `generator_forward`, one metric and one
adversarial step against JAX's jitted `make_autoencoder_steps` (one compile
per step kind, in module-scoped fixtures), and the reference's 3 + 2 step
schedule (tests/golden/train_step.npz) with tests/test_train_step_parity.py's
bars.

Tolerances: forward values and EMA buffers within a relative 1e-5 of the
largest entry (the golden BN keys at the JAX test's own rtol/atol);
parameters after a step per leaf at the parity test's bars (median |diff|
<= 5e-7, q99 <= 5e-6, max <= 1.05 x the learning-rate budget: Adam's first
update is +-lr sign(g), so a near-zero gradient may flip one element);
records within a relative 1e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodec_tpu.models import autoencoder as jax_ae
from audiodec_tpu.models.discriminators import hifigan_discriminator_apply
from audiodec_tpu.ops import vq as jax_vq
from audiodec_tpu.train.criterion import build_criterion as jax_criterion
from audiodec_tpu.train.optim import make_optimizer
from audiodec_tpu.train.steps import make_autoencoder_steps as jax_steps
from audiodec_tpu.utils.torch_import import (
    import_autoencoder,
    import_hifigan_discriminator,
)
from audiodec_tpu_torch.models import autoencoder as ae
from audiodec_tpu_torch.models import discriminators as D
from audiodec_tpu_torch.ops import vq
from audiodec_tpu_torch.train.criterion import build_criterion
from audiodec_tpu_torch.train.optim import Optimizer, tree_leaves
from audiodec_tpu_torch.train.steps import make_autoencoder_steps, train_state
from audiodec_tpu_torch.utils import bridge
from tests.test_train_step_parity import CONFIG, DISC_CFG, GEN_CFG, _sub

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

PORT_GEN_CFG = ae.GeneratorConfig(encode_channels=4, decode_channels=4,
                                  code_dim=16, codebook_num=4,
                                  codebook_size=32)
PORT_DISC_CFG = D.HiFiGANDiscriminatorConfig(
    msd=D.MultiScaleConfig(scales=2, follow_official_norm=False,
                           discriminator=D.ScaleDiscriminatorConfig(
                               channels=16, max_downsample_channels=32,
                               max_groups=4)),
    mpd=D.MultiPeriodConfig(periods=(2, 3),
                            discriminator=D.PeriodDiscriminatorConfig(
                                channels=4, max_downsample_channels=16)))
BN_CFG = dict(projector="conv1d_bn")


def _np(t):
    return np.asarray(t.detach().cpu() if torch.is_tensor(t) else t,
                      np.float64)


def _close(got, want, rtol=1e-5, label=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, label
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=label)


def _bars(ours: dict, ref: dict, lr_budget: float, label: str):
    """tests/test_train_step_parity.py `_tree_close`, by path."""
    ours, ref = dict(tree_leaves(ours)), dict(tree_leaves(ref))
    assert sorted(ours) == sorted(ref), label
    for path in ours:
        d = np.abs(_np(ours[path]) - _np(ref[path]))
        assert float(np.median(d)) <= 5e-7, f"{label}{path}: median"
        assert float(np.quantile(d, 0.99)) <= 5e-6, f"{label}{path}: q99"
        assert float(d.max()) <= 1.05 * lr_budget, f"{label}{path}: max"


def _records_close(ours: dict, theirs: dict):
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        _close(ours[k], theirs[k], rtol=1e-4, label=k)


# ---------------------------------------------------------------------------
# the training forward
# ---------------------------------------------------------------------------

def _rvq_case(seed):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((2, 7, 16)).astype(np.float32)
    embed = rng.standard_normal((4, 32, 16)).astype(np.float32)
    params = {"embed": embed,
              "cluster_size": rng.uniform(0, 3, (4, 32)).astype(np.float32),
              "embed_avg": (embed * 1.5).astype(np.float32)}
    return z, params


@pytest.mark.parametrize("train", [True, False])
def test_rvq_forward_matches_jax(train):
    """zq, the per-layer losses, the perplexities, the EMA buffers, and
    the gradient through the straight-through estimator to z."""
    z, params = _rvq_case(1)
    w = np.random.default_rng(2).standard_normal(z.shape).astype(np.float32)

    @jax.jit
    def jax_side(zz):
        def f(v):
            zq, loss, ppl, new = jax_vq.rvq_forward(v, params, train=train)
            return jnp.sum(zq * w) + jnp.sum(loss), (zq, loss, ppl, new)
        return jax.value_and_grad(f, has_aux=True)(zz)

    (_, want), grad = jax_side(jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_(True)
    got = vq.rvq_forward(zt, bridge.tree_map(torch.from_numpy, params),
                         train=train)
    (torch.sum(got[0] * torch.from_numpy(w)) + torch.sum(got[1])).backward()
    for name, g, t in zip(("zq", "loss", "ppl"), got[:3], want[:3]):
        _close(g, t, label=name)
    for k in ("embed", "cluster_size", "embed_avg"):
        _close(got[3][k], want[3][k], label=k)
    _close(zt.grad, grad, label="grad")


def test_projector_train_bn_matches_jax():
    """Batch-stat BN and the running-stat update (mean, unbiased var,
    count) of the conv1d_bn projector."""
    cfg = jax_ae.GeneratorConfig(encode_channels=4, code_dim=16, **BN_CFG)
    rng = np.random.default_rng(3)
    p = {"conv": {"w": (0.1 * rng.standard_normal((3, 64, 16))
                        ).astype(np.float32)},
         "bn": {"scale": rng.uniform(0.5, 1.5, 16).astype(np.float32),
                "bias": rng.standard_normal(16).astype(np.float32),
                "mean": rng.standard_normal(16).astype(np.float32),
                "var": rng.uniform(0.5, 2, 16).astype(np.float32),
                "count": np.float32(3)}}
    h = rng.standard_normal((2, 9, 64)).astype(np.float32)
    want_z, want_bn = jax.jit(lambda pp, x: jax_ae.projector_apply(
        pp, x, cfg, train=True))(p, jnp.asarray(h))
    port_p = {"conv": bridge._conv_from_jax(p["conv"]),
              "bn": {k: torch.as_tensor(np.asarray(v))
                     for k, v in p["bn"].items()}}
    z, bn = ae.projector_apply(port_p, torch.from_numpy(h),
                               ae.GeneratorConfig(encode_channels=4,
                                                  code_dim=16, **BN_CFG),
                               train=True)
    _close(z, want_z)
    for k in ("mean", "var", "count"):
        _close(bn[k], want_bn[k], label=k)


def test_generator_forward_matches_bn_golden():
    """gen_symad_bn: eval and train forward (the *_train keys), then the
    merged buffers against the reference's post-step state dict, at
    tests/test_generator_parity.py's tolerances."""
    data = np.load(os.path.join(GOLDEN, "gen_symad_bn.npz"))
    cfg = ae.GeneratorConfig(encode_channels=4, decode_channels=4,
                             code_dim=16, codebook_num=4, codebook_size=32,
                             **BN_CFG)
    params = bridge.params_from_reference_sd(_sub(data, "sd__"), cfg)
    x = torch.from_numpy(data["x"].transpose(0, 2, 1).copy())
    for train, sfx in ((False, ""), (True, "_train")):
        y, zq, z, vqloss, _, new_buf = ae.generator_forward(params, x, cfg,
                                                            train=train)
        np.testing.assert_allclose(_np(z).transpose(0, 2, 1),
                                   data["z" + sfx], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(_np(y).transpose(0, 2, 1),
                                   data["y" + sfx], rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(_np(vqloss), data["vqloss" + sfx],
                                   rtol=1e-3, atol=1e-5)
    merged = ae.merge_forward_buffers(params, new_buf)
    bn, pre = merged["projector"]["bn"], "sd1__projector.project.1."
    np.testing.assert_allclose(_np(bn["mean"]), data[pre + "running_mean"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(bn["var"]), data[pre + "running_var"],
                               rtol=1e-5, atol=1e-6)
    assert int(bn["count"]) == int(data[pre + "num_batches_tracked"])
    for q in range(cfg.codebook_num):
        np.testing.assert_allclose(
            _np(merged["quantizer"]["embed"][q]),
            data[f"sd1__quantizer.codebook.layers.{q}.embed"].T,
            rtol=1e-4, atol=1e-5, err_msg=f"codebook {q}")


# ---------------------------------------------------------------------------
# the steps against JAX's, jitted
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(GOLDEN, "train_step.npz"))


def _copy(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _jax_state(gen, disc, config):
    gen_opt = make_optimizer(config, "generator")
    disc_opt = make_optimizer(config, "discriminator")
    return gen_opt, disc_opt, {"gen": gen, "disc": disc,
                               "gen_opt": gen_opt.init(gen),
                               "disc_opt": disc_opt.init(disc)}


def _port(gen_jax, disc_jax, config, cfg=PORT_GEN_CFG):
    state = train_state(bridge.params_from_jax(_copy(gen_jax)),
                        bridge.disc_params_from_jax(_copy(disc_jax)), config)
    steps = make_autoencoder_steps(
        cfg, lambda p, x: D.hifigan_discriminator_apply(p, x, PORT_DISC_CFG),
        config, build_criterion(config))
    return state, steps


@pytest.fixture(scope="module")
def jax_two_steps(golden):
    """JAX's metric step on batch 0, then its adversarial step on batch 3,
    from the golden's init."""
    x = golden["x_all"].transpose(0, 1, 3, 2)
    gen = _copy(import_autoencoder(_sub(golden, "sd0_gen__"), GEN_CFG))
    disc = _copy(import_hifigan_discriminator(_sub(golden, "sd0_disc__"),
                                              DISC_CFG, fold=False))
    gen_opt, disc_opt, state = _jax_state(gen, disc, CONFIG)
    steps = jax_steps(GEN_CFG, lambda p, v: hifigan_discriminator_apply(
        p, v, DISC_CFG), CONFIG, jax_criterion(CONFIG), gen_opt, disc_opt,
        jit=True)
    state, rec_m = steps["metric"](state, jnp.asarray(x[0]))
    after_metric = _copy(state["gen"]), _copy(rec_m)
    state, rec_a = steps["adv"](state, jnp.asarray(x[3]))
    return (gen, disc, x, after_metric,
            (_copy(state["gen"]), _copy(state["disc"]), _copy(rec_a)))


def test_metric_then_adv_step_match_jax(jax_two_steps):
    gen, disc, x, (gen_m, rec_m), (gen_a, disc_a, rec_a) = jax_two_steps
    state, steps = _port(gen, disc, CONFIG)
    state, rec = steps["metric"](state, torch.from_numpy(x[0].copy()))
    _records_close(rec, rec_m)
    _bars(bridge.params_to_jax(state["gen"]), gen_m, 2 * 1e-4, "metric:")
    state, rec = steps["adv"](state, torch.from_numpy(x[3].copy()))
    _records_close(rec, rec_a)
    _bars(bridge.params_to_jax(state["gen"]), gen_a, 2 * 2e-4, "adv:gen:")
    _bars(bridge.disc_params_to_jax(state["disc"]), disc_a, 2 * 2e-4,
          "adv:disc:")


def test_adv_step_with_bn_projector_matches_jax():
    """A BN projector stays in train mode through the frozen adversarial
    stage and advances twice per step (the generator's forward, then the
    recomputed y_): against JAX's adversarial step on gen_symad_bn's
    weights, with a seeded discriminator."""
    data = np.load(os.path.join(GOLDEN, "gen_symad_bn.npz"))
    jcfg = jax_ae.GeneratorConfig(encode_channels=4, decode_channels=4,
                                  code_dim=16, codebook_num=4,
                                  codebook_size=32, **BN_CFG)
    gen = _copy(import_autoencoder(_sub(data, "sd__"), jcfg))
    disc = bridge.disc_params_to_jax(D.hifigan_discriminator_init(
        torch.Generator().manual_seed(4), PORT_DISC_CFG))
    x = data["x"].transpose(0, 2, 1).copy()
    gen_opt, disc_opt, jstate = _jax_state(gen, disc, CONFIG)
    adv = jax_steps(jcfg, lambda p, v: hifigan_discriminator_apply(
        p, v, DISC_CFG), CONFIG, jax_criterion(CONFIG), gen_opt, disc_opt,
        jit=True)["adv"]
    jstate, jrec = adv(jstate, jnp.asarray(x))

    state, steps = _port(gen, disc, CONFIG,
                         ae.GeneratorConfig(encode_channels=4,
                                            decode_channels=4, code_dim=16,
                                            codebook_num=4, codebook_size=32,
                                            **BN_CFG))
    state, rec = steps["adv"](state, torch.from_numpy(x))
    _records_close(rec, _copy(jrec))
    assert int(state["gen"]["projector"]["bn"]["count"]) == int(
        gen["projector"]["bn"]["count"]) + 2
    ours = bridge.params_to_jax(state["gen"])
    for k in ("mean", "var", "count"):
        _close(ours["projector"]["bn"][k],
               np.asarray(jstate["gen"]["projector"]["bn"][k]), label=k)
    _bars(ours, _copy(jstate["gen"]), 2 * 1e-4, "bn:adv:gen:")
    _bars(bridge.disc_params_to_jax(state["disc"]), _copy(jstate["disc"]),
          2 * 2e-4, "bn:adv:disc:")


# ---------------------------------------------------------------------------
# the reference trainer's schedule
# ---------------------------------------------------------------------------

def test_golden_schedule_meets_parity_bars(golden):
    """3 metric steps, then 2 adversarial steps, from the golden's init
    (gen StepLR halving mid-run, disc MultiStepLR halving between the
    adversarial steps), against the reference trainer's parameters."""
    gen = bridge.params_from_reference_sd(_sub(golden, "sd0_gen__"),
                                          PORT_GEN_CFG)
    disc = bridge.hifigan_disc_params_from_reference_sd(
        _sub(golden, "sd0_disc__"), PORT_DISC_CFG, fold=False)
    state = train_state(gen, disc, CONFIG)
    steps = make_autoencoder_steps(
        PORT_GEN_CFG,
        lambda p, x: D.hifigan_discriminator_apply(p, x, PORT_DISC_CFG),
        CONFIG, build_criterion(CONFIG))
    x_all = torch.from_numpy(golden["x_all"].transpose(0, 1, 3, 2).copy())
    n_metric, n_adv = int(golden["n_metric"]), int(golden["n_adv"])
    for i in range(n_metric):
        state, rec = steps["metric"](state, x_all[i])
        assert np.isfinite(float(rec["generator_loss"]))

    def ref_gen(key):
        return bridge.params_from_reference_sd(_sub(golden, key),
                                               PORT_GEN_CFG)

    _bars(state["gen"], ref_gen("sdm_gen__"), 3 * 1e-4, "metric:gen:")
    codebook = state["gen"]["quantizer"]["embed"].clone()
    for i in range(n_metric, n_metric + n_adv):
        state, rec = steps["adv"](state, x_all[i])
        assert np.isfinite(float(rec["generator_loss"]))
        assert np.isfinite(float(rec["discriminator_loss"]))
    ref_a = ref_gen("sda_gen__")
    for sub in ("encoder", "projector"):
        _bars({sub: state["gen"][sub]}, {sub: ref_a[sub]}, 3 * 1e-4,
              "adv:frozen:")
    np.testing.assert_allclose(_np(state["gen"]["quantizer"]["embed"]),
                               _np(ref_a["quantizer"]["embed"]), rtol=1e-4,
                               atol=1e-5)
    assert torch.equal(state["gen"]["quantizer"]["embed"], codebook)
    _bars({"decoder": state["gen"]["decoder"]},
          {"decoder": ref_a["decoder"]}, 3 * 1e-4 + 2 * 5e-5, "adv:gen:")
    ref_d = bridge.hifigan_disc_params_from_reference_sd(
        _sub(golden, "sda_disc__"), PORT_DISC_CFG, fold=False)
    _bars(state["disc"], ref_d, 2e-4 + 1e-4, "adv:disc:")
    d0 = bridge.hifigan_disc_params_from_reference_sd(
        _sub(golden, "sd0_disc__"), PORT_DISC_CFG, fold=False)
    w = ("msd", "discriminators", 0, "layers", 0, "w")
    moved, start = state["disc"], d0
    for k in w:
        moved, start = moved[k], start[k]
    assert float(torch.max(torch.abs(moved.detach() - start))) > 1e-6


# ---------------------------------------------------------------------------
# the optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("role,sched", [
    ("generator", {"generator_scheduler_type": "StepLR",
                   "generator_scheduler_params": {"step_size": 2,
                                                  "gamma": 0.5}}),
    ("discriminator", {"discriminator_scheduler_type": "MultiStepLR",
                       "discriminator_scheduler_params": {
                           "milestones": [1, 3], "gamma": 0.5}}),
    ("generator", {"generator_scheduler_type": "ExponentialLR",
                   "generator_scheduler_params": {"gamma": 0.9},
                   "generator_optimizer_type": "AdamW",
                   "generator_optimizer_params": {"lr": 1e-3,
                                                  "weight_decay": 0.1},
                   "generator_grad_norm": 0.5}),
])
def test_optimizer_steps_match_optax(role, sched):
    """Four updates of Adam / AdamW with the schedule and clipping, against
    the JAX package's optax rebuild of the same config."""
    import optax

    config = dict(CONFIG, **sched)
    rng = np.random.default_rng(5)
    p0 = {"w": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal(4).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(4)]
    tx = make_optimizer(config, role)
    jp, js = p0, tx.init(p0)
    for g in grads:
        upd, js = tx.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
    params = {k: torch.tensor(v) for k, v in p0.items()}
    opt = Optimizer(config, role, tree_leaves(params))
    for g in grads:
        loss = sum(torch.sum(params[k] * torch.from_numpy(g[k]))
                   for k in params)
        opt.step(loss)
    for k in params:
        _close(params[k], jp[k], rtol=2e-6, label=k)
