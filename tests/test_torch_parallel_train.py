"""Data-parallel training of the port (`rvq_forward(axis_name=)`, the three
`make_*_steps(axis_name=)`, `shard_steps`, `Optimizer.step(axis=)`) in two
gloo ranks against JAX's `shard_steps` over a 2-device data mesh.

The port's side runs once, in two ranks that bin/multihost_probe.py's
`train_cases` worker starts (they import torch and the port only); JAX's
side runs here on conftest's virtual devices, one compile per step kind in
a module fixture.  Inputs are the reference goldens' weights and batches
(B = 2, one row per rank).

Bars: the RVQ's codebooks, counts and perplexities within a relative 1e-5
of the largest entry, its zq to 1e-6; params after a step per leaf at
tests/test_parallel_fullsize.py's bars (median |diff| <= 5e-7, q99 <=
5e-6, max <= 1.05 x the learning-rate budget: Adam's first update is
+-lr sign(g)); records within a relative 1e-4; a BN projector's running
statistics per rank, each to its JAX device's (JAX keeps them per device)
within 1e-5; the data-parallel step within the same bars of the port's
single-rank step on the whole batch.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from audiodec_tpu.models import autoencoder as jax_ae
from audiodec_tpu.models.discriminators import hifigan_discriminator_apply
from audiodec_tpu.ops import vq as jax_vq
from audiodec_tpu.parallel import make_mesh
from audiodec_tpu.train import steps as jax_steps
from audiodec_tpu.train.criterion import build_criterion as jax_criterion
from audiodec_tpu.train.optim import make_optimizer
from audiodec_tpu.utils.torch_import import (
    import_autoencoder,
    import_hifigan_discriminator,
    import_vocoder,
)
from audiodec_tpu_torch.bin.multihost_probe import run_ranks
from audiodec_tpu_torch.models import autoencoder as ae
from audiodec_tpu_torch.models import discriminators as D
from audiodec_tpu_torch.train.criterion import build_criterion
from audiodec_tpu_torch.train.optim import tree_leaves
from audiodec_tpu_torch.train.steps import (
    make_autoencoder_steps,
    make_vocoder_steps,
    train_state,
)
from audiodec_tpu_torch.utils import bridge
from tests.test_torch_train_step import (
    BN_CFG,
    PORT_DISC_CFG,
    PORT_GEN_CFG,
    _bars,
    _close,
    _copy,
    _np,
    _records_close,
)
from tests.test_torch_voc_train import PORT_VOC_CFG
from tests.test_train_step_parity import (
    CONFIG,
    DEN_CONFIG,
    DISC_CFG,
    GEN_CFG,
    VOC_CFG,
    VOC_CONFIG,
    _sub,
)

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
JAX_BN_CFG = jax_ae.GeneratorConfig(encode_channels=4, decode_channels=4,
                                    code_dim=16, codebook_num=4,
                                    codebook_size=32, **BN_CFG)
PORT_BN_CFG = ae.GeneratorConfig(encode_channels=4, decode_channels=4,
                                 code_dim=16, codebook_num=4,
                                 codebook_size=32, **BN_CFG)
GEN_LR, DISC_LR = 1e-4, 2e-4


def _golden(name):
    return np.load(os.path.join(GOLDEN, f"{name}.npz"))


def _bct(a):
    return a.transpose(0, 2, 1).copy()


def _inputs():
    """The cases' weights (JAX trees) and global batches."""
    bn = _golden("gen_symad_bn")
    voc = _golden("voc_train_step")
    den = _golden("denoise_train_step")
    rng = np.random.default_rng(5)
    ae_disc = bridge.disc_params_to_jax(D.hifigan_discriminator_init(
        torch.Generator().manual_seed(4), PORT_DISC_CFG))
    x_voc = voc["x_all"].transpose(0, 1, 3, 2)
    return {
        "ae": {"gen": _copy(import_autoencoder(_sub(bn, "sd__"),
                                               JAX_BN_CFG)),
               "disc": ae_disc,
               "x": [_bct(bn["x"]),
                     (0.1 * rng.standard_normal((2, 1800, 1))).astype(
                         np.float32)]},
        "voc": {"gen": _copy(import_vocoder(_sub(voc, "sd0_gen__"), VOC_CFG,
                                            fold=False)),
                "disc": _copy(import_hifigan_discriminator(
                    _sub(voc, "sd0_disc__"), DISC_CFG, fold=False)),
                "analyzer": _copy(import_autoencoder(
                    _sub(voc, "sd_analyzer__"), GEN_CFG)),
                "x": [x_voc[1].copy(), x_voc[2].copy()]},
        "den": {"gen": _copy(import_autoencoder(_sub(den, "sd0_gen__"),
                                                GEN_CFG)),
                "x": (den["x_noisy"][0].transpose(0, 2, 1).copy(),
                      den["x_clean"][0].transpose(0, 2, 1).copy())},
        "rvq": {"z": rng.standard_normal((4, 7, 16)).astype(np.float32),
                "embed": rng.standard_normal((4, 32, 16)).astype(np.float32),
                "cluster_size": rng.uniform(0, 3, (4, 32)).astype(
                    np.float32)},
    }


# ---------------------------------------------------------------------------
# the port, in two ranks
# ---------------------------------------------------------------------------

def _port_cases(inp) -> list:
    a, v, d, r = inp["ae"], inp["voc"], inp["den"], inp["rvq"]
    rvq_params = {"embed": torch.from_numpy(r["embed"]),
                  "cluster_size": torch.from_numpy(r["cluster_size"]),
                  "embed_avg": torch.from_numpy(1.5 * r["embed"])}
    ae_case = dict(kind="autoencoder", config=CONFIG, gen_cfg=PORT_BN_CFG,
                   disc_cfg=PORT_DISC_CFG,
                   gen=bridge.params_from_jax(a["gen"]),
                   disc=bridge.disc_params_from_jax(a["disc"]))
    voc_case = dict(kind="vocoder", config=VOC_CONFIG, gen_cfg=PORT_VOC_CFG,
                    an_cfg=PORT_GEN_CFG, disc_cfg=PORT_DISC_CFG,
                    gen=bridge.vocoder_params_from_jax(v["gen"]),
                    disc=bridge.disc_params_from_jax(v["disc"]),
                    analyzer=bridge.params_from_jax(v["analyzer"]))
    return [
        dict(name="rvq", kind="rvq", z=r["z"], params=rvq_params),
        dict(ae_case, name="ae_metric", steps=["metric"],
             batches=[(a["x"][0],)]),
        dict(ae_case, name="ae_adv", steps=["metric", "adv"],
             batches=[(a["x"][0],), (a["x"][1],)]),
        dict(voc_case, name="voc_metric", steps=["metric"],
             batches=[(v["x"][0],)]),
        dict(voc_case, name="voc_adv", steps=["adv"],
             batches=[(v["x"][1],)]),
        dict(voc_case, name="voc_chain", steps=["metric", "adv"],
             batches=[(v["x"][0],), (v["x"][1],)]),
        dict(voc_case, name="voc_chain_f64", steps=["metric", "adv"],
             batches=[(v["x"][0],), (v["x"][1],)], dtype="float64"),
        dict(kind="denoise", name="den", config=DEN_CONFIG,
             gen_cfg=PORT_GEN_CFG, gen=bridge.params_from_jax(d["gen"]),
             steps=["train"], batches=[d["x"]]),
        dict(kind="autoencoder", name="plain_metric", config=CONFIG,
             gen_cfg=PORT_GEN_CFG, disc_cfg=PORT_DISC_CFG,
             gen=bridge.params_from_jax(d["gen"]),
             disc=bridge.disc_params_from_jax(v["disc"]), steps=["metric"],
             batches=[(_plain_batch(),)]),
    ]


def _plain_batch():
    return _bct(_golden("train_step")["x_all"][0])


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def port(inputs, tmp_path_factory):
    """The port's cases in two gloo ranks -> [rank 0's, rank 1's] results."""
    root = tmp_path_factory.mktemp("dp_train")
    torch.save({"cases": _port_cases(inputs)}, root / "in.pt")
    run_ranks(2, ["--worker", "train_cases", "--in", str(root / "in.pt"),
                  "--out", str(root), "--device", "cpu", "--threads", "1"],
              timeout=300)
    return [torch.load(root / f"rank{i}.pt", weights_only=False)
            for i in range(2)]


# ---------------------------------------------------------------------------
# JAX, on a 2-device data mesh
# ---------------------------------------------------------------------------

def _per_device_bn(state):
    bn = state["gen"]["projector"]["bn"]
    return [{k: np.asarray(bn[k].addressable_shards[i].data)
             for k in ("mean", "var")} for i in range(2)]


def _dp(steps):
    return jax_steps.shard_steps(steps, make_mesh(data=2), "data")


def _opt_state(config, gen, disc=None):
    gen_opt = make_optimizer(config, "generator")
    disc_opt = make_optimizer(config, "discriminator")
    state = {"gen": gen, "gen_opt": gen_opt.init(gen)}
    if disc is not None:
        state.update(disc=disc, disc_opt=disc_opt.init(disc))
    return gen_opt, disc_opt, state


@pytest.fixture(scope="module")
def jax_ae_runs(inputs):
    """JAX's data-parallel metric step, then its adversarial step, on the
    BN projector's weights."""
    a = inputs["ae"]
    gen_opt, disc_opt, state = _opt_state(CONFIG, a["gen"], a["disc"])
    steps = _dp(jax_steps.make_autoencoder_steps(
        JAX_BN_CFG, lambda p, v: hifigan_discriminator_apply(p, v, DISC_CFG),
        CONFIG, jax_criterion(CONFIG), gen_opt, disc_opt, axis_name="data",
        jit=False))
    state, rec_m = steps["metric"](state, jnp.asarray(a["x"][0]))
    after_metric = (_copy(state["gen"]), _copy(rec_m), _per_device_bn(state))
    state, rec_a = steps["adv"](state, jnp.asarray(a["x"][1]))
    return {"metric": after_metric,
            "adv": (_copy(state["gen"]), _copy(rec_a), _per_device_bn(state),
                    _copy(state["disc"]))}


def _jax_voc_steps(inputs, dp: bool):
    v = inputs["voc"]
    gen_opt, disc_opt, state = _opt_state(VOC_CONFIG, v["gen"], v["disc"])
    state["analyzer"] = v["analyzer"]
    steps = jax_steps.make_vocoder_steps(
        VOC_CFG, GEN_CFG, lambda p, x: hifigan_discriminator_apply(
            p, x, DISC_CFG), VOC_CONFIG, jax_criterion(VOC_CONFIG), gen_opt,
        disc_opt, axis_name="data" if dp else None, jit=not dp)
    return (_dp(steps) if dp else steps), state


@pytest.fixture(scope="module")
def jax_voc_runs(inputs):
    """JAX's data-parallel metric step and its adversarial step, each from
    the golden's init, and the chain of the two (see
    test_vocoder_chain_rounding_witness)."""
    x = [jnp.asarray(b) for b in inputs["voc"]["x"]]
    steps, state = _jax_voc_steps(inputs, dp=True)
    after_metric, rec_m = steps["metric"](state, x[0])
    after_adv, rec_a = steps["adv"](state, x[1])
    chained, _ = steps["adv"](after_metric, x[1])
    return {"metric": (_copy(after_metric["gen"]), _copy(rec_m)),
            "adv": (_copy(after_adv["gen"]), _copy(rec_a),
                    _copy(after_adv["disc"])),
            "chain": _copy(chained["gen"])}


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def test_rvq_forward_reduces_over_the_data_axis(inputs, port):
    """The EMA counts and sums psum'd, the probabilities pmean'd: every
    rank's codebooks and perplexities are JAX's under shard_map."""
    r = inputs["rvq"]
    params = {"embed": r["embed"], "cluster_size": r["cluster_size"],
              "embed_avg": 1.5 * r["embed"]}

    def local(z, p):
        zq, loss, ppl, new = jax_vq.rvq_forward(z, p, train=True,
                                                axis_name="data")
        return zq, loss[None], ppl, new

    zq, loss, ppl, new = jax.jit(shard_map(
        local, mesh=make_mesh(data=2),
        in_specs=(P("data"), P()), out_specs=(P("data"), P("data"), P(),
                                              P()),
        check_vma=False))(jnp.asarray(r["z"]), params)
    for rank in range(2):
        got = port[rank]["rvq"]
        np.testing.assert_allclose(got["zq"], np.asarray(zq)[2 * rank:
                                                             2 * rank + 2],
                                   rtol=1e-6, atol=1e-6)
        _close(got["loss"], np.asarray(loss)[rank], label="loss")
        _close(got["ppl"], ppl, label="ppl")
        for k in ("embed", "cluster_size", "embed_avg"):
            _close(got["new"][k], new[k], label=k)
    # a rank's rows alone would give other statistics
    assert not np.allclose(port[0]["rvq"]["new"]["cluster_size"],
                           np.asarray(jax.jit(lambda z: jax_vq.rvq_forward(
                               z, params, train=True)[3]["cluster_size"])(
                               jnp.asarray(r["z"][:2]))))


def _gen_tree(got, kind):
    to_jax = (bridge.vocoder_params_to_jax if kind == "voc"
              else bridge.params_to_jax)
    return to_jax(bridge.tree_map(torch.from_numpy, got))


def _without_bn_stats(tree):
    out = dict(tree_leaves(tree))
    return {k: v for k, v in out.items()
            if not k.endswith(("bn/mean", "bn/var"))}


@pytest.mark.parametrize("step", ["metric", "adv"])
def test_autoencoder_steps_match_jax_shard_steps(port, jax_ae_runs, step):
    want = jax_ae_runs[step]
    budget = 2 * GEN_LR if step == "metric" else 2 * 2 * GEN_LR
    for rank in range(2):
        got = port[rank][f"ae_{step}"]
        _records_close(got["records"][-1], want[1])
        _bars(_without_bn_stats(_gen_tree(got["gen"], "ae")),
              _without_bn_stats(want[0]), budget, f"{step}:rank{rank}:")
    if step == "adv":
        disc = bridge.disc_params_to_jax(bridge.tree_map(
            torch.from_numpy, port[0]["ae_adv"]["disc"]))
        _bars(disc, want[3], 2 * DISC_LR, "adv:disc:")


@pytest.mark.parametrize("step", ["metric", "adv"])
def test_bn_running_stats_stay_per_rank(port, jax_ae_runs, step):
    """Each rank keeps the running statistics of its own rows, JAX's
    device for device (its shard_map returns them unreduced); the count
    is every rank's."""
    want = jax_ae_runs[step][2]
    ranks = [port[r][f"ae_{step}"]["gen"]["projector"]["bn"]
             for r in range(2)]
    for rank in range(2):
        for k in ("mean", "var"):
            _close(ranks[rank][k], want[rank][k], label=f"{k}:{rank}")
    assert not np.allclose(ranks[0]["mean"], ranks[1]["mean"])
    start = float(_golden("gen_symad_bn")["sd__projector.project.1."
                                          "num_batches_tracked"])
    assert float(ranks[0]["count"]) == float(ranks[1]["count"]) == (
        start + (1 if step == "metric" else 3))


@pytest.mark.parametrize("step", ["metric", "adv"])
def test_vocoder_steps_match_jax_shard_steps(port, jax_voc_runs, step):
    want = jax_voc_runs[step]
    budget = 2 * GEN_LR
    for rank in range(2):
        got = port[rank][f"voc_{step}"]
        _records_close(got["records"][-1], want[1])
        _bars(_gen_tree(got["gen"], "voc"), want[0], budget,
              f"voc:{step}:rank{rank}:")
    if step == "adv":
        _bars(bridge.disc_params_to_jax(bridge.tree_map(
            torch.from_numpy, port[1]["voc_adv"]["disc"])), want[2],
            2 * DISC_LR, "voc:adv:disc:")


def _port_voc_chain(case, dtype):
    """The port's vocoder metric step, then its adversarial step, on the
    whole batch in one process, in `dtype` -> the final state."""
    def on(tree):
        return bridge.tree_map(
            lambda t: torch.as_tensor(t).to(dtype).clone(), tree)

    torch.set_default_dtype(dtype)
    try:
        state = train_state(on(case["gen"]), on(case["disc"]), VOC_CONFIG,
                            analyzer=on(case["analyzer"]))
        steps = make_vocoder_steps(
            PORT_VOC_CFG, PORT_GEN_CFG, lambda p, x:
            D.hifigan_discriminator_apply(p, x, PORT_DISC_CFG), VOC_CONFIG,
            build_criterion(VOC_CONFIG))
        for kind, (x,) in zip(case["steps"], case["batches"]):
            state, _ = steps[kind](state, torch.from_numpy(x).to(dtype))
    finally:
        torch.set_default_dtype(torch.float32)
    return state


@pytest.fixture(scope="module")
def voc_chains(inputs):
    """The port's single-process vocoder chain in float32 and float64."""
    case = next(c for c in _port_cases(inputs) if c["name"] == "voc_chain")
    return {dtype: _port_voc_chain(case, dtype)
            for dtype in (torch.float32, torch.float64)}


def test_vocoder_chain_in_float64_is_the_single_rank_chain(port, voc_chains):
    """The vocoder's metric step, then its adversarial step, chained: in
    float64 the two ranks' params are the single rank's on the whole batch
    to 1e-12, so the data-parallel reduction is exact."""
    state = voc_chains[torch.float64]
    for key in ("gen", "disc"):
        want = {k: _np(t) for k, t in tree_leaves(state[key])}
        for rank in range(2):
            got = dict(tree_leaves(port[rank]["voc_chain_f64"][key]))
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == np.float64, k
                np.testing.assert_allclose(got[k], want[k], rtol=0,
                                           atol=1e-12, err_msg=f"{key}/{k}")


WITNESS_LEAF, WITNESS_ELEMENT = "blocks/0/convs2/0/g", 25


def test_vocoder_chain_rounding_witness(inputs, port, voc_chains,
                                        jax_voc_runs, capsys):
    """The float32 vocoder chain (metric, then adversarial): the port's two
    ranks within the fullsize bars of its single rank, and JAX's
    data-parallel chain within them of JAX's single-device chain.  Printed
    (`pytest -s`): each pair's worst q99 and its distance at the one
    element where the port's ranks and JAX's data-parallel chain differ
    most (ROADMAP.md section C: a weight-norm gain whose Adam first moment
    nearly cancels), and each float32 chain's distance there from the
    port's float64 chain.  The float32 steps are held to JAX one at a time
    from the golden's init in test_vocoder_steps_match_jax_shard_steps."""
    steps, state = _jax_voc_steps(inputs, dp=False)
    x = [jnp.asarray(b) for b in inputs["voc"]["x"]]
    state, _ = steps["metric"](state, x[0])
    state, _ = steps["adv"](state, x[1])
    chains = {
        "port_dp": _gen_tree(port[0]["voc_chain"]["gen"], "voc"),
        "port_single": bridge.vocoder_params_to_jax(bridge.tree_map(
            torch.Tensor.detach, voc_chains[torch.float32]["gen"])),
        "port_single_f64": bridge.vocoder_params_to_jax(bridge.tree_map(
            torch.Tensor.detach, voc_chains[torch.float64]["gen"])),
        "jax_dp": jax_voc_runs["chain"], "jax_single": _copy(state["gen"])}
    chains = {k: {p: _np(t) for p, t in tree_leaves(v)}
              for k, v in chains.items()}

    def reading(a, b):
        qs = {p: float(np.quantile(np.abs(chains[a][p] - chains[b][p]),
                                   0.99)) for p in chains[b]}
        worst = max(qs, key=qs.get)
        at = np.abs(chains[a][WITNESS_LEAF] - chains[b][WITNESS_LEAF])
        return {"worst_q99": qs[worst], "worst_leaf": worst,
                "at_element": float(at.reshape(-1)[WITNESS_ELEMENT])}

    pairs = [("port_dp", "jax_dp"), ("port_dp", "port_single"),
             ("jax_dp", "jax_single"), ("port_single", "jax_single"),
             ("port_single", "port_single_f64"),
             ("jax_single", "port_single_f64"),
             ("jax_dp", "port_single_f64")]
    with capsys.disabled():
        for a, b in pairs:
            print(f"\nvocoder chain, {a} vs {b}: {reading(a, b)}")
    _bars(chains["port_dp"], chains["port_single"], 2 * (GEN_LR + 5e-5),
          "voc:chain:port:")
    _bars(chains["jax_dp"], chains["jax_single"], 2 * (GEN_LR + 5e-5),
          "voc:chain:jax:")


def test_denoise_step_matches_jax_shard_steps(inputs, port):
    d = inputs["den"]
    gen_opt, _, state = _opt_state(DEN_CONFIG, d["gen"])
    steps = _dp(jax_steps.make_denoise_steps(
        GEN_CFG, DEN_CONFIG, jax_criterion(DEN_CONFIG), gen_opt,
        axis_name="data", jit=False))
    state, rec = steps["train"](state, *map(jnp.asarray, d["x"]))
    for rank in range(2):
        got = port[rank]["den"]
        _records_close(got["records"][-1], _copy(rec))
        _bars(_gen_tree(got["gen"], "den"), _copy(state["gen"]), 2 * GEN_LR,
              f"den:rank{rank}:")


def test_two_ranks_train_as_one_on_the_global_batch(inputs, port):
    """The data-parallel metric step within the parity bars of the port's
    single-rank metric step on the whole batch (a plain projector: BN's
    batch statistics are per rank by design)."""
    state = train_state(bridge.params_from_jax(inputs["den"]["gen"]),
                        bridge.disc_params_from_jax(inputs["voc"]["disc"]),
                        CONFIG)
    steps = make_autoencoder_steps(
        PORT_GEN_CFG, lambda p, v: D.hifigan_discriminator_apply(
            p, v, PORT_DISC_CFG), CONFIG, build_criterion(CONFIG))
    single, rec = steps["metric"](state, torch.from_numpy(_plain_batch()))
    for rank in range(2):
        got = port[rank]["plain_metric"]
        _records_close(got["records"][0], {k: _np(v) for k, v in
                                           rec.items()})
        _bars(bridge.tree_map(torch.from_numpy, got["gen"]), single["gen"],
              2 * GEN_LR, f"dp-vs-single:rank{rank}:")
