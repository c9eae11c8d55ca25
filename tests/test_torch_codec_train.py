"""The port's training command line (`bin/codec_train.py`) on the CPU: a few
steps of each stage on a seeded tiny corpus at gen_small-like widths, its
JSONL log and checkpoints, resume and warm start; the checkpoint read by
the JAX package (`load_only_params` onto a JAX template gives JAX the
port's outputs) and by the port's `codec_test`; `config.yml` read back by
JAX's `load_config`; the seeded collater and loader against JAX's.  Then
the AD v1 recipe's other modes on the same corpus: `bin/codec_stats.py`
with the trained symAD as the analyzer, the vocoder trained on its codes
and statistics, and the denoiser warm-started from it on (noisy, clean)
pairs, each through both JAX's `load_only_params` and a resume.

Tolerances: outputs of the JAX and port models on one checkpoint within a
relative 1e-5 of the largest entry; batches, configs and restored states
exactly.
"""

import glob
import itertools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from audiodec_tpu.data import collate as jax_collate
from audiodec_tpu.data import loader as jax_loader
from audiodec_tpu.models import autoencoder as jax_ae
from audiodec_tpu.models import discriminators as jax_disc
from audiodec_tpu.models import vocoder as jax_voc
from audiodec_tpu.ops import norms as jax_norms
from audiodec_tpu.train import checkpoint as jax_ckpt
from audiodec_tpu.utils import config as jax_config
from audiodec_tpu_torch.bin import codec_stats, codec_test, codec_train
from audiodec_tpu_torch.data.collate import CollaterAudio
from audiodec_tpu_torch.data.dataset import SingleDataset
from audiodec_tpu_torch.data.loader import DataLoader
from audiodec_tpu_torch.data.wav import write_wav
from audiodec_tpu_torch.models import autoencoder as ae
from audiodec_tpu_torch.models import discriminators as D
from audiodec_tpu_torch.models import vocoder as voc
from audiodec_tpu_torch.ops.norms import resolve_params
from audiodec_tpu_torch.train import checkpoint as ckpt
from audiodec_tpu_torch.train.optim import tree_leaves
from audiodec_tpu_torch.utils import bridge, config
from audiodec_tpu_torch.utils import checkpoint as ckpt_io
from audiodec_tpu_torch.utils.checkpoint import load_only_params

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYMAD = os.path.join(ROOT, "configs", "autoencoder",
                     "symAD_vctk_48000_hop300.yaml")
VOCODER = os.path.join(ROOT, "configs", "vocoder",
                       "AudioDec_v1_symAD_vctk_48000_hop300_clean.yaml")
DENOISE = os.path.join(ROOT, "configs", "denoise",
                       "symAD_vctk_48000_hop300.yaml")
STATISTIC = os.path.join(ROOT, "configs", "statistic",
                         "symAD_vctk_48000_hop300_clean.yaml")
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"),
                           recursive=True))
SR = 48000


def _corpus(root):
    rng = np.random.default_rng(0)
    for sub, n in (("train", 6), ("valid", 2)):
        os.makedirs(os.path.join(root, sub))
        for i in range(n):
            write_wav(os.path.join(root, sub, f"{i}.wav"),
                      (0.3 * rng.standard_normal(3000 + 500 * i)
                       ).astype(np.float32), SR)


def _tiny_config(data_path, base=SYMAD, **over):
    cfg = config.load_config(base)
    cfg["data"] = {"path": data_path,
                   "subset": {"train": "train", "valid": "valid"}}
    if base == VOCODER:
        cfg["generator_params"].update(in_channels=16, channels=32)
    else:
        cfg["generator_params"].update(encode_channels=4, decode_channels=4,
                                       code_dim=16, codebook_num=4,
                                       codebook_size=32)
    dp = cfg["discriminator_params"]
    dp["scales"], dp["periods"] = 2, [2, 3]
    dp["scale_discriminator_params"].update(
        channels=16, max_downsample_channels=32, max_groups=4)
    dp["period_discriminator_params"].update(channels=4,
                                             max_downsample_channels=16)
    cfg.update(batch_size=2, batch_length=1200, adv_batch_length=1200,
               num_workers=1, start_steps={"generator": 0,
                                           "discriminator": 2},
               train_max_steps=2, adv_train_max_steps=4,
               save_interval_steps=2, eval_interval_steps=2,
               log_interval_steps=1)
    cfg.update(over)
    return cfg


def _write(path, cfg):
    with open(path, "w") as f:
        f.write(config.dump_yaml(cfg))
    return path


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Four steps (two metric, two adversarial) of the tiny config."""
    root = tmp_path_factory.mktemp("train")
    _corpus(str(root / "data"))
    cfg = _tiny_config(str(root / "data"))
    cfg_path = _write(str(root / "cfg.yaml"), cfg)
    tag = str(root / "exp")
    trainer = codec_train.main(["--config", cfg_path, "--tag", tag,
                                "--device", "cpu", "--seed", "3"])
    return root, cfg, cfg_path, tag, trainer


def test_runs_both_stages_and_logs(run):
    _, _, _, tag, trainer = run
    assert trainer.steps == 4
    with open(os.path.join(tag, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    train = [r for r in recs if "train/generator_loss" in r]
    evals = [r for r in recs if "eval/generator_loss" in r]
    assert [r["step"] for r in train] == [1, 2, 3, 4]
    assert [r["step"] for r in evals] == [2, 4]
    assert "train/discriminator_loss" not in train[1]
    for key in ("mel_loss", "vqloss", "ppl_3", "adversarial_loss",
                "feature_matching_loss", "real_loss", "fake_loss",
                "discriminator_loss"):
        assert f"train/{key}" in train[2], key
    assert all(np.isfinite(v) for r in recs for v in r.values())
    for name in ("checkpoint-2steps.ckpt", "checkpoint-4steps.ckpt",
                 "checkpoint-final.ckpt", "config.yml"):
        assert os.path.exists(os.path.join(tag, name)), name
    _, header = load_only_params(
        os.path.join(tag, "checkpoint-final.ckpt"))
    assert header["steps"] == 4


def test_adversarial_stage_freezes_encoder_and_codebook(run):
    _, _, _, tag, _ = run
    at2, _ = load_only_params(os.path.join(tag,
                                                "checkpoint-2steps.ckpt"))
    at4, _ = load_only_params(os.path.join(tag,
                                                "checkpoint-4steps.ckpt"))
    a, b = dict(tree_leaves(at2)), dict(tree_leaves(at4))
    for path in a:
        if path.split("/")[0] in ("encoder", "projector", "quantizer"):
            np.testing.assert_array_equal(a[path], b[path], err_msg=path)
    assert any(not np.array_equal(a[p], b[p]) for p in a
               if p.startswith("decoder"))


def test_config_yml_reads_back_in_jax(run):
    _, cfg, cfg_path, tag, _ = run
    written = os.path.join(tag, "config.yml")
    assert jax_config.load_config(written) == cfg
    assert config.load_config(written) == cfg
    assert jax_config.load_config(cfg_path) == cfg


@pytest.mark.parametrize("path", CONFIGS,
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_dump_yaml_round_trips(path):
    """Every shipped config, as dump_yaml writes it, reads back equal
    through PyYAML and through the port's parser."""
    cfg = config.load_config(path)
    text = config.dump_yaml(cfg)
    assert yaml.safe_load(text) == cfg
    assert config.parse_yaml(text) == cfg


def test_dump_yaml_odd_values():
    cfg = {"a": 1e-05, "b": [1e-12, 2.5, float("inf"), -3], "c": {},
           "d": [], "e": "yes", "f": "it's", "g": [[3, 9], [1, 2]],
           "h": [{"x": 1, "y": [1, 2]}, {"z": None}], "i": "1e-12",
           "j": "a b: c", "k": "", "l": 1e20, "m": True}
    text = config.dump_yaml(cfg)
    assert yaml.safe_load(text) == cfg
    assert config.parse_yaml(text) == cfg


def _gen_cfgs(cfg):
    gp = cfg["generator_params"]
    return (jax_ae.config_from_yaml(gp), ae.config_from_yaml(gp))


def test_checkpoint_loads_in_jax(run):
    """JAX's load_only_params reads the port's gen and disc onto JAX
    templates (folding the MPD's weight norm), and JAX's forward on them
    gives the port's."""
    _, cfg, _, tag, _ = run
    path = os.path.join(tag, "checkpoint-final.ckpt")
    jcfg, pcfg = _gen_cfgs(cfg)
    template = jax.eval_shape(lambda k: jax_ae.generator_init(k, jcfg),
                              jax.random.PRNGKey(0))
    jgen, header = jax_ckpt.load_only_params(path, "gen", template=template)
    assert header["steps"] == 4
    x = (0.3 * np.random.default_rng(1).standard_normal((2, 1200, 1))
         ).astype(np.float32)
    want = jax.jit(lambda p, v: jax_ae.generator_forward(p, v, jcfg)[0])(
        jgen, jnp.asarray(x))
    gen = bridge.params_from_jax(load_only_params(path)[0])
    got = ae.generator_forward(gen, torch.from_numpy(x), pcfg)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.max(np.abs(want))))

    djcfg = jax_config.discriminator_config(cfg)
    dtemplate = jax.eval_shape(lambda k: jax_norms.resolve_params(
        jax_disc.hifigan_discriminator_init(k, djcfg))[0],
        jax.random.PRNGKey(0))
    jdisc, _ = jax_ckpt.load_only_params(path, "disc", template=dtemplate)
    want = jax.jit(lambda p, v: jax_disc.hifigan_discriminator_apply(
        p, v, djcfg))(jdisc, jnp.asarray(x))
    disc = bridge.disc_params_from_jax(load_only_params(
        path, "disc", fold=False)[0])
    eff, _ = resolve_params(disc)
    got = D.hifigan_discriminator_apply(
        eff, torch.from_numpy(x), config.discriminator_config(cfg))
    for branch_g, branch_w in zip(got, want):
        g, w = branch_g[-1].detach().numpy(), np.asarray(branch_w[-1])
        np.testing.assert_allclose(g.reshape(w.shape[0], -1),
                                   w.reshape(w.shape[0], -1), rtol=1e-5,
                                   atol=1e-5 * float(np.max(np.abs(w))))


def test_codec_test_reads_the_checkpoint(run, tmp_path):
    """The final checkpoint (JAX format, config.yml beside it) through the
    port's codec_test on the CPU: finite output of the input's length."""
    root, _, _, tag, _ = run
    path = os.path.join(tag, "checkpoint-final.ckpt")
    out = str(tmp_path / "out")
    codec_test.main(["--encoder", path, "--decoder", path, "--data-path",
                     str(root / "data" / "valid"), "--outdir", out,
                     "--stack", "plain", "--device", "cpu"])
    wavs = sorted(glob.glob(os.path.join(out, "**", "*.wav"),
                            recursive=True))
    assert len(wavs) == 2
    from audiodec_tpu_torch.data.wav import read_wav
    for w in wavs:
        y, sr = read_wav(w)
        assert sr == SR and np.all(np.isfinite(y))


def test_resume_restores_the_state(run, tmp_path):
    """--resume from the step-2 checkpoint: the trained state and the
    optimizers' moments and schedules as saved, then on to step 4."""
    root, cfg, cfg_path, tag, _ = run
    resumed = codec_train.main(["--config", cfg_path, "--tag",
                                str(tmp_path / "resumed"), "--device",
                                "cpu", "--resume",
                                os.path.join(tag, "checkpoint-2steps.ckpt")])
    assert resumed.steps == 4
    _, header = load_only_params(str(tmp_path / "resumed" /
                                          "checkpoint-final.ckpt"))
    assert header["steps"] == 4

    # a state restored from a checkpoint writes the same checkpoint back
    from audiodec_tpu_torch.utils import checkpoint as ckpt_io

    state = resumed.state
    state, header = ckpt.load_checkpoint(
        os.path.join(tag, "checkpoint-2steps.ckpt"), state)
    again = str(tmp_path / "again.ckpt")
    ckpt.save_checkpoint(again, state, header["steps"])
    a = dict(tree_leaves(ckpt_io.load_checkpoint(again)[0]))
    b = dict(tree_leaves(ckpt_io.load_checkpoint(
        os.path.join(tag, "checkpoint-2steps.ckpt"))[0]))
    assert sorted(a) == sorted(b)
    for p in a:
        np.testing.assert_array_equal(np.asarray(a[p]), np.asarray(b[p]),
                                      err_msg=p)
    assert any("/exp_avg_sq" in p for p in a)


def test_warm_start_from_a_jax_checkpoint(run, tmp_path):
    """`initial:` takes the generator of a checkpoint the JAX package
    wrote; with no step to run, the final checkpoint holds it as it is."""
    root, cfg, _, _, _ = run
    _, pcfg = _gen_cfgs(cfg)
    jgen = bridge.params_to_jax(ae.generator_init(
        pcfg, torch.Generator().manual_seed(5)))
    init_path = str(tmp_path / "jax.ckpt")
    jax_ckpt.save_checkpoint(init_path, {"gen": jgen}, 0)
    cfg_path = _write(str(tmp_path / "cfg.yaml"),
                      dict(cfg, initial=init_path, adv_train_max_steps=0))
    codec_train.main(["--config", cfg_path, "--tag", str(tmp_path / "w"),
                      "--device", "cpu"])
    got = dict(tree_leaves(load_only_params(
        str(tmp_path / "w" / "checkpoint-final.ckpt"))[0]))
    want = dict(tree_leaves(jgen))
    assert sorted(got) == sorted(want)
    for p in want:
        np.testing.assert_array_equal(got[p], want[p], err_msg=p)


@pytest.mark.parametrize("workers", [1, 2])
def test_collater_and_loader_match_jax(run, workers):
    """Seeded crops and shuffles equal JAX's one-thread loader's, batch for
    batch over two epochs, for one thread and for two (the port's threads
    draw the crops in batch order; JAX's in whichever order they run), so
    every rank of a data-parallel run builds the same global batch."""
    root = run[0]
    files = str(root / "data" / "train")
    ours = DataLoader(SingleDataset(files), CollaterAudio(1200, seed=4), 2,
                      num_workers=workers, seed=7)
    from audiodec_tpu.data.dataset import SingleDataset as JaxDataset

    theirs = jax_loader.DataLoader(JaxDataset(files),
                                   jax_collate.CollaterAudio(1200, seed=4),
                                   2, num_workers=1, seed=7)
    assert len(ours) == len(theirs) == 3
    a, b = ours.infinite(), theirs.infinite()
    for _ in range(2 * len(ours)):
        x, y = next(a), next(b)
        assert x.shape == y.shape == (2, 1200, 1)
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# codec_stats, then the vocoder and the denoiser on the trained symAD
# ---------------------------------------------------------------------------

def _train_log(tag):
    with open(os.path.join(tag, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert all(np.isfinite(v) for r in recs for v in r.values())
    return [r for r in recs if "train/generator_loss" in r]


def _leaves(path, key):
    return dict(tree_leaves(load_only_params(path, key, fold=False)[0]))


@pytest.fixture(scope="module")
def stats(run):
    """codec_stats over the training corpus with the trained symAD as the
    analyzer."""
    root, _, _, tag, _ = run
    cfg = config.load_config(STATISTIC)
    cfg["data"] = {"path": str(root / "data"),
                   "subset": {"train": "train", "valid": "valid"}}
    cfg_path = _write(str(root / "stats.yaml"), cfg)
    out = str(root / "stats" / "stats.npy")
    got = codec_stats.main(["--config", cfg_path, "--analyzer",
                            os.path.join(tag, "checkpoint-final.ckpt"),
                            "--out", out, "--batch-size", "4",
                            "--device", "cpu"])
    return cfg_path, out, got


def test_codec_stats_writes_the_analyzers_moments(run, stats):
    root, _, _, tag, _ = run
    cfg_path, out, got = stats
    written = np.load(out)
    np.testing.assert_array_equal(written, got)
    assert written.shape == (2, 16) and np.all(written[1] > 0)
    params, cfg = codec_train.load_analyzer(
        os.path.join(tag, "checkpoint-final.ckpt"), torch.device("cpu"))
    np.testing.assert_array_equal(written, codec_stats.extract_stats(
        params, cfg, SingleDataset(str(root / "data" / "train")),
        batch_size=4))


def _voc_config(run, stats, **over):
    root, _, _, tag, _ = run
    cfg = _tiny_config(str(root / "data"), base=VOCODER,
                       analyzer=os.path.join(tag, "checkpoint-final.ckpt"),
                       discriminator_train_start_steps=1, **over)
    cfg["generator_params"]["stats"] = stats[1]
    return _write(str(root / "voc.yaml"), cfg), cfg


@pytest.fixture(scope="module")
def voc_run(run, stats):
    """Four vocoder steps: the `>` gate at discriminator_train_start_steps
    1 makes steps 0 and 1 metric steps, 2 and 3 adversarial ones."""
    root = run[0]
    cfg_path, cfg = _voc_config(run, stats)
    tag = str(root / "voc")
    trainer = codec_train.main(["--config", cfg_path, "--tag", tag,
                                "--device", "cpu", "--seed", "5"])
    return cfg_path, cfg, tag, trainer


def test_vocoder_mode_trains_and_loads_in_jax(run, stats, voc_run):
    """Both stages run and log; the analyzer and the statistics ride along
    unmoved; JAX's load_only_params reads the vocoder onto a vocoder_init
    template (folding its weight norm), and JAX's vocoder gives the
    port's output on it."""
    _, _, _, an_tag, _ = run
    _, cfg, tag, trainer = voc_run
    assert trainer.steps == 4
    train = _train_log(tag)
    assert [r["step"] for r in train] == [1, 2, 3, 4]
    assert ["train/discriminator_loss" in r for r in train] == [
        False, False, True, True]
    path = os.path.join(tag, "checkpoint-final.ckpt")
    gen = _leaves(path, "gen")
    assert "input_conv/v" in gen and "upsamples/0/g" in gen
    st = np.load(stats[1])
    np.testing.assert_array_equal(gen["mean"], st[0])
    np.testing.assert_array_equal(gen["scale"], st[1])
    analyzer = _leaves(os.path.join(an_tag, "checkpoint-final.ckpt"), "gen")
    for p, a in _leaves(path, "analyzer").items():
        np.testing.assert_array_equal(a, analyzer[p], err_msg=p)
    assert not np.array_equal(gen["input_conv/v"], _leaves(
        os.path.join(tag, "checkpoint-2steps.ckpt"), "gen")["input_conv/v"])

    gp = cfg["generator_params"]
    jcfg = jax_voc.config_from_yaml(gp, stats=True)
    template = jax.eval_shape(lambda k: jax_voc.vocoder_init(k, jcfg),
                              jax.random.PRNGKey(0))
    jgen, header = jax_ckpt.load_only_params(path, "gen", template=template)
    assert header["steps"] == 4
    c = np.random.default_rng(2).standard_normal((2, 5, 16)).astype(
        np.float32)
    want = jax.jit(lambda p, v: jax_voc.vocoder_apply(p, v, jcfg))(
        jgen, jnp.asarray(c))
    got = voc.vocoder_apply(
        bridge.vocoder_params_from_jax(load_only_params(path)[0]),
        torch.from_numpy(c), voc.config_from_yaml(gp, stats=True))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.max(np.abs(want))))


def _pair_corpus(root):
    """The training corpus as the clean side, plus seeded noise as the
    noisy side, for train and valid."""
    rng = np.random.default_rng(6)
    from audiodec_tpu_torch.data.wav import read_wav

    for sub in ("train", "valid"):
        os.makedirs(os.path.join(root, f"noisy_{sub}"))
        for name in sorted(os.listdir(os.path.join(root, sub))):
            x, sr = read_wav(os.path.join(root, sub, name))
            write_wav(os.path.join(root, f"noisy_{sub}", name),
                      x + 0.05 * rng.standard_normal(x.shape).astype(
                          np.float32), sr)


@pytest.fixture(scope="module")
def den_run(run):
    """Four denoising steps warm-started from the trained symAD."""
    root, _, _, an_tag, _ = run
    _pair_corpus(str(root / "data"))
    cfg = _tiny_config(str(root / "data"), base=DENOISE,
                       initial=os.path.join(an_tag, "checkpoint-final.ckpt"),
                       start_steps={"generator": 0, "discriminator": 200000})
    cfg["data"]["subset"] = {"clean_train": "train", "clean_valid": "valid",
                             "noisy_train": "noisy_train",
                             "noisy_valid": "noisy_valid"}
    cfg_path = _write(str(root / "den.yaml"), cfg)
    tag = str(root / "den")
    trainer = codec_train.main(["--config", cfg_path, "--tag", tag,
                                "--device", "cpu"])
    return cfg_path, cfg, tag, trainer


def test_denoise_mode_trains_and_loads_in_jax(run, den_run):
    """Four steps of one stage; the quantizer and decoder of the warm
    start unmoved bit for bit, the encoder moved; no discriminator in the
    checkpoint; JAX's load_only_params reads it onto a generator_init
    template and JAX's generator gives the port's output on it."""
    _, _, _, an_tag, _ = run
    _, cfg, tag, trainer = den_run
    assert trainer.steps == 4 and "disc" not in trainer.state
    train = _train_log(tag)
    assert [r["step"] for r in train] == [1, 2, 3, 4]
    assert not any("train/discriminator_loss" in r for r in train)
    path = os.path.join(tag, "checkpoint-final.ckpt")
    raw, _ = ckpt_io.load_checkpoint(path)
    assert sorted(raw) == ["gen", "gen_opt"]
    start = _leaves(os.path.join(an_tag, "checkpoint-final.ckpt"), "gen")
    gen = _leaves(path, "gen")
    for p in gen:
        if p.split("/")[0] in ("quantizer", "decoder"):
            np.testing.assert_array_equal(gen[p], start[p], err_msg=p)
    assert not np.array_equal(gen["encoder/conv/w"], start["encoder/conv/w"])

    jcfg, pcfg = _gen_cfgs(cfg)
    template = jax.eval_shape(lambda k: jax_ae.generator_init(k, jcfg),
                              jax.random.PRNGKey(0))
    jgen, _ = jax_ckpt.load_only_params(path, "gen", template=template)
    x = (0.3 * np.random.default_rng(1).standard_normal((2, 1200, 1))
         ).astype(np.float32)
    want = jax.jit(lambda p, v: jax_ae.generator_forward(p, v, jcfg)[0])(
        jgen, jnp.asarray(x))
    got = ae.generator_forward(bridge.params_from_jax(
        load_only_params(path)[0]), torch.from_numpy(x), pcfg)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.max(np.abs(want))))


@pytest.mark.parametrize("mode", ["vocoder", "denoise"])
def test_resume_other_modes(request, tmp_path, mode):
    """--resume from the step-2 checkpoint runs on to step 4, and a state
    restored from a checkpoint writes it back as it was."""
    cfg_path, _, tag, _ = request.getfixturevalue(
        "voc_run" if mode == "vocoder" else "den_run")
    at2 = os.path.join(tag, "checkpoint-2steps.ckpt")
    resumed = codec_train.main(["--config", cfg_path, "--tag",
                                str(tmp_path / "resumed"), "--device",
                                "cpu", "--resume", at2])
    assert resumed.steps == 4
    state, header = ckpt.load_checkpoint(at2, resumed.state)
    again = str(tmp_path / "again.ckpt")
    ckpt.save_checkpoint(again, state, header["steps"])
    a = dict(tree_leaves(ckpt_io.load_checkpoint(again)[0]))
    b = dict(tree_leaves(ckpt_io.load_checkpoint(at2)[0]))
    assert sorted(a) == sorted(b)
    for p in a:
        np.testing.assert_array_equal(np.asarray(a[p]), np.asarray(b[p]),
                                      err_msg=p)


@pytest.mark.parametrize("start", [0, 2])
def test_trainer_stages_and_sigterm(tmp_path, start):
    """GanTrainer's stage switch (the adversarial stage from step
    start_steps.discriminator on, JAX's strict_start), and SIGTERM: the
    run stops after the step in flight with checkpoint-final.ckpt."""
    import signal

    from audiodec_tpu_torch.train.steps import train_state
    from audiodec_tpu_torch.train.trainer import GanTrainer

    cfg = _tiny_config("unused")
    gcfg = ae.config_from_yaml(cfg["generator_params"])
    rng = torch.Generator().manual_seed(0)
    state = train_state(ae.generator_init(gcfg, rng),
                        D.hifigan_discriminator_init(
                            rng, config.discriminator_config(cfg)), cfg)
    kinds = []

    def step(kind):
        def fn(st, x):
            kinds.append(kind)
            if len(kinds) == 5:
                os.kill(os.getpid(), signal.SIGTERM)
            return st, {"loss": torch.tensor(float(len(kinds)))}
        return fn

    batches = itertools.repeat(np.zeros((1, 8, 1), np.float32))
    trainer = GanTrainer({"metric": step("metric"), "adv": step("adv"),
                          "eval": None}, state,
                         dict(cfg, adv_train_max_steps=8,
                              eval_interval_steps=100,
                              start_steps={"generator": 0,
                                           "discriminator": start}),
                         str(tmp_path), batches, lambda: iter(()),
                         torch.device("cpu"))
    trainer.run()
    assert kinds == ["metric"] * start + ["adv"] * (5 - start)
    assert trainer.steps == 5
    _, header = load_only_params(str(tmp_path /
                                          "checkpoint-final.ckpt"))
    assert header["steps"] == 5
    with open(tmp_path / "metrics.jsonl") as f:
        assert [json.loads(line)["train/loss"] for line in f] == [
            1.0, 2.0, 3.0, 4.0, 5.0]
