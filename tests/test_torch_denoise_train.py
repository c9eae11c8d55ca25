"""The port's denoising training (`train/steps.py` `make_denoise_steps`,
`data/dataset.py` `MultiDataset`, `data/collate.py` `CollaterAudioPair`)
against the JAX package and the reference trainer's golden
(tests/golden/denoise_train_step.npz): one train step and one eval step
against JAX's jitted steps (one compile per step kind, in a module-scoped
fixture), the reference's schedule with tests/test_train_step_parity.py's
bars, and the pair batches against JAX's.

Tolerances: parameters after a step per leaf at the parity test's bars
(median |diff| <= 5e-7, q99 <= 5e-6, max <= 1.05 x the learning-rate
budget); records within a relative 1e-4; the quantizer (its EMA buffers
included) and the decoder bit-equal to their start; batches exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodec_tpu.data import collate as jax_collate
from audiodec_tpu.data import dataset as jax_dataset
from audiodec_tpu.data import loader as jax_loader
from audiodec_tpu.train import steps as jax_steps
from audiodec_tpu.train.criterion import build_criterion as jax_criterion
from audiodec_tpu.train.optim import make_optimizer
from audiodec_tpu.utils.torch_import import import_autoencoder
from audiodec_tpu_torch.data.collate import CollaterAudioPair
from audiodec_tpu_torch.data.dataset import MultiDataset
from audiodec_tpu_torch.data.loader import DataLoader
from audiodec_tpu_torch.data.wav import write_wav
from audiodec_tpu_torch.train.criterion import build_criterion
from audiodec_tpu_torch.train.optim import tree_leaves
from audiodec_tpu_torch.train.steps import make_denoise_steps, train_state
from audiodec_tpu_torch.utils import bridge
from tests.test_torch_train_step import (
    PORT_GEN_CFG,
    _bars,
    _copy,
    _records_close,
)
from tests.test_train_step_parity import DEN_CONFIG, GEN_CFG, _sub

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(GOLDEN, "denoise_train_step.npz"))


def _inputs(data):
    return (data["x_noisy"].transpose(0, 1, 3, 2).copy(),
            data["x_clean"].transpose(0, 1, 3, 2).copy())


def _port_state(data, key="sd0_gen__"):
    gen = bridge.params_from_reference_sd(_sub(data, key), PORT_GEN_CFG)
    return train_state(gen, None, DEN_CONFIG)


@pytest.fixture(scope="module")
def jax_step(golden):
    """JAX's train step on pair 0, then its eval step on pair 1."""
    x_n, x_c = _inputs(golden)
    gen = _copy(import_autoencoder(_sub(golden, "sd0_gen__"), GEN_CFG))
    gen_opt = make_optimizer(DEN_CONFIG, "generator")
    steps = jax_steps.make_denoise_steps(GEN_CFG, DEN_CONFIG,
                                         jax_criterion(DEN_CONFIG), gen_opt,
                                         jit=True)
    state, rec = steps["train"]({"gen": gen, "gen_opt": gen_opt.init(gen)},
                                jnp.asarray(x_n[0]), jnp.asarray(x_c[0]))
    rec_e = steps["eval"](state, jnp.asarray(x_n[1]), jnp.asarray(x_c[1]))
    return _copy(state["gen"]), _copy(rec), _copy(rec_e)


def test_train_and_eval_steps_match_jax(golden, jax_step):
    gen_t, rec_t, rec_e = jax_step
    x_n, x_c = (torch.from_numpy(a) for a in _inputs(golden))
    state = _port_state(golden)
    assert sorted(state) == ["gen", "gen_opt"]
    steps = make_denoise_steps(PORT_GEN_CFG, DEN_CONFIG,
                               build_criterion(DEN_CONFIG))
    assert sorted(steps) == ["eval", "train"]
    state, rec = steps["train"](state, x_n[0], x_c[0])
    _records_close(rec, rec_t)
    _bars(bridge.params_to_jax(state["gen"]), gen_t, 2 * 1e-4, "denoise:")
    _records_close(steps["eval"](state, x_n[1], x_c[1]), rec_e)


def test_golden_schedule_meets_parity_bars(golden):
    """n_steps train steps (StepLR(2): lr 1e-4, 1e-4, 5e-5) from the
    golden's init against the reference trainer's encoder and projector;
    the quantizer and decoder unmoved, bit for bit."""
    x_n, x_c = (torch.from_numpy(a) for a in _inputs(golden))
    state = _port_state(golden)
    frozen0 = {p: t.clone() for p, t in tree_leaves(
        {k: state["gen"][k] for k in ("quantizer", "decoder")})}
    enc0 = state["gen"]["encoder"]["conv"]["w"].detach().clone()
    steps = make_denoise_steps(PORT_GEN_CFG, DEN_CONFIG,
                               build_criterion(DEN_CONFIG))
    for i in range(int(golden["n_steps"])):
        state, rec = steps["train"](state, x_n[i], x_c[i])
        assert np.isfinite(float(rec["generator_loss"]))
    ref = bridge.params_from_reference_sd(_sub(golden, "sd1_gen__"),
                                          PORT_GEN_CFG)
    _bars({k: state["gen"][k] for k in ("encoder", "projector")},
          {k: ref[k] for k in ("encoder", "projector")},
          2 * (2 * 1e-4 + 5e-5), "denoise:")
    frozen = dict(tree_leaves({k: state["gen"][k]
                               for k in ("quantizer", "decoder")}))
    assert sorted(frozen) == sorted(frozen0)
    for p, t in frozen.items():
        assert torch.equal(t, frozen0[p]), p
    assert float(torch.max(torch.abs(state["gen"]["encoder"]["conv"]["w"]
                                     .detach() - enc0))) > 1e-7


def _pair_corpus(root):
    """Seeded (noisy, clean) corpora; pair 2 has unequal lengths and pair
    4 is too short, so the collater drops them."""
    rng = np.random.default_rng(3)
    lengths = [(1500, 1500), (2100, 2100), (1700, 1600), (3000, 3000),
               (900, 900), (2500, 2500)]
    for sub in ("noisy", "clean"):
        os.makedirs(os.path.join(root, sub))
    for i, (n, c) in enumerate(lengths):
        clean = (0.3 * rng.standard_normal(c)).astype(np.float32)
        noisy = (np.resize(clean, n)
                 + 0.05 * rng.standard_normal(n)).astype(np.float32)
        write_wav(os.path.join(root, "noisy", f"{i}.wav"), noisy, 48000)
        write_wav(os.path.join(root, "clean", f"{i}.wav"), clean, 48000)


@pytest.mark.parametrize("workers", [1, 2])
def test_pair_batches_match_jax(tmp_path, workers):
    """MultiDataset and CollaterAudioPair through the loader: the same
    shuffles, crops and drops as JAX's one-thread loader over two epochs,
    batch for batch, for one thread and for two (the port's threads draw
    the crops in batch order)."""
    _pair_corpus(str(tmp_path))
    dirs = [str(tmp_path / "noisy"), str(tmp_path / "clean")]
    ours = DataLoader(MultiDataset(dirs), CollaterAudioPair(1200, seed=4), 3,
                      num_workers=workers, seed=7)
    theirs = jax_loader.DataLoader(
        jax_dataset.MultiDataset(dirs),
        jax_collate.CollaterAudioPair(1200, seed=4), 3,
        num_workers=1, seed=7)
    assert len(ours) == len(theirs) == 2
    a, b = ours.infinite(), theirs.infinite()
    for _ in range(2 * len(ours)):
        (n, c), (jn, jc) = next(a), next(b)
        assert n.shape == jn.shape and c.shape == jc.shape
        assert n.shape[1:] == (1200, 1)
        np.testing.assert_array_equal(n, jn)
        np.testing.assert_array_equal(c, jc)


def test_multi_dataset_refuses_unequal_corpora(tmp_path):
    _pair_corpus(str(tmp_path))
    os.remove(tmp_path / "clean" / "5.wav")
    with pytest.raises(ValueError, match="lengths differ"):
        MultiDataset([str(tmp_path / "noisy"), str(tmp_path / "clean")])
    pair = MultiDataset([str(tmp_path / "noisy")] * 2, return_utt_id=True)
    utt, (n, c) = pair[0]
    assert utt == "0" and np.array_equal(n, c)
