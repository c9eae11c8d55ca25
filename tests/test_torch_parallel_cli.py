"""The command lines' data-parallel and multi-process flags on the CPU:
`codec_train --dp 2`, then `codec_stats --dp 2` on its checkpoint, in one
world of two gloo ranks, and `codec_test --seq 2 --dp 2` in four, each
through its `main` with the rendezvous flags (bin/multihost_probe.py's
`cli` worker); the refusal of
--dp / --seq above 1 in a world of one; `BatchTranscoder(mesh=)`'s policy
against JAX's.

Bars: data-parallel training against one rank on the same global batch,
per leaf after its 2 metric and 2 adversarial steps, at
tests/test_parallel_fullsize.py's bars (median |diff| <= 5e-7, q99 <=
5e-6, max <= 1.05 x twice the learning rate) with the quantizer's
sparse-divergence gate, and every rank's params equal after every step;
the statistics of two ranks within 1e-5 of the largest entry of one
rank's; codec_test's files PCM16 within 1 LSB of JAX's `--seq 2 --dp 2`
run and of the port's single-rank run.
"""

import json
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodec_tpu.bin import codec_test as jax_cli
from audiodec_tpu.parallel import make_mesh as jax_make_mesh
from audiodec_tpu_torch.bin import codec_stats, codec_test, codec_train
from audiodec_tpu_torch.bin.multihost_probe import run_ranks
from audiodec_tpu_torch.data import wav
from audiodec_tpu_torch.models.autoencoder import (
    GeneratorConfig,
    generator_init,
)
from audiodec_tpu_torch.parallel import make_mesh
from audiodec_tpu_torch.train.optim import tree_leaves
from audiodec_tpu_torch.utils import bridge
from audiodec_tpu_torch.utils.checkpoint import load_only_params
from tests.test_torch_codec_train import (
    STATISTIC,
    SYMAD,
    _corpus,
    _tiny_config,
    _write,
)

torch.set_num_threads(1)

GEN_LR, DISC_LR = 1e-4, 2e-4
WAV_LENGTHS = (9000, 7350, 6100)


def _ranks(n, clis, out):
    """The command lines of `clis`, [(name, argv)], one after the other in
    one world of n ranks."""
    argv = ["--worker", "cli", "--device", "cpu", "--threads", "1", "--out",
            str(out)]
    for name, _ in clis:
        argv += ["--cli", name]
    for _, args in clis:
        argv += ["--"] + args
    return run_ranks(n, argv, timeout=300)


def _stats_argv(root):
    return ["--config", STATISTIC, "--analyzer",
            str(root / "dp" / "checkpoint-final.ckpt"), "--data-path",
            str(root / "data" / "train"), "--batch-size", "4", "--device",
            "cpu"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The tiny symAD config's 2 + 2 steps in two ranks with --dp 2, then
    codec_stats --dp 2 on their checkpoint in the same ranks; the steps
    in one rank, from one seed."""
    root = tmp_path_factory.mktemp("dp_cli")
    _corpus(str(root / "data"))
    cfg_path = _write(str(root / "cfg.yaml"),
                      _tiny_config(str(root / "data")))
    common = ["--config", cfg_path, "--device", "cpu", "--seed", "3"]
    (root / "ranks").mkdir()
    _ranks(2, [("codec_train", common + ["--tag", str(root / "dp"),
                                         "--dp", "2"]),
               ("codec_stats", _stats_argv(root) + [
                   "--dp", "2", "--out", str(root / "stats_dp.npy")])],
           root / "ranks")
    codec_train.main(common + ["--tag", str(root / "one")])
    return root


def _final(root, tag, key):
    return dict(tree_leaves(load_only_params(
        str(root / tag / "checkpoint-final.ckpt"), key, fold=False)[0]))


@pytest.mark.parametrize("key", ["gen", "disc"])
def test_dp_training_matches_one_rank(trained, key):
    ours, ref = _final(trained, "dp", key), _final(trained, "one", key)
    assert sorted(ours) == sorted(ref)
    budget = 2 * (GEN_LR if key == "gen" else DISC_LR)
    for path in ours:
        d = np.abs(ours[path].astype(np.float64) - ref[path])
        if path.startswith("quantizer/"):
            # a near-tie code assignment that flips reroutes one codebook
            # row: sparse, bounded
            assert float((d > 1e-6).mean()) <= 1e-3, path
            assert float(d.max()) <= 0.05, path
            continue
        assert float(np.median(d)) <= 5e-7, path
        assert float(np.quantile(d, 0.99)) <= 5e-6, path
        assert float(d.max()) <= 1.05 * budget, path


def test_dp_ranks_stay_in_sync_and_only_rank0_writes(trained):
    stats = [json.loads((trained / "ranks" / f"rank{i}.json").read_text())
             ["codec_train"] for i in range(2)]
    for s in stats:
        assert s["in_sync_after_every_step"] and s["steps"] == 4
        assert s["backend"] == "gloo"
        assert len(s["step_ms"]["metric"]) == len(s["step_ms"]["adv"]) == 2
    files = sorted(os.listdir(trained / "dp"))
    assert files == sorted(os.listdir(trained / "one"))
    logs = [[json.loads(line) for line in
             (trained / tag / "metrics.jsonl").read_text().splitlines()]
            for tag in ("dp", "one")]
    assert [r["step"] for r in logs[0]] == [r["step"] for r in logs[1]]
    for a, b in zip(*logs):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)


def test_dp_stats_equal_one_rank(trained, tmp_path):
    one = codec_stats.main(_stats_argv(trained)
                           + ["--out", str(tmp_path / "one.npy")])
    two = np.load(trained / "stats_dp.npy")
    assert two.shape == one.shape == (2, 16)
    np.testing.assert_allclose(two, one, rtol=0,
                               atol=1e-5 * float(np.abs(one).max()))


@pytest.fixture(scope="module")
def transcoded(trained, tmp_path_factory):
    """codec_test on the dp checkpoint: four ranks (--seq 2 --dp 2), JAX's
    --seq 2 --dp 2 on its virtual devices, and one rank."""
    root = tmp_path_factory.mktemp("dp_codec_test")
    ckpt = str(trained / "dp" / "checkpoint-final.ckpt")
    corpus = root / "wavs"
    corpus.mkdir()
    rng = np.random.default_rng(4)
    for i, n in enumerate(WAV_LENGTHS):
        x = np.clip(0.3 * rng.standard_normal((n, 1)), -1, 1)
        wav.write_wav(str(corpus / f"utt{i}.wav"), x.astype(np.float32),
                      48000)
    common = ["--encoder", ckpt, "--decoder", ckpt, "--data-path",
              str(corpus), "--batch-size", "3"]
    (root / "ranks").mkdir()
    _ranks(4, [("codec_test", common + [
        "--stack", "plain", "--seq", "2", "--dp", "2", "--device", "cpu",
        "--outdir", str(root / "four")])], root / "ranks")
    codec_test.main(common + ["--stack", "plain", "--device", "cpu",
                              "--outdir", str(root / "one")])
    template = load_only_params(ckpt, "gen")[0]
    with pytest.MonkeyPatch.context() as mp:
        # JAX's load_codec draws a template with generator_init (a compile
        # per weight shape); the tree the checkpoint fills is handed over
        mp.setattr("audiodec_tpu.models.autoencoder.generator_init",
                   lambda key, cfg: template)
        mp.setattr("audiodec_tpu.utils.profiling.enable_compile_cache",
                   lambda *a: None)
        jax_cli.main(common + ["--stack", "xla", "--seq", "2", "--dp", "2",
                               "--outdir", str(root / "jax")])
    return root


def _outputs(outdir):
    files = sorted(os.listdir(outdir))
    return files, {f: wav.read_wav_pcm16(os.path.join(outdir, f))[0][:, 0]
                   .astype(np.int32) for f in files}


@pytest.mark.parametrize("other", ["jax", "one"])
def test_codec_test_in_four_ranks(transcoded, other):
    files, got = _outputs(transcoded / "four")
    ofiles, want = _outputs(transcoded / other)
    assert files == ofiles == [f"utt{i}_output.wav"
                               for i in range(len(WAV_LENGTHS))]
    for f in files:
        assert len(got[f]) == WAV_LENGTHS[int(f[3])]
        assert int(np.abs(got[f] - want[f]).max()) <= 1, f
    summaries = [json.loads((transcoded / "ranks" / f"rank{i}.json")
                            .read_text())["codec_test"] for i in range(4)]
    assert {s["summary"]["hosts"] for s in summaries} == {4}
    assert len({s["summary"]["wall_seconds"] for s in summaries}) == 1


@pytest.mark.parametrize("cli,argv", [
    (codec_train, ["--dp", "2"]),
    (codec_stats, ["--dp", "2"]),
    (codec_test, ["--dp", "2"]),
    (codec_test, ["--seq", "2"]),
])
def test_a_mesh_axis_needs_its_ranks(cli, argv, tmp_path, capsys):
    """A data or seq axis above 1 in a world of one is refused, with how
    to start the ranks (JAX would take local devices)."""
    common = {codec_train: ["--config", SYMAD, "--tag", str(tmp_path)],
              codec_stats: ["--config", STATISTIC],
              codec_test: ["--encoder", "e", "--decoder", "e"]}[cli]
    with pytest.raises(SystemExit) as err:
        cli.main(common + argv + ["--device", "cpu"])
    assert err.value.code == 2
    msg = capsys.readouterr().err
    assert "needs 2 ranks" in msg and "torchrun" in msg


def test_transcoder_policy_under_a_mesh_matches_jax():
    """Under a mesh the int8 decode is refused with JAX's warning and the
    folds follow JAX's rules; in a world of one the sharded codec gives
    the unsharded indices."""
    from audiodec_tpu.models.autoencoder import GeneratorConfig as JaxConfig

    small = dict(encode_channels=4, decode_channels=4, code_dim=16,
                 codebook_num=2, codebook_size=32)
    # the port's seeded draw, handed to JAX (its own draw compiles once
    # per weight shape)
    params = generator_init(GeneratorConfig(**small),
                            torch.Generator().manual_seed(0))
    jparams = bridge.tree_map(np.asarray, bridge.params_to_jax(params))
    mesh, jmesh = make_mesh(1, 1, device="cpu"), jax_make_mesh(1, 1)
    for stack, jstack in (("plain", "xla"), ("folded", "folded")):
        for dtype, jdt in ((None, None), (torch.bfloat16, jnp.bfloat16)):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                ours = codec_test.BatchTranscoder(
                    params, GeneratorConfig(**small), mesh=mesh,
                    stack=stack, dec_dtype=dtype, int8_decode=True)
            assert any("sharded (--dp/--seq)" in str(w.message)
                       for w in caught)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                theirs = jax_cli.BatchTranscoder(
                    jparams, JaxConfig(**small), mesh=jmesh, stack=jstack,
                    dec_dtype=jdt, int8_decode=True)
            assert ours.fold_policy == theirs.fold_policy, (stack, dtype)
    plain = codec_test.BatchTranscoder(params, GeneratorConfig(**small),
                                       stack="plain", encode_fold=False,
                                       device="cpu")
    x = (0.3 * np.random.default_rng(2).standard_normal(
        (3, 4800, 1))).astype(np.float32)
    idx, y = codec_test.BatchTranscoder(params, GeneratorConfig(**small),
                                        mesh=mesh, stack="plain")(x)
    ref_idx, ref_y = plain(x)
    assert torch.equal(idx, ref_idx)
    np.testing.assert_allclose(y.numpy(), ref_y.numpy(), rtol=1e-5,
                               atol=1e-6)
