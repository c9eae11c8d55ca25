"""The port's batch command line (`bin/codec_test.py`) and what it reads and
writes, against the JAX package's: the YAML reader against `load_config`,
the checkpoint reader and writer against flax's format, the wav I/O
against the numpy path of `data/wav.py`, `_pcm16`, the batch plan, the
int8 decode of `BatchTranscoder`, and `main` end to end on a narrow
checkpoint.

On the CPU the port's kernel wrappers run their plain versions; JAX runs
its folded kernel in interpret mode.
"""

import glob
import json
import os
import warnings

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from audiodec_tpu.bin import codec_test as jax_cli
from audiodec_tpu.data import wav as jax_wav
from audiodec_tpu.data import dataset as jax_dataset
from audiodec_tpu.data.dataset import SingleDataset as JaxDataset
from audiodec_tpu.models import vocoder as jax_voc
from audiodec_tpu.models.autoencoder import GeneratorConfig as JaxConfig
from audiodec_tpu.models.autoencoder import generator_init
from audiodec_tpu.ops import vq as jax_vq
from audiodec_tpu.train import checkpoint as jax_ckpt
from audiodec_tpu.utils import config as jax_config
from audiodec_tpu.utils.torch_import import import_autoencoder
from audiodec_tpu_torch.bin import codec_test as cli
from audiodec_tpu_torch.data import dataset, wav
from audiodec_tpu_torch.data.dataset import SingleDataset
from audiodec_tpu_torch.models.autoencoder import GeneratorConfig
from audiodec_tpu_torch.models.vocoder import VocoderConfig
from audiodec_tpu_torch.ops import vq
from audiodec_tpu_torch.ops.kernels import folded_stack
from audiodec_tpu_torch.utils import checkpoint, config
from audiodec_tpu_torch.utils.bridge import (
    params_from_jax,
    params_to_jax,
    vocoder_params_from_jax,
    vocoder_params_to_jax,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"),
                           recursive=True)) + [
    os.path.join(ROOT, "exp_ref", "symAD_short", "config.yml")]
SMALL = dict(encode_channels=4, decode_channels=4, code_dim=16,
             codebook_num=4, codebook_size=32)
SR = 48000
WAV_LENGTHS = (5100, 3000, 4500, 2400)   # none a multiple of the hop


def _leaves(t, path=""):
    if isinstance(t, dict):
        for k in sorted(t):
            yield from _leaves(t[k], f"{path}/{k}")
    elif isinstance(t, (list, tuple)):
        for i, v in enumerate(t):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, t


def _assert_trees_equal(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert set(la) == set(lb)
    for k in la:
        x, y = np.asarray(la[k]), np.asarray(lb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.fixture(scope="module")
def small():
    data = np.load(os.path.join(GOLDEN, "gen_small.npz"))
    sd = {k[len("sd__"):]: data[k] for k in data.files
          if k.startswith("sd__")}
    jcfg = JaxConfig(**SMALL)
    jparams = jax.tree_util.tree_map(np.asarray, import_autoencoder(sd, jcfg))
    x = (0.3 * np.random.default_rng(0)
         .standard_normal((2, 2400, 1))).astype(np.float32)
    return jcfg, jparams, x


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", CONFIGS,
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_yaml_reader_matches_load_config(path):
    assert config.load_config(path) == jax_config.load_config(path)


def test_yaml_scalars_and_nesting_match_pyyaml():
    text = ("a: 1e-12\nb: 2.0e-4\nc: [1, [2, 3], \"x\", 'y''z']\n"
            "d:\n- - 1\n  - 2\n- [3]\ne: ~\nf: yes\ng: .inf\nh: -.5\n"
            "i: 1_000\nj: \"a\\tb\"\nk: ''\nl: [ ]\nm:\n  - x: 1\n"
            "    y: 2\n  - z  # comment\nn: null\no: -7\np: OFF\n")
    assert config.parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a: &x 1", "a: {b: 1}", "a: |\n  x", "a: 0x10", "a: 010",
    "a: 2001-01-01", "a: b: c", "---\na: 1", "a: !!str 1", "a: 1:20",
    "a: [1, 2", "a:\n\tb: 1", "a: x\n  y"])
def test_yaml_reader_raises_on_other_constructs(text):
    with pytest.raises(ValueError):
        config.parse_yaml(text)


def test_generator_config_matches_jax():
    for path in CONFIGS:
        d = jax_config.load_config(path)
        if d.get("model_type") not in ("symAudioDec", "HiFiGAN"):
            continue
        ours, theirs = (config.generator_config(config.load_config(path)),
                        jax_config.generator_config(d))
        assert type(ours).__name__ == type(theirs).__name__
        assert {f: getattr(ours, f) for f in ours.__dataclass_fields__} == \
            {f: getattr(theirs, f) for f in ours.__dataclass_fields__}, path


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_written(tmp_path_factory):
    """A JAX-written checkpoint holding a narrow generator with one
    weight-normed {v, g} conv, a numpy scalar and python leaves."""
    jcfg = JaxConfig(**SMALL)
    params = jax.tree_util.tree_map(
        np.asarray, generator_init(jax.random.PRNGKey(0), jcfg))
    w = params["decoder"]["conv2"]["w"]
    params["decoder"]["conv2"] = {
        **params["decoder"]["conv2"], "v": 3.0 * w,
        "g": 1.5 * np.sqrt((w * w).sum(axis=(0, 1), keepdims=True))}
    del params["decoder"]["conv2"]["w"]
    state = {"gen": params, "steps": np.int64(7), "lr": 1.5, "ok": True,
             "big": 70000, "neg": -300}
    path = str(tmp_path_factory.mktemp("ckpt") / "jax.ckpt")
    jax_ckpt.save_checkpoint(path, state, 3, {"note": "x"})
    return path, jcfg


def test_checkpoint_reader_matches_jax(jax_written):
    path, jcfg = jax_written
    ours, h1 = checkpoint.load_checkpoint(path)
    theirs, h2 = jax_ckpt.load_checkpoint(path)
    assert h1 == h2 == {"steps": 3, "note": "x"}
    _assert_trees_equal(ours, theirs)
    template = generator_init(jax.random.PRNGKey(1), jcfg)
    p_ours, _ = checkpoint.load_only_params(path, "gen")
    p_theirs, _ = jax_ckpt.load_only_params(path, "gen", template=template)
    p_theirs = jax.tree_util.tree_map(np.asarray, p_theirs)
    # the {v, g} conv is folded in f32, by numpy here and XLA there
    fold = ("decoder", "conv2", "w")
    np.testing.assert_allclose(p_ours["decoder"]["conv2"]["w"],
                               p_theirs["decoder"]["conv2"]["w"], rtol=1e-6)
    assert isinstance(p_ours["encoder"]["blocks"], list)
    for d in (p_ours, p_theirs):
        d["decoder"]["conv2"].pop(fold[-1])
    _assert_trees_equal(p_ours, p_theirs)


def test_checkpoint_writer_loads_in_jax(jax_written, tmp_path):
    path, jcfg = jax_written
    state, header = checkpoint.load_checkpoint(path)
    ours = str(tmp_path / "port.ckpt")
    checkpoint.save_checkpoint(ours, state, header["steps"], {"note": "x"})
    theirs, h = jax_ckpt.load_checkpoint(ours)
    assert h == header
    _assert_trees_equal(theirs, jax_ckpt.load_checkpoint(path)[0])
    # a port tree (lists, python leaves) restores onto JAX's template
    params = jax.tree_util.tree_map(
        np.asarray, generator_init(jax.random.PRNGKey(2), jcfg))
    p2 = str(tmp_path / "gen.ckpt")
    checkpoint.save_checkpoint(p2, {"gen": params_to_jax(
        params_from_jax(params))}, 0)
    restored, _ = jax_ckpt.load_only_params(
        p2, "gen", template=generator_init(jax.random.PRNGKey(3), jcfg))
    _assert_trees_equal(jax.tree_util.tree_map(np.asarray, restored), params)


def test_checkpoint_reader_raises_on_unknown_forms(tmp_path):
    for payload in (b"\xd4\x05\x00",                    # ext type 5
                    b"\x81\xb9__msgpack_chunked_array__\xc3",
                    b"\xc1"):                            # never used
        path = tmp_path / "bad.ckpt"
        path.write_bytes((2).to_bytes(8, "little") + b"{}" + payload)
        with pytest.raises(ValueError):
            checkpoint.load_checkpoint(str(path))


def test_bridge_inverses(small):
    _, jparams, _ = small
    _assert_trees_equal(params_to_jax(params_from_jax(jparams)), jparams)
    vcfg = jax_voc.VocoderConfig(in_channels=16, channels=32,
                                 upsample_scales=(5, 5, 4, 3),
                                 upsample_kernel_sizes=(10, 10, 8, 6),
                                 resblock_kernel_sizes=(11,),
                                 resblock_dilations=((1, 3, 5),), groups=3,
                                 stats=True)
    jvoc = jax.tree_util.tree_map(
        np.asarray, jax_voc.vocoder_init(jax.random.PRNGKey(0), vcfg))
    _assert_trees_equal(vocoder_params_to_jax(vocoder_params_from_jax(jvoc)),
                        jvoc)


# ---------------------------------------------------------------------------
# wav I/O, PCM16, the batch plan
# ---------------------------------------------------------------------------

@pytest.fixture
def numpy_wav(monkeypatch):
    """JAX's wav module on its numpy path (no native library)."""
    monkeypatch.setattr(jax_wav, "_native", lambda: None)
    return jax_wav


def test_write_wav_bytes_match(numpy_wav, tmp_path):
    rng = np.random.default_rng(0)
    edges = np.array([0.5, -0.5, 1.5, -1.5, 32767.5, -32768.5, 40000,
                      -40000, 0.49999997 * 2]) / 32768.0
    data = {"float": np.concatenate([rng.uniform(-1.2, 1.2, 997),
                                     edges]).astype(np.float32),
            "stereo": rng.uniform(-1, 1, (300, 2)).astype(np.float32),
            "int16": rng.integers(-32768, 32768, 500).astype(np.int16)}
    for name, x in data.items():
        a, b = tmp_path / f"{name}_a.wav", tmp_path / f"{name}_b.wav"
        wav.write_wav(str(a), x, 24000)
        numpy_wav.write_wav(str(b), x, 24000)
        assert a.read_bytes() == b.read_bytes(), name


def test_read_wav_matches(numpy_wav, tmp_path):
    rng = np.random.default_rng(1)
    pcm = tmp_path / "pcm16.wav"
    numpy_wav.write_wav(str(pcm), rng.uniform(-1, 1, (400, 2)), SR)
    f32 = tmp_path / "f32.wav"
    x = rng.uniform(-1, 1, 300).astype("<f4")
    payload = x.tobytes()
    import struct
    f32.write_bytes(
        b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
        + b"fmt " + struct.pack("<IHHIIHH", 16, 3, 1, SR, SR * 4, 4, 32)
        + b"data" + struct.pack("<I", len(payload)) + payload)
    for path in (pcm, f32):
        a, sa = wav.read_wav(str(path))
        b, sb = numpy_wav._py_read(str(path))
        assert sa == sb and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
        assert wav.wav_info(str(path)) == numpy_wav.wav_info(str(path))
        assert wav.wav_is_pcm16(str(path)) == numpy_wav.wav_is_pcm16(
            str(path)) == (path == pcm)
    a, _ = wav.read_wav_pcm16(str(pcm))
    b, _ = numpy_wav.read_wav_pcm16(str(pcm))
    np.testing.assert_array_equal(a, b)
    assert wav.read_wav_pcm16(str(f32)) is None
    # int16 / 32768 on the device is the float read
    np.testing.assert_array_equal(a.astype(np.float32) / 32768.0,
                                  wav.read_wav(str(pcm))[0])


def test_pcm16_matches_jax():
    rng = np.random.default_rng(2)
    y = np.concatenate([rng.uniform(-1.1, 1.1, 4000),
                        np.arange(-6, 7) * 0.5 / 32768.0,
                        [32767.5 / 32768, -32768.5 / 32768]]
                       ).astype(np.float32)
    ours = cli._pcm16(torch.from_numpy(y))
    assert ours.dtype == torch.int16
    np.testing.assert_array_equal(ours.numpy(),
                                  np.asarray(jax_cli._pcm16(jnp.asarray(y))))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Seeded PCM16 wavs of different lengths, written by JAX's writer."""
    d = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(3)
    for i, n in enumerate(WAV_LENGTHS):
        x = np.clip(0.3 * rng.standard_normal((n, 1)), -1, 1)
        jax_wav.write_wav(str(d / f"utt{i}.wav"), x.astype(np.float32), SR)
    return str(d)


def test_dataset_matches_jax(corpus, tmp_path):
    assert dataset.find_files(corpus) == jax_dataset.find_files(corpus)
    assert (dataset.find_files(corpus, include_root_dir=False)
            == jax_dataset.find_files(corpus, include_root_dir=False))
    assert (dataset.load_files(corpus, num_core=3)
            == jax_dataset.load_files(corpus, num_core=3))
    listing = tmp_path / "list.txt"
    listing.write_text("\n".join(reversed(dataset.find_files(corpus))))
    for files in (corpus, str(listing)):
        ours = SingleDataset(files, return_utt_id=True, subset_num=3)
        theirs = JaxDataset(files, return_utt_id=True, subset_num=3)
        assert ours.utt_ids == theirs.utt_ids and len(ours) == 3
        for i in range(len(ours)):
            assert ours.num_frames(i) == theirs.num_frames(i)
            (u1, a), (u2, b) = ours[i], theirs[i]
            assert u1 == u2
            np.testing.assert_array_equal(a, b)


def test_plan_buckets_match(corpus):
    ours = cli.plan_buckets(SingleDataset(corpus, return_utt_id=True), 3,
                            300)
    theirs = jax_cli.plan_buckets(JaxDataset(corpus, return_utt_id=True), 3,
                                  300)
    assert ours == theirs
    ds = SingleDataset(corpus, return_utt_id=True)
    uids, batch, lens = cli.load_planned_batch(ds, ours[0], pcm16_in=True)
    j_uids, j_batch, j_lens = jax_cli.load_planned_batch(
        JaxDataset(corpus, return_utt_id=True), theirs[0], pcm16_in=True)
    assert uids == j_uids and lens == j_lens and batch.dtype == np.int16
    np.testing.assert_array_equal(batch, j_batch)
    got = list(cli.bucket_batches(ds, 3, 300, prefetch=1))
    assert [g[0] for g in got] == [[ds.utt_ids[i] for i in p[0]]
                                   for p in ours]


# ---------------------------------------------------------------------------
# the transcoder
# ---------------------------------------------------------------------------

def test_int16_batch_encodes_as_float(small):
    """A PCM16 batch gives the indices of the same batch read as float
    (JAX normalizes int16 by 1/32768 on the device,
    audiodec_tpu/bin/codec_test.py:311-315)."""
    jcfg, jparams, x = small
    pcm = np.clip(np.round(x * 32768), -32768, 32767).astype(np.int16)
    tc = cli.BatchTranscoder(params_from_jax(jparams),
                             GeneratorConfig(**SMALL), device="cpu")
    idx16 = tc.encode(pcm)
    idxf = tc.encode(pcm.astype(np.float32) / 32768.0)
    assert torch.equal(idx16, idxf)
    jidx = jax_cli.BatchTranscoder(
        jax.tree_util.tree_map(jnp.asarray, jparams), jcfg,
        stack="folded").encode(jnp.asarray(pcm))
    np.testing.assert_array_equal(idx16.numpy(), np.asarray(jidx))


def test_two_pass_argmin_equals_vq_nearest():
    rng = np.random.default_rng(4)
    z = torch.from_numpy(rng.standard_normal((3, 50, 16)).astype(np.float32))
    embed = torch.from_numpy(rng.standard_normal((64, 16))
                             .astype(np.float32))
    embed[7] = embed[3]   # a tie: the lowest index wins
    z[0, 0] = embed[3]
    one = vq.vq_nearest(z, embed)
    two = vq.vq_nearest_2pass(z, embed, k=16)
    assert two.dtype == torch.int32 and int(two[0, 0]) == 3
    assert torch.equal(one, two)
    np.testing.assert_array_equal(
        two.numpy(), np.asarray(jax_vq.vq_nearest_2pass(
            jnp.asarray(z.numpy()), jnp.asarray(embed.numpy()), k=16)))
    params = {"embed": embed[None].repeat(3, 1, 1)}
    zq1, i1 = vq.rvq_forward_index(z, params)
    zq2, i2 = vq.rvq_forward_index(z, params, exact_k=16)
    assert torch.equal(i1, i2) and torch.equal(zq1, zq2)


def test_int8_decode_matches_jax(small, monkeypatch):
    """BatchTranscoder(int8_decode=True) against JAX's with stack="folded":
    equal indices; every decoder stack (C = 32, 16, 8, 4) in the int8
    mode with f32 params.  Where the two packages' f32 roundings differ an
    activation's int8 code can move by one step (see
    tests/test_torch_int8_stack.py), twice the half step by which the int8
    decode's own rounding moves a code; so the waveform is held within
    twice the int8 decode's own error, its largest difference from JAX's
    f32 decode of the same indices.  Measured: 8.6e-3 of the peak against
    a bound of 2.2e-2."""
    jcfg, jparams, x = small
    jidx, jy = jax_cli.BatchTranscoder(
        jax.tree_util.tree_map(jnp.asarray, jparams), jcfg, stack="folded",
        dec_dtype=jnp.bfloat16, int8_decode=True)(x)
    calls = []
    real = folded_stack.folded_residual_stack
    monkeypatch.setattr(
        "audiodec_tpu_torch.models.fast.folded_residual_stack",
        lambda *a, **k: calls.append((a[0].shape[1], a[0].dtype,
                                      k.get("int8_dots"))) or real(*a, **k))
    tc = cli.BatchTranscoder(params_from_jax(jparams),
                             GeneratorConfig(**SMALL), stack="folded",
                             dec_dtype=torch.bfloat16, int8_decode=True,
                             device="cpu")
    assert tc.int8_decode and tc.dec_dtype == torch.float32
    idx, y = tc(x)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    int8_calls = [cl for cl in calls if cl[2]]
    assert int8_calls == [(c, torch.float32, True) for c in (32, 16, 8, 4)]
    jy = np.asarray(jy)
    peak = float(np.abs(jy).max())
    assert peak > 0.01
    jf = np.asarray(jax_cli.BatchTranscoder(
        jax.tree_util.tree_map(jnp.asarray, jparams), jcfg,
        stack="folded").decode(jidx))
    own = float(np.abs(jf - jy).max())
    assert float(np.abs(y.numpy() - jy).max()) <= 2 * own


def test_int8_downgrade_with_vocoder_warns_as_jax(small):
    """A vocoder pair cannot take the int8 decode: both packages warn with
    the same text and decode in dec_dtype, here bf16: the mixed decode."""
    jcfg, jparams, x = small
    vkw = dict(in_channels=16, channels=32, upsample_scales=(5, 5, 4, 3),
               upsample_kernel_sizes=(10, 10, 8, 6),
               resblock_kernel_sizes=(11,), resblock_dilations=((1, 3, 5),),
               groups=3, stats=True)
    jvcfg = jax_voc.VocoderConfig(**vkw)
    jvoc = jax.tree_util.tree_map(
        np.asarray, jax_voc.vocoder_init(jax.random.PRNGKey(0), jvcfg))
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jax_cli.BatchTranscoder(jparams, jcfg, voc=(jvoc, jvcfg),
                                dec_dtype=jnp.bfloat16, int8_decode=True)
    voc = (vocoder_params_from_jax(jvoc), VocoderConfig(**vkw))
    params = params_from_jax(jparams)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tc = cli.BatchTranscoder(params, GeneratorConfig(**SMALL), voc=voc,
                                 dec_dtype=torch.bfloat16, int8_decode=True,
                                 device="cpu")
    jmsg = [str(m.message) for m in jw if "int8" in str(m.message)]
    assert [str(m.message) for m in w] == jmsg and len(jmsg) == 1
    assert not tc.int8_decode and tc.dec_dtype == torch.bfloat16
    mixed = cli.BatchTranscoder(params, GeneratorConfig(**SMALL), voc=voc,
                                dec_dtype=torch.bfloat16, device="cpu")
    idx = mixed.encode(x)
    assert torch.equal(tc.decode(idx), mixed.decode(idx))


# ---------------------------------------------------------------------------
# the slice as a whole: main() against JAX's main()
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def narrow_checkpoint(tmp_path_factory, small):
    """gen_small's weights as a JAX-written checkpoint, its config.yml an
    `inherit:` of the full symAD config narrowed to gen_small's widths."""
    _, jparams, _ = small
    d = tmp_path_factory.mktemp("exp")
    with open(os.path.join(ROOT, "configs", "autoencoder",
                           "symAD_vctk_48000_hop300.yaml")) as f:
        (d / "base.yaml").write_text(f.read())
    (d / "config.yml").write_text(
        "inherit: base.yaml\ngenerator_params:\n"
        + "".join(f"    {k}: {v}\n" for k, v in SMALL.items()))
    path = str(d / "checkpoint-1.ckpt")
    jax_ckpt.save_checkpoint(path, {"gen": jparams}, 1)
    return path


def _outputs(outdir):
    files = sorted(os.listdir(outdir))
    return files, {f: wav.read_wav_pcm16(os.path.join(outdir, f))[0][:, 0]
                   .astype(np.int32) for f in files}


def _json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("mode", ["float32", "int8-decode"])
def test_main_matches_jax_main(mode, narrow_checkpoint, corpus, tmp_path,
                               capsys):
    """float32 --stack plain with the batch folds off (JAX: --stack xla,
    the same) and int8-decode --stack folded (JAX: the same): the same
    files, of the same lengths.  PCM16 samples agree within 1 LSB in float32.  In
    int8-decode an activation's int8 code can move by one step where the
    two packages' f32 roundings differ (tests/test_torch_int8_stack.py),
    where the int8 decode's own rounding moves each code by at most half a
    step; so the bound is 1 LSB plus twice the int8 decode's own error,
    the largest difference between JAX's int8-decode output and its
    float32 output on the same indices (--stack folded).  Measured: 35 LSB
    against a bound of 75 (own error 37 LSB of a peak near 3400)."""
    common = ["--encoder", narrow_checkpoint, "--decoder", narrow_checkpoint,
              "--data-path", corpus, "--batch-size", "3"]
    if mode == "float32":
        folds_off = ["--encode-fold", "off", "--decode-fold", "off"]
        ours_args = ["--stack", "plain"] + folds_off
        jax_args = ["--stack", "xla"] + folds_off
    else:
        ours_args = jax_args = ["--stack", "folded"]
    jax_cli.main(common + jax_args + ["--dtype", mode,
                                      "--outdir", str(tmp_path / "jax")])
    theirs = _json(capsys)
    ours = cli.main(common + ours_args + ["--dtype", mode, "--device", "cpu",
                                          "--outdir", str(tmp_path / "port")])
    assert _json(capsys) == ours
    assert ours["utterances"] == theirs["utterances"] == len(WAV_LENGTHS)
    assert ours["audio_seconds"] == theirs["audio_seconds"]
    assert ours["hosts"] == 1
    files, got = _outputs(tmp_path / "port")
    jfiles, want = _outputs(tmp_path / "jax")
    assert files == jfiles == [f"utt{i}_output.wav"
                               for i in range(len(WAV_LENGTHS))]
    assert max(int(np.abs(w).max()) for w in want.values()) > 300
    bound = 1
    if mode == "int8-decode":
        jax_cli.main(common + jax_args + ["--dtype", "float32",
                                          "--outdir", str(tmp_path / "f32")])
        _, f32 = _outputs(tmp_path / "f32")
        bound += 2 * max(int(np.abs(want[f] - f32[f]).max()) for f in files)
    for f in files:
        assert len(got[f]) == len(want[f]) == WAV_LENGTHS[int(f[3])]
        assert int(np.abs(got[f] - want[f]).max()) <= bound, (f, bound)
