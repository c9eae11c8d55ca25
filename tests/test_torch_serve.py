"""The port's transcode server (`bin/codec_serve.py`) on a narrow checkpoint,
mirroring JAX's codec_serve tests (tests/test_cli_e2e.py) without training:
gen_small's weights as a JAX-written checkpoint.

Against the port's codec_test (byte-equal), against JAX's codec_serve
(within 1 LSB), and the server's robustness, watch mode and output names.
"""

import io
import json
import os
import shutil
import struct
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax

from audiodec_tpu.bin import codec_serve as jax_serve
from audiodec_tpu.data import wav as jax_wav
from audiodec_tpu.models.autoencoder import GeneratorConfig as JaxConfig
from audiodec_tpu.train import checkpoint as jax_ckpt
from audiodec_tpu.utils.torch_import import import_autoencoder
from audiodec_tpu_torch.bin import codec_serve, codec_test
from audiodec_tpu_torch.data.wav import read_wav, read_wav_pcm16, write_wav

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
SMALL = dict(encode_channels=4, decode_channels=4, code_dim=16,
             codebook_num=4, codebook_size=32)
SR = 48000
# Both runs must compute the same thing for the bytes to agree.  The CPU
# convs sum in another order at another batch row count, so there are 4
# files: codec_test's batches of 2 and the server's (always 2 rows) have
# the same rows.  The folded route takes a stack or not by its length
# (JAX's `_use_folded` tests T % F): --warmup-seconds 0.05 pads the
# server's batches to multiples of 2400 samples, and codec_test pads each
# batch to its longest file, a multiple of 2400 too (longest first: 4800
# and 4100, then 2400 and 2000).
LENGTHS = (4100, 2400, 4800, 2000)
WARMUP = "0.05"


@pytest.fixture(scope="module")
def jparams():
    data = np.load(os.path.join(GOLDEN, "gen_small.npz"))
    sd = {k[len("sd__"):]: data[k] for k in data.files
          if k.startswith("sd__")}
    return jax.tree_util.tree_map(np.asarray,
                                  import_autoencoder(sd, JaxConfig(**SMALL)))


@pytest.fixture(scope="module")
def workdir(tmp_path_factory, jparams):
    """A narrow checkpoint (an `inherit:` of the symAD config at gen_small's
    widths) and a test corpus of seeded PCM16 wavs."""
    root = tmp_path_factory.mktemp("serve")
    exp = root / "exp"
    exp.mkdir()
    with open(os.path.join(ROOT, "configs", "autoencoder",
                           "symAD_vctk_48000_hop300.yaml")) as f:
        (exp / "base.yaml").write_text(f.read())
    (exp / "config.yml").write_text(
        "inherit: base.yaml\ngenerator_params:\n"
        + "".join(f"    {k}: {v}\n" for k, v in SMALL.items()))
    ckpt = str(exp / "checkpoint-1.ckpt")
    jax_ckpt.save_checkpoint(ckpt, {"gen": jparams}, 1)
    corpus = root / "corpus"
    corpus.mkdir()
    rng = np.random.default_rng(5)
    for i, n in enumerate(LENGTHS):
        x = np.clip(0.3 * rng.standard_normal((n, 1)), -1, 1)
        jax_wav.write_wav(str(corpus / f"test{i}.wav"), x.astype(np.float32),
                          SR)
    return root, ckpt


@pytest.fixture
def jax_template(monkeypatch, jparams):
    """JAX's load_codec builds a parameter template with generator_init,
    which compiles one random draw per weight shape (about 20 s on the
    CPU); the checkpoint is read into the template's tree only, so the
    test hands it the same tree ready-made.  Its compile cache is not
    switched on."""
    monkeypatch.setattr("audiodec_tpu.models.autoencoder.generator_init",
                        lambda key, cfg: jparams)
    monkeypatch.setattr("audiodec_tpu.utils.profiling.enable_compile_cache",
                        lambda *a: None)


def _wavs(root):
    d = root / "corpus"
    return sorted(str(d / f) for f in os.listdir(d) if f.endswith(".wav"))


def _serve(module, ckpt, outdir, feed, monkeypatch, capsys, *args):
    capsys.readouterr()
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(feed) + "\n"))
    module.main(["--encoder", ckpt, "--decoder", ckpt, "--outdir", outdir,
                 "--stdin", "--warmup-seconds", WARMUP, "--batch-size", "2",
                 *args])
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def _codec_test(root, ckpt, outdir, *args):
    codec_test.main(["--encoder", ckpt, "--decoder", ckpt, "--data-path",
                     str(root / "corpus"), "--outdir", outdir,
                     "--batch-size", "2", "--device", "cpu", *args])


def _pcm(path):
    return read_wav_pcm16(path)[0][:, 0].astype(np.int32)


@pytest.mark.parametrize("stack", ["folded", "plain"])
@pytest.mark.parametrize("dtype", ["float32", "mixed"])
def test_serve_stdin_matches_codec_test(workdir, monkeypatch, capsys, dtype,
                                        stack):
    """--stdin: one JSON line per file, and files byte-equal to the port's
    codec_test on the same checkpoint, dtype and stack."""
    root, ckpt = workdir
    ct_out = str(root / f"ct_{dtype}_{stack}")
    _codec_test(root, ckpt, ct_out, "--dtype", dtype, "--stack", stack)
    wavs = _wavs(root)
    outdir = str(root / f"serve_{dtype}_{stack}")
    lines = _serve(codec_serve, ckpt, outdir, wavs, monkeypatch, capsys,
                   "--dtype", dtype, "--stack", stack, "--device", "cpu")
    assert len(lines) == len(LENGTHS)
    assert all(line["batch_rtf"] > 0 for line in lines)
    assert [line["seconds"] for line in lines] == [n / SR for n in LENGTHS]
    outs = sorted(os.listdir(outdir))
    assert outs == [os.path.basename(w).replace(".wav", "_output.wav")
                    for w in wavs]
    for f in outs:
        with open(os.path.join(outdir, f), "rb") as a, \
                open(os.path.join(ct_out, f), "rb") as b:
            assert a.read() == b.read(), f


@pytest.mark.parametrize("precision", ["default", "exact"])
def test_serve_matches_jax_serve(workdir, monkeypatch, capsys, jax_template,
                                 precision):
    """The port's codec_serve --stack plain against JAX's (its default
    --stack xla, the folds at auto), float32, with and without --precision
    exact: the same files, PCM16 within 1 LSB."""
    root, ckpt = workdir
    wavs = _wavs(root)
    common = ["--dtype", "float32", "--precision", precision]
    jlines = _serve(jax_serve, ckpt, str(root / f"jax_{precision}"), wavs,
                    monkeypatch, capsys, *common)
    lines = _serve(codec_serve, ckpt, str(root / f"port_{precision}"), wavs,
                   monkeypatch, capsys, *common, "--stack", "plain",
                   "--device", "cpu")
    assert len(lines) == len(jlines) == len(LENGTHS)
    assert ([os.path.basename(line["output"]) for line in lines]
            == [os.path.basename(line["output"]) for line in jlines])
    peak = 0
    for line, jline in zip(lines, jlines):
        got, want = _pcm(line["output"]), _pcm(jline["output"])
        assert len(got) == len(want)
        assert int(np.abs(got - want).max()) <= 1
        peak = max(peak, int(np.abs(want).max()))
    assert peak > 300


def _write_float_wav(path, x, sr):
    """An IEEE-float32 (format tag 3) wav."""
    x = np.asarray(x, np.float32)
    ch = x.shape[1]
    payload = x.astype("<f4").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 3, ch, sr,
                                      sr * ch * 4, ch * 4, 32))
        f.write(b"data" + struct.pack("<I", len(payload)))
        f.write(payload)


def test_serve_robustness(workdir, monkeypatch, capsys):
    """Bad inputs get one JSON error line each and the server goes on; a
    PCM16 row in a float batch is normalized as the device normalizes a
    PCM16 batch (byte-equal to codec_test's output, as is the float copy
    of the same samples)."""
    root, ckpt = workdir
    ct_out = str(root / "ct_float32_folded")
    if not os.path.isdir(ct_out):
        _codec_test(root, ckpt, ct_out, "--dtype", "float32")
    src_i16 = str(root / "corpus" / "test0.wav")
    src_mono = str(root / "corpus" / "test1.wav")
    x, _ = read_wav(src_i16)
    f32_wav = str(root / "serve_f32.wav")
    _write_float_wav(f32_wav, x, SR)
    bad_sr = str(root / "serve_badsr.wav")
    write_wav(bad_sr, x, 16000)
    garbage = str(root / "serve_garbage.wav")
    with open(garbage, "wb") as f:
        f.write(b"definitely not a RIFF file")
    missing = str(root / "serve_missing.wav")
    stereo = str(root / "serve_stereo.wav")
    write_wav(stereo, np.repeat(x, 2, axis=1), SR)
    empty = str(root / "serve_empty.wav")
    write_wav(empty, np.zeros((0, 1), np.float32), SR)
    # batches of 2 in arrival order: [i16, f32] mixed dtypes; [mono,
    # stereo] channel mismatch; [bad_sr, garbage] all errors; [missing,
    # empty] all errors
    feed = [src_i16, f32_wav, src_mono, stereo, bad_sr, garbage, missing,
            empty]
    outdir = str(root / "serve_robust")
    lines = _serve(codec_serve, ckpt, outdir, feed, monkeypatch, capsys,
                   "--dtype", "float32", "--device", "cpu")
    by_input = {line["input"]: line for line in lines}
    assert len(lines) == len(feed) == len(by_input)
    assert "sample rate" in by_input[bad_sr]["error"]
    assert "read failed" in by_input[garbage]["error"]
    assert "read failed" in by_input[missing]["error"]
    assert "channel count" in by_input[stereo]["error"]
    assert by_input[empty]["error"] == "empty audio"
    for good in (src_i16, f32_wav, src_mono):
        assert "output" in by_input[good], by_input[good]
    with open(os.path.join(ct_out, "test0_output.wav"), "rb") as f:
        ref = f.read()
    for name in ("test0_output.wav", "serve_f32_output.wav"):
        with open(os.path.join(outdir, name), "rb") as f:
            assert f.read() == ref, name


def _watch(ckpt, watch, outdir, feeder):
    t = threading.Thread(target=feeder, daemon=True)
    t.start()
    codec_serve.main(["--encoder", ckpt, "--decoder", ckpt, "--outdir",
                      outdir, "--watch", watch, "--poll", "0.05", "--dtype",
                      "float32", "--warmup-seconds", "0", "--linger", "0.05",
                      "--device", "cpu"])
    t.join(timeout=10)


def _wait_for(pred, deadline_s=60):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def test_serve_watch_stops_on_stop_file(workdir):
    """--watch: a wav dropped into the directory is transcoded, and `.stop`
    ends the server."""
    root, ckpt = workdir
    watch, outdir = str(root / "watch_in"), str(root / "watch_out")
    os.makedirs(watch)
    out = os.path.join(outdir, "job_output.wav")

    def feeder():
        shutil.copy(str(root / "corpus" / "test0.wav"),
                    os.path.join(watch, "job.wav"))
        _wait_for(lambda: os.path.exists(out))
        open(os.path.join(watch, ".stop"), "w").close()

    _watch(ckpt, watch, outdir, feeder)
    assert len(_pcm(out)) == LENGTHS[0]


def test_serve_watch_rotation_bounded_state(workdir):
    """A file deleted and made again under the same name transcodes again
    (the watch state follows the directory), its output overwritten."""
    root, ckpt = workdir
    watch, outdir = str(root / "rot_in"), str(root / "rot_out")
    os.makedirs(watch)
    out = os.path.join(outdir, "rot_output.wav")
    results = {}

    def feeder():
        shutil.copy(str(root / "corpus" / "test0.wav"),
                    os.path.join(watch, "rot.wav"))
        if _wait_for(lambda: os.path.exists(out)):
            with open(out, "rb") as f:
                results["first"] = f.read()
            os.remove(os.path.join(watch, "rot.wav"))
            time.sleep(0.3)  # a poll sees the deletion
            shutil.copy(str(root / "corpus" / "test1.wav"),
                        os.path.join(watch, "rot.wav"))

            def changed():
                with open(out, "rb") as f:
                    return f.read() != results["first"]

            _wait_for(changed)
            with open(out, "rb") as f:
                results["second"] = f.read()
        open(os.path.join(watch, ".stop"), "w").close()

    _watch(ckpt, watch, outdir, feeder)
    assert "first" in results and "second" in results
    assert results["second"] != results["first"]
    assert len(_pcm(out)) == LENGTHS[1]


def test_serve_output_name_collision(workdir, monkeypatch, capsys):
    """Two sources with one basename get two outputs; the same source
    again keeps its output's name."""
    root, ckpt = workdir
    d1, d2 = root / "coll_a", root / "coll_b"
    d1.mkdir()
    d2.mkdir()
    shutil.copy(str(root / "corpus" / "test0.wav"), str(d1 / "same.wav"))
    shutil.copy(str(root / "corpus" / "test1.wav"), str(d2 / "same.wav"))
    feed = [str(d1 / "same.wav"), str(d2 / "same.wav"), str(d1 / "same.wav")]
    outdir = str(root / "coll_out")
    lines = _serve(codec_serve, ckpt, outdir, feed, monkeypatch, capsys,
                   "--dtype", "float32", "--device", "cpu")
    outs = [line["output"] for line in lines]
    assert outs == [os.path.join(outdir, "same_output.wav"),
                    os.path.join(outdir, "same_output.2.wav"),
                    os.path.join(outdir, "same_output.wav")]
    assert sorted(os.listdir(outdir)) == ["same_output.2.wav",
                                          "same_output.wav"]


def test_output_owner_is_bounded(workdir, monkeypatch, capsys):
    """The collision rule remembers at most OUT_OWNER_CAP outputs: past
    it, the oldest owner is forgotten and its name is free again."""
    root, ckpt = workdir
    monkeypatch.setattr(codec_serve, "OUT_OWNER_CAP", 1)
    d1, d2 = root / "cap_a", root / "cap_b"
    d1.mkdir()
    d2.mkdir()
    for d in (d1, d2):
        shutil.copy(str(root / "corpus" / "test0.wav"), str(d / "same.wav"))
        shutil.copy(str(root / "corpus" / "test1.wav"), str(d / "other.wav"))
    feed = [str(d1 / "same.wav"), str(d1 / "other.wav"),
            str(d2 / "same.wav")]
    outdir = str(root / "cap_out")
    lines = _serve(codec_serve, ckpt, outdir, feed, monkeypatch, capsys,
                   "--dtype", "float32", "--device", "cpu")
    assert [os.path.basename(line["output"]) for line in lines] == [
        "same_output.wav", "other_output.wav", "same_output.wav"]
