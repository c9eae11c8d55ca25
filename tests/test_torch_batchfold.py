"""The port's batch folds (`models/fast.py` `*_batchfold`, their policies,
and the halos of `parallel/codec.py`) and `BatchTranscoder`'s fold rules
and CLI options, against the JAX package's.

JAX's folds run under one `jax.jit` per input shape that computes every
variant at once, so each shape compiles once.  On the CPU both packages
run true f32, so a fold equals JAX's fold within f32 reassociation.
"""

import glob
import itertools
import os
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from audiodec_tpu.bin import codec_test as jax_cli
from audiodec_tpu.data import wav as jax_wav
from audiodec_tpu.models import fast as jax_fast
from audiodec_tpu.models import vocoder as jax_voc
from audiodec_tpu.models.autoencoder import GeneratorConfig as JaxConfig
from audiodec_tpu.models.autoencoder import encoder_apply as jax_encoder
from audiodec_tpu.models.autoencoder import projector_apply as jax_proj
from audiodec_tpu.ops.vq import rvq_forward_index as jax_rvq
from audiodec_tpu.parallel import codec as jax_par
from audiodec_tpu.train import checkpoint as jax_ckpt
from audiodec_tpu.utils import config as jax_config
from audiodec_tpu.utils.torch_import import import_autoencoder, import_vocoder
from audiodec_tpu_torch.bin import codec_test as cli
from audiodec_tpu_torch.data import wav
from audiodec_tpu_torch.models import fast
from audiodec_tpu_torch.models.autoencoder import (
    GeneratorConfig,
    decoder_apply,
    encoder_apply,
    projector_apply,
)
from audiodec_tpu_torch.models.vocoder import VocoderConfig, vocoder_apply
from audiodec_tpu_torch.ops.vq import rvq_forward_index, rvq_lookup
from audiodec_tpu_torch.parallel import codec as par
from audiodec_tpu_torch.utils import config
from audiodec_tpu_torch.utils.bridge import (
    params_from_jax,
    vocoder_params_from_jax,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
# the shipped configs with a codec generator (symAD-type or HiFiGAN)
CONFIGS = [p for p in sorted(glob.glob(os.path.join(ROOT, "configs", "**",
                                                    "*.yaml"),
                                       recursive=True))
           if config.load_config(p).get("model_type") in ("symAudioDec",
                                                          "HiFiGAN")]
SMALL = dict(encode_channels=4, decode_channels=4, code_dim=16,
             codebook_num=4, codebook_size=32)
# the voc_group golden's config (tests/test_vocoder_parity.py)
VOC = dict(in_channels=16, channels=32, upsample_scales=(5, 5, 4, 3),
           upsample_kernel_sizes=(10, 10, 8, 6), resblock_kernel_sizes=(11,),
           resblock_dilations=((1, 3, 5),), groups=3, stats=True)
FOLDS = (2, 4)
# fold_from / unfold_after: at gen_small's widths "auto" is the whole
# codec (every stack under C = 128), like None and 0; 1 is a partial fold
SPLITS = ("auto", None, 0, 1)
FRAMES = (24, 21)          # 21: not a multiple of either fold
# the encoder's first 25 frames are the direct encoder's (tests/
# test_torch_encoder_fold_start.py), so at 24 and 21 frames the encoder
# cases hold only that; the fold's own frames stand past the halo, at 64
# and at 63 (not a multiple of either fold: the ragged tail)
ENC_FRAMES = FRAMES + (64, 63)
SR = 48000


def _sd(name):
    data = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    return {k[len("sd__"):]: data[k] for k in data.files
            if k.startswith("sd__")}


@pytest.fixture(scope="module")
def codec():
    jcfg = JaxConfig(**SMALL)
    jparams = jax.tree_util.tree_map(
        np.asarray, import_autoencoder(_sd("gen_small"), jcfg))
    return jcfg, jparams, GeneratorConfig(**SMALL), params_from_jax(jparams)


@pytest.fixture(scope="module")
def vocoder():
    jcfg = jax_voc.VocoderConfig(**VOC)
    jtree = jax.tree_util.tree_map(
        np.asarray, import_vocoder(_sd("voc_group"), jcfg))
    return jcfg, jtree, VocoderConfig(**VOC), vocoder_params_from_jax(jtree)


@pytest.fixture(scope="module")
def jax_encoder_folds(codec):
    """{n_frames: (x, {(fold, unfold_after): (h, idx)})} from JAX, each
    distinct computation once ("auto" is the whole encoder at gen_small's
    widths, as None; 0 folds conv0 only), one jit per length.  JAX's fold
    gives its first frames from chunk 0's zero halo, which with gen_small's
    biases is not the direct encoder's zero padding; the port repairs them
    (`fast.encoder_apply_batchfold`), so the reference here is JAX's fold
    with its first `encoder_halo_samples / hop` frames taken from JAX's
    direct encoder."""
    jcfg, jparams, _, _ = codec
    assert jax_fast.encoder_unfold_auto(jcfg) == len(jcfg.enc_strides)
    variants = list(itertools.product(FOLDS, (None, 0, 1)))
    head = jax_par.encoder_halo_samples(jcfg) // jcfg.hop_length
    rng = np.random.default_rng(7)
    out = {}

    @jax.jit
    def run(p, x):
        direct = jax_encoder(p["encoder"], x, jcfg)
        res = []
        for f, u in variants:
            h = jax_fast.encoder_apply_batchfold(p["encoder"], x, jcfg,
                                                 fold=f, unfold_after=u)
            h = jnp.concatenate([direct[:, :head], h[:, head:]], axis=1)
            z = jax_proj(p["projector"], h, jcfg)
            res.append((h, jax_rvq(z, p["quantizer"])[1]))
        return res

    for n in ENC_FRAMES:
        x = (0.3 * rng.standard_normal((2, n * 300, 1))).astype(np.float32)
        got = {v: tuple(np.asarray(a) for a in r)
               for v, r in zip(variants, run(jparams, x))}
        got.update({(f, "auto"): got[(f, None)] for f in FOLDS})
        out[n] = (x, got)
    return out


@pytest.fixture(scope="module")
def jax_decoder_folds(codec, vocoder):
    """{n_frames: (zq, {(fold, fold_from): y}, {(fold, fold_from): y_voc})}
    from JAX, each distinct computation once (fold_from None and 0 are the
    whole fold), one jit per length."""
    jcfg, jparams, _, _ = codec
    vcfg, vtree, _, _ = vocoder
    assert jax_fast.decoder_fold_from_auto(jcfg) == 0
    assert jax_fast.vocoder_fold_from_auto(vcfg) == 0
    variants = list(itertools.product(FOLDS, (0, 1)))
    rng = np.random.default_rng(8)
    out = {}

    @jax.jit
    def run(p, vp, zq):
        dec = [jax_fast.decoder_apply_batchfold(p["decoder"], zq, jcfg,
                                                fold=f, fold_from=s)
               for f, s in variants]
        voc = [jax_fast.vocoder_apply_batchfold(vp, zq, vcfg, fold=f,
                                                fold_from=s)
               for f, s in variants]
        return dec, voc

    for n in FRAMES:
        zq = (0.5 * rng.standard_normal((2, n, 16))).astype(np.float32)
        dec, voc = run(jparams, vtree, zq)
        dec = dict(zip(variants, map(np.asarray, dec)))
        voc = dict(zip(variants, map(np.asarray, voc)))
        for d in (dec, voc):
            d.update({(f, s): d[(f, 0)] for f in FOLDS
                      for s in ("auto", None)})
        out[n] = (zq, dec, voc)
    return out


# ---------------------------------------------------------------------------
# halos and policies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", CONFIGS,
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_halos_and_policies_match_jax(path):
    """The three halos at every from_stage / through_blocks and the fold
    policies, as integers equal to JAX's, for every shipped config."""
    ours = config.generator_config(config.load_config(path))
    theirs = jax_config.generator_config(jax_config.load_config(path))
    if isinstance(ours, VocoderConfig):
        n = len(ours.upsample_scales)
        assert ([par.vocoder_halo_frames(ours, s) for s in range(n + 1)]
                == [jax_par.vocoder_halo_frames(theirs, s)
                    for s in range(n + 1)])
        assert (fast.vocoder_fold_from_auto(ours)
                == jax_fast.vocoder_fold_from_auto(theirs))
        return
    n = len(ours.enc_strides)
    for b in [None, *range(n + 2)]:
        assert (par.encoder_halo_samples(ours, through_blocks=b)
                == jax_par.encoder_halo_samples(theirs, through_blocks=b))
    for s in range(len(ours.dec_strides) + 1):
        assert (par.decoder_halo_frames(ours, s)
                == jax_par.decoder_halo_frames(theirs, s))
    assert fast.encoder_unfold_auto(ours) == jax_fast.encoder_unfold_auto(
        theirs)
    assert (fast.decoder_fold_from_auto(ours)
            == jax_fast.decoder_fold_from_auto(theirs))


def test_batchfold_auto_matches_jax():
    assert [fast.batchfold_auto(n) for n in (1600, 800, 300, 150)] == [
        8, 4, 1, 1]
    for n in range(0, 4000, 7):
        assert fast.batchfold_auto(n) == jax_fast.batchfold_auto(n)
    assert fast.encoder_unfold_auto(GeneratorConfig()) == 2
    assert fast.decoder_fold_from_auto(GeneratorConfig()) == 2


# ---------------------------------------------------------------------------
# the fold functions against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", ENC_FRAMES)
@pytest.mark.parametrize("fold", FOLDS)
def test_encoder_batchfold_matches_jax(codec, jax_encoder_folds, n, fold):
    """The folded encoder's features within rtol 1e-5, atol 1e-6 of JAX's
    (its first frames the direct encoder's), and the indices downstream of
    them equal, for every unfold_after."""
    _, _, cfg, params = codec
    x, want = jax_encoder_folds[n]
    xt = torch.from_numpy(x)
    direct = encoder_apply(params["encoder"], xt, cfg)
    for u in SPLITS:
        h = fast.encoder_apply_batchfold(params["encoder"], xt, cfg,
                                         fold=fold, unfold_after=u)
        jh, jidx = want[(fold, u)]
        assert h.shape == direct.shape == jh.shape
        np.testing.assert_allclose(h.numpy(), jh, rtol=1e-5, atol=1e-6,
                                   err_msg=f"unfold_after={u}")
        z = projector_apply(params["projector"], h, cfg)
        _, idx = rvq_forward_index(z, params["quantizer"])
        np.testing.assert_array_equal(idx.numpy(), jidx)


@pytest.mark.parametrize("n", FRAMES)
@pytest.mark.parametrize("fold", FOLDS)
def test_decoder_batchfold_matches_jax(codec, jax_decoder_folds, n, fold):
    """The folded decoder (head patch on) within rtol 1e-5, atol 1e-6 of
    JAX's for every fold_from, on a waveform far from zero."""
    _, _, cfg, params = codec
    zq, want, _ = jax_decoder_folds[n]
    for s in SPLITS:
        y = fast.decoder_apply_batchfold(params["decoder"],
                                         torch.from_numpy(zq), cfg,
                                         fold=fold, fold_from=s)
        assert y.shape == want[(fold, s)].shape == (2, n * 300, 1)
        assert np.abs(want[(fold, s)]).max() > 1e-3
        np.testing.assert_allclose(y.numpy(), want[(fold, s)], rtol=1e-5,
                                   atol=1e-6, err_msg=f"fold_from={s}")


@pytest.mark.parametrize("n", FRAMES)
@pytest.mark.parametrize("fold", FOLDS)
def test_vocoder_batchfold_matches_jax(vocoder, jax_decoder_folds, n, fold):
    """The folded vocoder (stats, the early stages direct, the tail's
    LeakyReLU, output conv and tanh) within rtol 1e-5, atol 1e-6 of
    JAX's."""
    _, _, vcfg, vparams = vocoder
    zq, _, want = jax_decoder_folds[n]
    for s in SPLITS:
        y = fast.vocoder_apply_batchfold(vparams, torch.from_numpy(zq), vcfg,
                                         fold=fold, fold_from=s)
        assert y.shape == want[(fold, s)].shape
        assert np.abs(want[(fold, s)]).max() > 1e-3
        np.testing.assert_allclose(y.numpy(), want[(fold, s)], rtol=1e-5,
                                   atol=1e-6, err_msg=f"fold_from={s}")


def test_fold_one_is_the_direct_path(codec, vocoder, jax_encoder_folds,
                                     jax_decoder_folds):
    """fold=1 runs the direct path, bit for bit; so does auto at these
    lengths (batchfold_auto(24) = 1).  decode_batchfold is one RVQ lookup
    and the decoder fold."""
    _, _, cfg, params = codec
    _, _, vcfg, vparams = vocoder
    x = torch.from_numpy(jax_encoder_folds[24][0])
    zq = torch.from_numpy(jax_decoder_folds[24][0])
    direct = encoder_apply(params["encoder"], x, cfg)
    for fold in (1, None):
        assert torch.equal(fast.encoder_apply_batchfold(
            params["encoder"], x, cfg, fold=fold), direct)
        assert torch.equal(fast.decoder_apply_batchfold(
            params["decoder"], zq, cfg, fold=fold),
            decoder_apply(params["decoder"], zq, cfg))
        assert torch.equal(fast.vocoder_apply_batchfold(
            vparams, zq, vcfg, fold=fold), vocoder_apply(vparams, zq, vcfg))
    idx = torch.randint(0, 32, (2, 24, 4), generator=torch.Generator()
                        .manual_seed(0), dtype=torch.int32)
    zq_lookup = rvq_lookup(idx, params["quantizer"])
    assert torch.equal(
        fast.decode_batchfold(params["decoder"], params["quantizer"], idx,
                              cfg, dec_dtype=torch.float32, fold=2),
        fast.decoder_apply_batchfold(params["decoder"], zq_lookup, cfg,
                                     fold=2))


def test_head_patch_writes_a_new_tensor(codec):
    """Without the head patch the first halo's samples come from the zero
    halo and differ from the direct decode; with it they equal it, and the
    rest is the same tensor's values."""
    _, _, cfg, params = codec
    zq = torch.from_numpy((0.5 * np.random.default_rng(9)
                           .standard_normal((2, 24, 16))).astype(np.float32))
    h = par.decoder_halo_frames(cfg) * cfg.hop_length
    ref = decoder_apply(params["decoder"], zq, cfg)
    raw = fast.decoder_apply_batchfold(params["decoder"], zq, cfg, fold=2,
                                       fold_from=None, head_patch=False)
    got = fast.decoder_apply_batchfold(params["decoder"], zq, cfg, fold=2,
                                       fold_from=None)
    assert not torch.allclose(raw[:, :h], ref[:, :h], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
    assert torch.equal(got[:, h:], raw[:, h:])


# ---------------------------------------------------------------------------
# BatchTranscoder's fold rules and the command line
# ---------------------------------------------------------------------------

DTYPES = {"float32": (torch.float32, None, jnp.float32, None),
          "bfloat16": (torch.bfloat16, None, jnp.bfloat16, None),
          "mixed": (torch.float32, torch.bfloat16, jnp.float32,
                    jnp.bfloat16)}
FOLD_ARGS = {"auto": None, "off": False, "1": 1, "4": 4}


@pytest.mark.parametrize("voc", [False, True], ids=["symAD", "vocoder"])
@pytest.mark.parametrize("precision", ["default", "exact", "highest"])
@pytest.mark.parametrize("stack", ["folded", "plain"])
def test_fold_policy_matches_jax(codec, vocoder, stack, precision, voc):
    """fold_policy equals JAX's over dtype mode x int8 x encode fold x
    decode fold, each package's precision mapped as its own CLI maps it:
    JAX's exact passes exact_k and enc_precision="high", highest --stack
    xla and encode_fold=False; the port's exact passes exact_k and
    encode_fold=False, highest --stack plain and encode_fold=False.  JAX's
    transcoder jits lazily, so building one compiles nothing."""
    jcfg, jparams, cfg, params = codec
    jvoc = (vocoder[1], vocoder[0]) if voc else None
    pvoc = (vocoder[3], vocoder[2]) if voc else None
    jstack = {"folded": "folded", "plain": "xla"}[stack]
    pstack = stack
    jkw, pkw = {}, {}
    if precision == "exact":
        jkw = {"exact_k": 16, "enc_precision": "high"}
        pkw = {"exact_k": 16}
    elif precision == "highest":
        jstack, pstack = "xla", "plain"
    for (mode, (pdt, pdec, jdt, jdec)), int8, ef, df in itertools.product(
            DTYPES.items(), (False, True), FOLD_ARGS, FOLD_ARGS):
        jef = pef = FOLD_ARGS[ef]
        if precision == "highest":
            jef = False
        if precision != "default":
            pef = False
        with warnings.catch_warnings():
            # the int8 downgrade of a vocoder pair warns in both packages
            warnings.simplefilter("ignore")
            theirs = jax_cli.BatchTranscoder(
                jparams, jcfg, voc=jvoc, dtype=jdt, stack=jstack,
                dec_dtype=jdec, int8_decode=int8, encode_fold=jef,
                decode_fold=FOLD_ARGS[df], **jkw)
            ours = cli.BatchTranscoder(
                params, cfg, voc=pvoc, dtype=pdt, stack=pstack,
                dec_dtype=pdec, int8_decode=int8, encode_fold=pef,
                decode_fold=FOLD_ARGS[df], device="cpu", **pkw)
        assert ours.fold_policy == theirs.fold_policy, (mode, int8, ef, df)


@pytest.fixture(scope="module")
def narrow_checkpoint(tmp_path_factory, codec):
    """gen_small's weights as a JAX-written checkpoint beside an `inherit:`
    of the symAD config narrowed to gen_small's widths, and a corpus of
    seeded PCM16 wavs."""
    _, jparams, _, _ = codec
    d = tmp_path_factory.mktemp("fold_exp")
    with open(os.path.join(ROOT, "configs", "autoencoder",
                           "symAD_vctk_48000_hop300.yaml")) as f:
        (d / "base.yaml").write_text(f.read())
    (d / "config.yml").write_text(
        "inherit: base.yaml\ngenerator_params:\n"
        + "".join(f"    {k}: {v}\n" for k, v in SMALL.items()))
    path = str(d / "checkpoint-1.ckpt")
    jax_ckpt.save_checkpoint(path, {"gen": jparams}, 1)
    corpus = d / "wavs"
    corpus.mkdir()
    rng = np.random.default_rng(4)
    for i, n in enumerate((9000, 7350, 6100)):
        x = np.clip(0.3 * rng.standard_normal((n, 1)), -1, 1)
        jax_wav.write_wav(str(corpus / f"utt{i}.wav"), x.astype(np.float32),
                          SR)
    return path, str(corpus)


def _outputs(outdir):
    files = sorted(os.listdir(outdir))
    return files, {f: wav.read_wav_pcm16(os.path.join(outdir, f))[0][:, 0]
                   .astype(np.int32) for f in files}


@pytest.fixture
def jax_template(monkeypatch, codec):
    """JAX's load_codec builds a parameter template with generator_init,
    which compiles one random draw per weight shape (about 20 s on the
    CPU); the checkpoint is read into the template's tree only, so the
    test hands it the same tree ready-made.  Its compile cache is not
    switched on."""
    monkeypatch.setattr("audiodec_tpu.models.autoencoder.generator_init",
                        lambda key, cfg: codec[1])
    monkeypatch.setattr("audiodec_tpu.utils.profiling.enable_compile_cache",
                        lambda *a: None)


@pytest.mark.parametrize("mode", ["float32", "mixed"])
def test_cli_folds_match_jax(mode, narrow_checkpoint, tmp_path, jax_template):
    """`--stack plain --encode-fold 2 --decode-fold 2` against JAX's
    `--stack xla` with the same folds: the same files of the same lengths.
    float32 (the encode fold): PCM16 within 1 LSB.  mixed (both folds, the
    decoder in bf16): XLA and torch round a bf16 decoder's intermediates
    differently on the CPU, so the two packages' mixed outputs differ by
    tens of LSB with the folds off too (49 LSB of a peak near 3500 here,
    the indices equal); the folded outputs must agree within 1 LSB of
    that, and the port's folded decode stay within a relative L2 of 1e-2
    of its own direct one (the bf16 class)."""
    ckpt, corpus = narrow_checkpoint
    common = ["--encoder", ckpt, "--decoder", ckpt, "--data-path", corpus,
              "--batch-size", "3", "--dtype", mode]
    runs = {}
    for folds in (["2", "2"], ["off", "off"]):
        for pkg, args in (("jax", ["--stack", "xla"]),
                          ("port", ["--stack", "plain", "--device", "cpu"])):
            out = str(tmp_path / f"{pkg}_{folds[0]}")
            (jax_cli if pkg == "jax" else cli).main(
                common + args + ["--encode-fold", folds[0], "--decode-fold",
                                 folds[1], "--outdir", out])
            runs[pkg, folds[0]] = _outputs(out)
        if mode == "float32":
            break
    files, got = runs["port", "2"]
    jfiles, want = runs["jax", "2"]
    assert files == jfiles and len(files) == 3
    assert max(int(np.abs(w).max()) for w in want.values()) > 300
    bound = 1
    if mode == "mixed":
        _, port_off = runs["port", "off"]
        _, jax_off = runs["jax", "off"]
        bound += max(int(np.abs(port_off[f] - jax_off[f]).max())
                     for f in files)
        for f in files:
            rel = (np.linalg.norm(got[f] - port_off[f])
                   / np.linalg.norm(port_off[f]))
            assert rel < 1e-2, (f, rel)
    for f in files:
        assert len(got[f]) == len(want[f])
        assert int(np.abs(got[f] - want[f]).max()) <= bound, (f, bound)
