"""The port's single-file demo (`bin/demo_file.py`) and what it rests on:
the .adtc bitstream (`utils/bitstream.py`) and the model registry
(`models/registry.py`), against the JAX package's copies; and `main` end to
end on a gen_small-width checkpoint, its indices against JAX's
StreamingCodec on the same input.
"""

import os
import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiodec_tpu.models import autoencoder as jax_ae
from audiodec_tpu.models import registry as jax_registry
from audiodec_tpu.streaming import StreamingCodec as JaxStreamingCodec
from audiodec_tpu.utils import bitstream as jax_bitstream
from audiodec_tpu_torch.bin import demo_file
from audiodec_tpu_torch.data.wav import read_wav, write_wav
from audiodec_tpu_torch.models import registry
from audiodec_tpu_torch.models.autoencoder import GeneratorConfig
from audiodec_tpu_torch.models.vocoder import VocoderConfig, vocoder_init
from audiodec_tpu_torch.streaming import StreamingCodec
from audiodec_tpu_torch.utils import bitstream
from audiodec_tpu_torch.utils.bridge import (
    params_from_reference_sd,
    params_to_jax,
    tree_map,
    vocoder_params_to_jax,
)
from audiodec_tpu_torch.utils.checkpoint import save_checkpoint

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
SMALL = dict(encode_channels=4, decode_channels=4, code_dim=16,
             codebook_num=4, codebook_size=32)
SR = 48000
SAMPLES = 9 * 300 + 137   # not a multiple of the hop
VOC = dict(in_channels=16, channels=32, upsample_scales=[5, 5, 4, 3],
           upsample_kernel_sizes=[10, 10, 8, 6])


# ---------------------------------------------------------------------------
# the bitstream and the registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,q,size", [(100, 8, 1024), (7, 3, 17), (1, 1, 2),
                                      (33, 16, 1024), (0, 4, 32)])
def test_pack_codes_bytes_match_jax(t, q, size):
    """The same bytes as JAX's pack_codes, and the round trip."""
    idx = np.random.default_rng(t + q).integers(0, size, (t, q)).astype(
        np.int32)
    assert bitstream.bits_for(size) == jax_bitstream.bits_for(size)
    blob = bitstream.pack_codes(idx, size, SR, 300)
    assert blob == jax_bitstream.pack_codes(idx, size, SR, 300)
    out, info = bitstream.unpack_codes(blob)
    np.testing.assert_array_equal(out, idx)
    assert info == jax_bitstream.unpack_codes(blob)[1]


def test_canonical_bitrate():
    """8 codebooks x 10 bits at 160 frames/s: 12.8 kbps, 1600 bytes a
    second plus the 24-byte header."""
    blob = bitstream.pack_codes(np.zeros((160, 8), np.int32), 1024, SR, 300)
    assert len(blob) == 24 + 1600
    assert bitstream.unpack_codes(blob)[1]["kbps"] == pytest.approx(12.8)


def test_malformed_bitstream_rejected():
    """tests/test_bitstream.py's malformed packets raise ValueError here
    too."""
    good = bitstream.pack_codes(np.zeros((4, 2), np.int32), 16, SR, 300)
    hdr = struct.Struct("<4sBBHIIQ")
    for bad in (good[:10], b"XXXX" + good[4:], good[:4] + b"\x07" + good[5:],
                good[:-1], good + b"\x00",
                hdr.pack(b"ADTC", 1, 2, 4, SR, 300, 1 << 40) + b"\x00" * 8,
                hdr.pack(b"ADTC", 1, 2, 99, SR, 300, 0)):
        with pytest.raises(ValueError):
            bitstream.unpack_codes(bad)


def test_registry_matches_jax():
    assert registry.REGISTRY == jax_registry.REGISTRY
    for name in registry.REGISTRY:
        assert registry.assign_model(name) == jax_registry.assign_model(name)
    with pytest.raises(NotImplementedError):
        registry.assign_model("no_such_model")


# ---------------------------------------------------------------------------
# main end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """gen_small's weights as a JAX-format checkpoint beside an `inherit:`
    of the symAD config narrowed to gen_small's widths, and a seeded wav."""
    data = np.load(os.path.join(GOLDEN, "gen_small.npz"))
    sd = {k[len("sd__"):]: data[k] for k in data.files
          if k.startswith("sd__")}
    cfg = GeneratorConfig(**SMALL)
    params = params_from_reference_sd(sd, cfg)
    exp = tmp_path_factory.mktemp("exp")
    with open(os.path.join(ROOT, "configs", "autoencoder",
                           "symAD_vctk_48000_hop300.yaml")) as f:
        (exp / "base.yaml").write_text(f.read())
    (exp / "config.yml").write_text(
        "inherit: base.yaml\ngenerator_params:\n"
        + "".join(f"    {k}: {v}\n" for k, v in SMALL.items()))
    ckpt = str(exp / "checkpoint-1.ckpt")
    save_checkpoint(ckpt, {"gen": params_to_jax(params)}, 1)
    wav = str(tmp_path_factory.mktemp("wav") / "in.wav")
    x = np.clip(0.3 * np.random.default_rng(0).standard_normal(
        (SAMPLES, 1)), -1, 1).astype(np.float32)
    write_wav(wav, x, SR)
    return cfg, params, ckpt, wav


def test_main_wav_and_codes_match_jax(small, tmp_path):
    """wav to wav, --codes-out and --codes-in on the CPU: the output has the
    input's length; the .adtc's indices equal those of JAX's
    StreamingCodec on the same (hop-padded) input; the PCM16 output is
    within 1 LSB of JAX's decode of them; the bitstream decodes to the
    same samples as the wav-to-wav run."""
    cfg, params, ckpt, wav = small
    out, adtc = str(tmp_path / "out.wav"), str(tmp_path / "codes.adtc")
    res = demo_file.main(["--encoder", ckpt, "--decoder", ckpt, "-i", wav,
                          "-o", out, "--codes-out", adtc,
                          "--device", "cpu"])
    frames = -(-SAMPLES // cfg.hop_length)
    assert res["samples"] == SAMPLES and res["frames"] == frames
    with open(adtc, "rb") as f:
        blob = f.read()
    assert res["kbps"] == pytest.approx(len(blob) * 8 / (SAMPLES / SR)
                                        / 1000)
    raw, info = bitstream.unpack_codes(blob)
    assert info["n_frames"] == frames and info["hop"] == cfg.hop_length
    y, sr = read_wav(out)
    assert sr == SR and y.shape == (SAMPLES, 1)
    assert np.abs(y).max() > 1e-3   # not silence

    x, _ = read_wav(wav)
    x = np.concatenate([x, np.zeros((frames * cfg.hop_length - SAMPLES, 1),
                                    np.float32)])
    jcfg = jax_ae.GeneratorConfig(**SMALL)
    jparams = tree_map(jnp.asarray, params_to_jax(params))
    jcodec = JaxStreamingCodec(jparams, jcfg)
    jidx = np.asarray(jcodec.encode(jnp.asarray(x[None])))
    offsets = np.arange(cfg.codebook_num) * cfg.codebook_size
    np.testing.assert_array_equal(raw + offsets, jidx[0])
    jy = np.asarray(jcodec.decode(jnp.asarray(jidx)))[0, :SAMPLES]
    assert np.abs(np.round(y * 32768) - np.round(jy * 32768)).max() <= 1

    out2 = str(tmp_path / "from_codes.wav")
    res2 = demo_file.main(["--encoder", ckpt, "--decoder", ckpt,
                           "--codes-in", adtc, "-o", out2, "--device", "cpu"])
    assert res2["samples"] == frames * cfg.hop_length
    y2, sr2 = read_wav(out2)
    assert sr2 == SR and y2.shape == (frames * cfg.hop_length, 1)
    np.testing.assert_array_equal(y2[:SAMPLES], y)


def test_main_refuses_a_mismatched_bitstream(small, tmp_path):
    """A .adtc of another codebook count or hop raises ValueError before
    decoding; an input-less call is a usage error."""
    cfg, _, ckpt, _ = small
    for q, hop in ((cfg.codebook_num + 1, cfg.hop_length),
                   (cfg.codebook_num, cfg.hop_length + 20)):
        adtc = tmp_path / f"q{q}_hop{hop}.adtc"
        adtc.write_bytes(bitstream.pack_codes(
            np.zeros((3, q), np.int32), cfg.codebook_size, SR, hop))
        with pytest.raises(ValueError, match="bitstream has"):
            demo_file.main(["--encoder", ckpt, "--decoder", ckpt,
                            "--codes-in", str(adtc), "-o",
                            str(tmp_path / "o.wav"), "--device", "cpu"])
    with pytest.raises(SystemExit):
        demo_file.main(["--encoder", ckpt, "--decoder", ckpt, "-o",
                        str(tmp_path / "o.wav"), "--device", "cpu"])


def test_main_vocoder_pair(small, tmp_path):
    """An encoder and a HiFiGAN decoder checkpoint make the AD v1-style
    receiver: main's wav equals StreamingCodec's decode with the vocoder,
    quantized to PCM16."""
    cfg, params, ckpt, wav = small
    vcfg = VocoderConfig(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in VOC.items()})
    voc = tree_map(lambda a: 30.0 * a,
                   vocoder_init(vcfg, torch.Generator().manual_seed(1)))
    vexp = tmp_path / "voc"
    vexp.mkdir()
    (vexp / "config.yml").write_text(
        "model_type: HiFiGAN\ngenerator_params:\n"
        + "".join(f"    {k}: {v}\n" for k, v in VOC.items()))
    vckpt = str(vexp / "checkpoint-1.ckpt")
    save_checkpoint(vckpt, {"gen": vocoder_params_to_jax(voc)}, 1)
    codec, _ = demo_file.build_streaming_codec(ckpt, vckpt, device="cpu")
    assert codec.voc_cfg == vcfg
    out = str(tmp_path / "out.wav")
    demo_file.main(["--encoder", ckpt, "--decoder", vckpt, "-i", wav,
                    "-o", out, "--device", "cpu"])
    x, _ = read_wav(wav)
    pad = (-SAMPLES) % cfg.hop_length
    x = np.concatenate([x, np.zeros((pad, 1), np.float32)])
    ref = StreamingCodec(dict(params, vocoder=voc), cfg, voc_cfg=vcfg,
                         device="cpu")
    want = ref.decode(ref.encode(x[None]))[0, :SAMPLES].numpy()
    got, _ = read_wav(out)
    assert np.abs(want).max() > 1e-2
    assert np.abs(np.round(got * 32768) - np.round(want * 32768)).max() <= 1


def test_main_defaults_to_the_card(small, monkeypatch, tmp_path):
    """Without --device the stream asks for CUDA: on a machine without it,
    main raises rather than falling back to the CPU."""
    _, _, ckpt, wav = small
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        demo_file.main(["--encoder", ckpt, "--decoder", ckpt, "-i", wav,
                        "-o", str(tmp_path / "out.wav")])
