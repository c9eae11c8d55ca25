"""Single-file codec demo (counterpart of audiodec_tpu/bin/demo_file.py;
ref demoFile.py).

Streams one WAV through the stateful encode -> quantize -> lookup -> decode
path of `streaming/engine.py StreamingCodec` and writes the result, trimmed
to the input length (ref demoFile.py:58-61).  `--codes-out` also writes the
packed RVQ indices (`utils/bitstream.py`, the .adtc format: 12.8 kbps for
8 x 1024 codes at 48 kHz, hop 300, plus a 24-byte header); `--codes-in`
decodes such a file instead of a wav.

    python -m audiodec_tpu_torch.bin.demo_file --encoder E.ckpt \\
        --decoder D.ckpt -i in.wav -o out.wav [--codes-out codes.adtc]
    python -m audiodec_tpu_torch.bin.demo_file --model vctk_v1 \\
        --codes-in codes.adtc -o out.wav

Checkpoints are the JAX format (utils/checkpoint.py), each with its
config.yml beside it; a HiFiGAN decoder config makes the AD v0/v1/v2
receiver.  The stream runs on the card unless given `--device cpu`.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from audiodec_tpu_torch.data.wav import read_wav, write_wav
from audiodec_tpu_torch.models.registry import assign_model
from audiodec_tpu_torch.streaming import StreamingCodec
from audiodec_tpu_torch.utils.bitstream import pack_codes, unpack_codes
from audiodec_tpu_torch.utils.bridge import (
    params_from_jax,
    vocoder_params_from_jax,
)
from audiodec_tpu_torch.utils.checkpoint import load_only_params
from audiodec_tpu_torch.utils.config import (
    generator_config,
    load_config_near_checkpoint,
)


def build_streaming_codec(encoder_ckpt: str, decoder_ckpt: str,
                          device=None):
    """A StreamingCodec from a checkpoint pair: one symAD checkpoint for
    both, or a symAD encoder and a HiFiGAN vocoder.
    -> (codec, the encoder's config dict)."""
    enc_config = load_config_near_checkpoint(encoder_ckpt)
    cfg = generator_config(enc_config)
    tree, _ = load_only_params(encoder_ckpt, "gen")
    params = params_from_jax(tree)
    voc_cfg = None
    if os.path.abspath(decoder_ckpt) != os.path.abspath(encoder_ckpt):
        dec_config = load_config_near_checkpoint(decoder_ckpt)
        if dec_config.get("model_type") in ("HiFiGAN", "UnivNet"):
            voc_cfg = generator_config(dec_config)
            vtree, _ = load_only_params(decoder_ckpt, "gen")
            params = dict(params, vocoder=vocoder_params_from_jax(vtree))
    return (StreamingCodec(params, cfg, voc_cfg=voc_cfg, device=device),
            enc_config)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Stream one wav (or a .adtc bitstream) through the "
                    "codec.")
    p.add_argument("--model", default=None,
                   help="registry name (e.g. vctk_v1)")
    p.add_argument("--encoder", default=None)
    p.add_argument("--decoder", default=None)
    p.add_argument("-i", "--input", default=None)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--codes-out", default=None,
                   help="also write the packed RVQ bitstream (.adtc)")
    p.add_argument("--codes-in", default=None,
                   help="decode a packed RVQ bitstream (.adtc) to wav "
                        "instead of transcoding a wav")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p


def main(argv=None) -> dict:
    """Run the command line; returns what it did: the output's samples and
    sample rate, the frames coded, and with --codes-out the bitrate."""
    parser = _parser()
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    if args.model:
        sr_expected, enc, dec = assign_model(args.model)
    elif args.encoder and args.decoder:
        enc, dec, sr_expected = args.encoder, args.decoder, None
    else:
        parser.error("need --model or --encoder/--decoder")
    if not (args.codes_in or args.input):
        parser.error("need -i/--input (or --codes-in)")

    codec, _ = build_streaming_codec(enc, dec, device=args.device)
    hop, size = codec.cfg.hop_length, codec.cfg.codebook_size
    offsets = np.arange(codec.cfg.codebook_num) * size

    if args.codes_in:
        with open(args.codes_in, "rb") as f:
            raw, info = unpack_codes(f.read())
        if info["num_q"] != codec.cfg.codebook_num or info["hop"] != hop:
            raise ValueError(
                f"bitstream has {info['num_q']} codebooks at hop "
                f"{info['hop']}, the codec {codec.cfg.codebook_num} at hop "
                f"{hop}")
        sr, t = info["sample_rate"], info["n_frames"] * hop
        logging.info("Decode %d frames from %s...", info["n_frames"],
                     args.codes_in)
        y = codec.decode(torch.from_numpy(raw + offsets)[None])
        write_wav(args.output, y[0, :t].float().cpu().numpy(), sr)
        logging.info("Output %s", args.output)
        return {"samples": t, "sample_rate": sr,
                "frames": info["n_frames"]}

    x, sr = read_wav(args.input)
    if sr_expected is not None and sr != sr_expected:
        raise ValueError(f"sample rate {sr} != expected {sr_expected} "
                         f"(demoFile.py:54)")
    t = len(x)
    pad = (-t) % hop
    if pad:
        x = np.concatenate([x, np.zeros((pad, x.shape[1]), np.float32)])

    logging.info("Encode/Decode...")
    idx = codec.encode(torch.from_numpy(x[None]))
    out = {"samples": t, "sample_rate": sr, "frames": idx.shape[1]}
    if args.codes_out:
        # streaming indices are flattened; remove the per-layer offsets
        blob = pack_codes(idx[0].cpu().numpy() - offsets, size, sr, hop)
        with open(args.codes_out, "wb") as f:
            f.write(blob)
        out["kbps"] = len(blob) * 8 / (t / sr) / 1000
        logging.info("Wrote %s (%.2f kbps incl. header)", args.codes_out,
                     out["kbps"])
    y = codec.decode(idx)
    write_wav(args.output, y[0, :t].float().cpu().numpy(), sr)
    logging.info("Output %s", args.output)
    return out


if __name__ == "__main__":
    main()
