"""The plain and the fused transcode side by side (counterpart of
tools/fused_probe.py):

    python -m audiodec_tpu_torch.bin.fused_probe [--checkpoint C.ckpt]
        [--batch 16] [--seconds 10] [--iters 4] [--device cuda]

`plain_path` is the true-f32 transcode through plain convs,
`rvq_forward_index` and `rvq_lookup`; `fused_path` runs every residual
stack in the archived residual-stack kernel (csrc/resunit_stack.cu) and
the RVQ in the fused encode kernel (csrc/rvq_encode.cu), and decodes the
kernel's zq.  Weights come from a JAX-format checkpoint with its
config.yml beside it, or, without --checkpoint, from `generator_init` of
the default symAD config with a seeded generator, as the JAX tool uses
`generator_init(PRNGKey(0))`.  Inputs are three seeded (B, T, 1) noise
batches at 0.3.

It prints, as the JAX tool does, ms/iter and the real-time factor of each
path and whether their indices are equal, then one JSON line with those
numbers, the count of indices that differ, and the device they ran on.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from audiodec_tpu_torch.archive.fast_experiments import (
    decoder_apply_fused,
    encoder_apply_fused,
)
from audiodec_tpu_torch.archive.vq_kernel import rvq_encode_pallas
from audiodec_tpu_torch.bin.codec_test import require_device
from audiodec_tpu_torch.models.autoencoder import (
    GeneratorConfig,
    decoder_apply,
    encoder_apply,
    generator_init,
    projector_apply,
)
from audiodec_tpu_torch.ops.vq import rvq_forward_index, rvq_lookup
from audiodec_tpu_torch.utils.bridge import params_from_jax, tree_map
from audiodec_tpu_torch.utils.checkpoint import load_only_params
from audiodec_tpu_torch.utils.config import (
    generator_config,
    load_config_near_checkpoint,
)

SEED = 0


def plain_path(params, x, cfg: GeneratorConfig):
    """True-f32 transcode through plain convs.  x: (B, T, 1) ->
    (idx (B, T', Q), y (B, T, 1))."""
    h = encoder_apply(params["encoder"], x, cfg)
    z = projector_apply(params["projector"], h, cfg)
    _, idx = rvq_forward_index(z, params["quantizer"])
    zq = rvq_lookup(idx, params["quantizer"])
    return idx, decoder_apply(params["decoder"], zq, cfg)


def fused_path(params, x, cfg: GeneratorConfig):
    """The transcode through the two archived kernels: the fused residual
    stacks and the fused RVQ encode, whose zq the decoder reads.
    x: (B, T, 1) float32 -> (idx (B, T', Q), y (B, T, 1))."""
    h = encoder_apply_fused(params["encoder"], x, cfg)
    z = projector_apply(params["projector"], h, cfg)
    zq, idx = rvq_encode_pallas(z, params["quantizer"]["embed"])
    return idx, decoder_apply_fused(params["decoder"], zq, cfg)


def timeit(f, params, xs, cfg: GeneratorConfig, iters: int):
    """Mean wall ms per transcode over `iters` calls on the inputs in turn,
    after one warm-up; each call ends in a device sync.
    -> (ms, the first input's indices)."""
    idx, y = f(params, xs[0], cfg)
    float(y[0, 0, 0])
    t0 = time.perf_counter()
    for i in range(iters):
        _, y = f(params, xs[i % len(xs)], cfg)
        float(y[0, 0, 0])   # waits for the device
    return 1e3 * (time.perf_counter() - t0) / iters, idx


def load_params(checkpoint, device):
    """-> (params on `device`, GeneratorConfig)."""
    if checkpoint:
        cfg = generator_config(load_config_near_checkpoint(checkpoint))
        if not isinstance(cfg, GeneratorConfig):
            raise ValueError(f"{checkpoint} is not a symAD checkpoint")
        tree, _ = load_only_params(checkpoint, "gen")
        params = params_from_jax(tree)
    else:
        cfg = GeneratorConfig()
        params = generator_init(cfg, torch.Generator().manual_seed(SEED))
    return tree_map(lambda a: a.to(device, torch.float32), params), cfg


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Time the plain and the fused transcode.")
    p.add_argument("--checkpoint", default=None,
                   help="JAX-format symAD checkpoint with config.yml beside "
                        "it (default: seeded generator_init)")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    device = require_device(args.device)
    params, cfg = load_params(args.checkpoint, device)
    sr = 48000
    t = int(round(args.seconds * sr / cfg.hop_length)) * cfg.hop_length
    xs = [torch.from_numpy(0.3 * np.random.default_rng(i).standard_normal(
        (args.batch, t, cfg.input_channels)).astype(np.float32)).to(device)
        for i in range(3)]
    audio_s = args.batch * t / sr
    result = {"device": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
              "batch": args.batch, "samples": t, "iters": args.iters}
    for name, f in (("plain", plain_path), ("fused", fused_path)):
        ms, idx = timeit(f, params, xs, cfg, args.iters)
        print(f"{name}: {ms:.1f} ms/iter  rtf={audio_s / (ms / 1e3):.0f}",
              flush=True)
        result[f"{name}_ms"] = ms
        result[f"{name}_rtf"] = audio_s / (ms / 1e3)
        result[f"{name}_idx"] = idx
    i1, i2 = result.pop("plain_idx"), result.pop("fused_idx")
    result["indices_equal"] = bool(torch.equal(i1, i2))
    result["index_flips"] = int((i1 != i2).sum())
    result["indices"] = i1.numel()
    print("indices equal:", result["indices_equal"], flush=True)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
