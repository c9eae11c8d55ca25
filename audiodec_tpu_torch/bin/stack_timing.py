"""Time the residual-stack kernels above the narrow ones on the card:
`python -m audiodec_tpu_torch.bin.stack_timing [--reps 5] [--loops 3]`.

Four measurements, each call held against its plain version on the same
inputs (max error relative to the peak):

  - the archived stack (`archive/resunit_kernel.py fused_residual_stack_bct`,
    true f32) at the fused transcode's eight stacks, (16, C, T) at
    C = 32/64/128/256 and T = 480000/160000/40000/8000, encoder and
    decoder, the trained golden's weights (tests/golden/
    gen_symad_trained.npz), beside their sum;
  - the folded stack's autoencoder mode with bf16 dots
    (`ops/kernels/folded_stack.py folded_residual_stack`) at
    bin/folded_probe.py's shapes above C = 32, (16, C, T) = (16, 64,
    160000), (16, 128, 40000), (16, 256, 8000), on the probe's seeded
    inputs, in f32 and in bf16 storage;
  - the fused transcode (`bin/fused_probe.py fused_path`) of a seeded
    0.3 * N(0, 1) batch of 16 x 10 s at 48 kHz;
  - the fused RVQ encode (`archive/vq_kernel.py rvq_encode_pallas`,
    csrc/rvq_encode.cu) of that batch's z from the true-f32 encoder
    (`archive/fast_experiments.py encoder_apply_fused`, then the
    projector), (16, 1600, 64), against the trained golden's 8 x 1024
    codebooks, with SHA-256 checksums of idx and zq so that two packages'
    outputs can be compared bit for bit (the index flips against the
    plain version, which sums in another order, are printed beside).

Times are CUDA events, the best of --loops runs of --reps calls after a
warm-up call.  It prints the card's name and power limit as nvidia-smi
gives them, then one JSON line.

It imports only public names, which the package has had since
bin/int8_timing.py (whose `load_params` and `best_ms` it shares) was added,
so it also times an older checkout of the package: with PYTHONPATH
set to that checkout's root and the script run by its path,
`import audiodec_tpu_torch` finds the older package (which builds its
kernels under its own build/).  Run old and new in turns in one call.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import time
from pathlib import Path

import torch

import audiodec_tpu_torch
from audiodec_tpu_torch.archive import resunit_kernel, vq_kernel
from audiodec_tpu_torch.archive.fast_experiments import encoder_apply_fused
from audiodec_tpu_torch.bin import folded_probe, fused_probe
from audiodec_tpu_torch.bin.codec_test import require_device
from audiodec_tpu_torch.bin.int8_timing import best_ms, load_params
from audiodec_tpu_torch.models.autoencoder import (
    GeneratorConfig,
    projector_apply,
)
from audiodec_tpu_torch.ops.kernels import folded_stack
from audiodec_tpu_torch.utils.bridge import tree_map

STACKS = ((32, 480000), (64, 160000), (128, 40000), (256, 8000))
WIDE = ((64, 160000), (128, 40000), (256, 8000))
DILATIONS = (1, 3, 9)
BATCH, SECONDS, SR = 16, 10, 48000


def rel_err(out, ref) -> float:
    out, ref = out.float(), ref.float()
    return float((out - ref).abs().max() / ref.abs().max())


def sha256(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--loops", type=int, default=3)
    ap.add_argument("--golden-dir", type=Path, default=None,
                    help="directory of gen_symad_trained.npz (default: "
                         "tests/golden beside the imported package)")
    args = ap.parse_args(argv)
    device = require_device("cuda")
    root = Path(audiodec_tpu_torch.__file__).resolve().parents[1]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    params = load_params(args.golden_dir or root / "tests" / "golden")
    gen = torch.Generator(device=device).manual_seed(0)
    t0 = time.perf_counter()

    archived = []
    for where in ("encoder", "decoder"):
        for i in range(4):
            c, t = STACKS[i if where == "encoder" else 3 - i]
            bp = params[where]["blocks"][i]
            units = tuple((u["conv1"]["w"].to(device),
                           u["conv2"]["w"].to(device)) for u in bp["res"])
            x = torch.randn(BATCH, c, t, generator=gen, device=device)
            err = rel_err(resunit_kernel.fused_residual_stack_bct(
                x, units, dilations=DILATIONS),
                resunit_kernel.fused_residual_stack_plain(x, units,
                                                          DILATIONS))
            archived.append({
                "stack": f"{where} block {i}", "C": c, "T": t,
                "max_rel_err": err,
                "ms": best_ms(lambda: resunit_kernel.fused_residual_stack_bct(
                    x, units, dilations=DILATIONS), args.reps, args.loops)})
            del x

    wide = []
    for c, t in WIDE:
        for name in ("float32", "bfloat16"):
            units, x = folded_probe.probe_inputs(c, t, BATCH,
                                                 getattr(torch, name), device)
            err = rel_err(
                folded_stack.folded_residual_stack(x, units,
                                                   dilations=DILATIONS),
                folded_stack.folded_residual_stack_plain(x, units, DILATIONS,
                                                         True))
            wide.append({"C": c, "T": t, "dtype": name, "max_rel_err": err,
                         "ms": best_ms(
                             lambda: folded_stack.folded_residual_stack(
                                 x, units, dilations=DILATIONS),
                             args.reps, args.loops)})
            del x

    cfg = GeneratorConfig()
    p = tree_map(lambda a: a.to(device, torch.float32), params)
    x = 0.3 * torch.randn(BATCH, SECONDS * SR, 1, generator=gen,
                          device=device)
    transcode_ms = best_ms(lambda: fused_probe.fused_path(p, x, cfg),
                           max(1, args.reps // 2), args.loops)
    z = projector_apply(p["projector"], encoder_apply_fused(p["encoder"], x,
                                                            cfg), cfg)
    embed = p["quantizer"]["embed"]
    zq, idx = vq_kernel.rvq_encode_pallas(z, embed)
    _, idx_p = vq_kernel.rvq_encode_plain(z, embed)
    rvq = {"shape": list(z.shape), "codebooks": list(embed.shape),
           "idx_sha256": sha256(idx), "zq_sha256": sha256(zq),
           "flips_vs_plain": int((idx != idx_p).sum()),
           "ms": best_ms(lambda: vq_kernel.rvq_encode_pallas(z, embed),
                         args.reps * 4, args.loops)}
    rec = {"package": str(root), "device": torch.cuda.get_device_name(0),
           "nvidia_smi": card, "archived_stacks": archived,
           "archived_stacks_ms": sum(r["ms"] for r in archived),
           "wide": wide, "fused_transcode_ms": transcode_ms,
           "fused_rtf": BATCH * SECONDS / (transcode_ms / 1e3),
           "rvq_encode": rvq, "seconds": time.perf_counter() - t0}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
