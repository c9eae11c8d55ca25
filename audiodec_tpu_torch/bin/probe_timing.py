"""Time the two probe kernels on the card: `python -m
audiodec_tpu_torch.bin.probe_timing [--reps 5] [--loops 3]`.

B4, the ablation stack (`ablate_stack.ablate_stack`, csrc/ablate_stack.cu):
the default variant at the symAD stacks' (C, T) = (64, 160000),
(128, 40000), (256, 8000), B = 16, three k = 7 units at dilations
(1, 3, 9), in f32 and in bf16 storage, beside the folded stack's wide route
with bf16 dots at the same shapes (`folded_residual_stack(bf16_dots=True)`,
csrc/wide_stack_mma.cu), on inputs in the ablation probe's recipe
(weights 0.1 N(0, 1), x 0.3 N(0, 1), a generator seeded with C).  Then
every variant at (2, 264, 3996) in both storages on the same recipe (the
inputs of chip_smoke.py's `ablate_inputs(264, 3996, dtype, device, b=2)`),
each held to the plain version and to exact sums: the max error relative
to the peak of the plain version against both, and the plain version's
own against exact sums.  B5, the rate probe's dot chain
(`dot_chain.dot_chain`, csrc/dot_chain.cu): (122880, 128) rows through 64
dots in bf16, int8 and f32, chained and independent, on
bin/mxu_rate_probe.py's inputs, with the TFLOP/s (TOP/s for int8) of
2 M 64 128^2 operations.  Each time is the best of --loops runs of --reps
calls after a warm-up, with CUDA events (bin/int8_timing.py best_ms).
Each call's output has a `checksum`, the sum of its bit patterns as
integers, so two packages' outputs can be seen to agree bit for bit.  It
prints the card's name and power limit as nvidia-smi gives them, then one
JSON line.

It imports only public names that older checkouts of the package have
too, so with PYTHONPATH set to such a checkout's root and the script run
by its path, `import audiodec_tpu_torch` finds the older package (which
builds its kernels under its own build/): PERF.md's A/B ran the parent
and this package so, in turns (old, new, new, old), in one call.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

import audiodec_tpu_torch
from audiodec_tpu_torch.bin.codec_test import require_device
from audiodec_tpu_torch.bin.int8_timing import best_ms
from audiodec_tpu_torch.bin.mxu_rate_probe import probe_inputs
from audiodec_tpu_torch.ops.kernels import ablate_stack, dot_chain
from audiodec_tpu_torch.ops.kernels.folded_stack import folded_residual_stack

STACKS = ((64, 160000), (128, 40000), (256, 8000))
DILATIONS = (1, 3, 9)
BATCH = 16
ACCURACY_SHAPE = (2, 264, 3996)   # (B, C, T) of the accuracy rows
DOT_ROWS, DOT_DOTS = 1024 * 120, 64
DOT_DTYPES = (("bfloat16", torch.bfloat16), ("int8", torch.int8),
              ("float32", torch.float32))


def checksum(out: torch.Tensor) -> int:
    """The sum of the output's bit patterns as integers: equal for outputs
    equal bit for bit (and, in practice, only for those)."""
    bits = {4: torch.int32, 2: torch.int16, 1: torch.int8}[out.element_size()]
    return int(out.contiguous().view(bits).long().sum())


def ablate_inputs(b: int, c: int, t: int, device):
    """Units and f32 x at (b, c, t) in the ablation probe's recipe, from a
    generator seeded with c."""
    gen = torch.Generator(device=device).manual_seed(c)
    units = tuple((0.1 * torch.randn(c, c, 7, generator=gen, device=device),
                   0.1 * torch.randn(c, c, 1, generator=gen, device=device))
                  for _ in DILATIONS)
    return units, 0.3 * torch.randn(b, c, t, generator=gen, device=device)


def ablate_rows(device, reps: int, loops: int) -> list:
    rows = []
    for c, t in STACKS:
        units, x = ablate_inputs(BATCH, c, t, device)
        for dtype in (torch.float32, torch.bfloat16):
            xs = x.to(dtype)
            rows.append({
                "C": c, "T": t, "storage": str(dtype)[6:],
                "checksum": checksum(ablate_stack.ablate_stack(xs, units,
                                                               DILATIONS)),
                "ablate_default_ms": best_ms(
                    lambda: ablate_stack.ablate_stack(xs, units, DILATIONS),
                    reps, loops),
                "wide_stack_ms": best_ms(
                    lambda: folded_residual_stack(
                        xs, units, dilations=DILATIONS, bf16_dots=True),
                    reps, loops)})
        del x, xs
    return rows


def max_rel(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max |out - ref| over the peak of ref, in f32."""
    out, ref = out.float(), ref.float()
    return float((out - ref).abs().max() / ref.abs().max())


def accuracy_rows(device) -> list:
    units, x = ablate_inputs(*ACCURACY_SHAPE, device)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        xs = x.to(dtype)
        for v in ablate_stack.VARIANTS:
            out = ablate_stack.ablate_stack(xs, units, DILATIONS, v)
            plain = ablate_stack.ablate_stack_plain(xs, units, DILATIONS, v)
            exact = ablate_stack.ablate_stack_plain(xs, units, DILATIONS, v,
                                                    exact_sums=True)
            rows.append({"variant": v, "storage": str(dtype)[6:],
                         "checksum": checksum(out),
                         "max_rel": max_rel(out, plain),
                         "exact_max_rel": max_rel(out, exact),
                         "plain_exact_max_rel": max_rel(plain, exact)})
    return rows


def dot_rows(device, reps: int, loops: int) -> list:
    rows = []
    ops = 2 * DOT_ROWS * DOT_DOTS * 128 * 128
    for name, dtype in DOT_DTYPES:
        x, w = probe_inputs(np.random.default_rng(0), dtype, DOT_ROWS,
                            DOT_DOTS, device)
        for mode, independent in (("chained", False), ("independent", True)):
            ms = best_ms(lambda: dot_chain.dot_chain(x, w, independent),
                         reps, loops)
            rows.append({"dtype": name, "mode": mode,
                         "checksum": checksum(dot_chain.dot_chain(
                             x, w, independent)),
                         "ms": ms, "tflops": ops / ms / 1e9})
        del x, w
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--loops", type=int, default=3)
    args = ap.parse_args(argv)
    device = require_device("cuda")
    root = Path(audiodec_tpu_torch.__file__).resolve().parents[1]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    rec = {"package": str(root), "device": torch.cuda.get_device_name(0),
           "nvidia_smi": card,
           "ablate": ablate_rows(device, args.reps, args.loops),
           "accuracy": accuracy_rows(device),
           "dot_chain": dot_rows(device, args.reps, args.loops)}
    rec["seconds"] = time.perf_counter() - t0
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
