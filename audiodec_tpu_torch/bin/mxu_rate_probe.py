"""The matrix unit's rate on the folded stack's dot shape (counterpart of
tools/mxu_rate_probe.py):

    python -m audiodec_tpu_torch.bin.mxu_rate_probe [--rows 1024]
        [--dots 64] [--tiles 120] [--device cuda]

A chain of `dots` (rows, 128) @ (128, 128) products over `tiles` tiles of
rows, in bf16, int8 (int32 sums) and f32, "chained" (each product reads
the last one's result: dependent latency) and "independent" (all products
of one input, summed: throughput).  Two impls: `kernel`, the CUDA kernel
(`ops/kernels/dot_chain.py`, bf16 and int8 on the tensor cores, f32 on the
FMA units), and `torch`, one PyTorch product per dot (`torch.matmul`,
`torch._int_mm`).  Inputs are the tool's, from `np.random.default_rng(0)`:
int8 in [-80, 80), otherwise x ~ N(0, 1) and w ~ N(0, 1) * 0.09.

Each (dtype, mode, impl) prints one JSON line with the tool's keys (`impl`,
`dtype`, `rows`, `dots_per_tile`, `tiles`, `mode`, `ms`, `tflops`), the
least time the card could take (`bound_ms`, bin/kernel_bounds.py) and the
device.  `ms` is the best of ITERS = 3 calls after a warm-up, as the tool
times, each timed with CUDA events (on the CPU, with the host clock).
`main` returns the records.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from audiodec_tpu_torch.bin import kernel_bounds
from audiodec_tpu_torch.bin.codec_test import require_device
from audiodec_tpu_torch.ops.kernels.dot_chain import (
    WIDTH,
    dot_chain,
    dot_chain_library,
)

DTYPES = (("bfloat16", torch.bfloat16, "bf16"), ("int8", torch.int8, "int8"),
          ("float32", torch.float32, "f32"))
MODES = (("chained", False), ("independent", True))
IMPLS = (("kernel", dot_chain), ("torch", dot_chain_library))
ITERS = 3


def probe_inputs(rng, dtype, m: int, n_dots: int, device):
    """The tool's inputs for one dtype, drawn from `rng` in its order."""
    if dtype == torch.int8:
        x = rng.integers(-80, 80, (m, WIDTH))
        w = rng.integers(-80, 80, (n_dots, WIDTH, WIDTH))
    else:
        x = rng.standard_normal((m, WIDTH))
        w = rng.standard_normal((n_dots, WIDTH, WIDTH)) * 0.09
    return (torch.from_numpy(x).to(device, dtype),
            torch.from_numpy(w).to(device, dtype))


def best_ms(fn, device) -> float:
    """Best of ITERS calls after one warm-up: CUDA events on the card,
    the host clock (after the result is ready) on the CPU."""
    fn()
    best = float("inf")
    for _ in range(ITERS):
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, 1e3 * (time.perf_counter() - t0))
    return best


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Time the dot chain in the kernel and in PyTorch.")
    p.add_argument("--rows", type=int, default=1024)
    p.add_argument("--dots", type=int, default=64)
    p.add_argument("--tiles", type=int, default=120)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> list:
    args = _parser().parse_args(argv)
    device = require_device(args.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    m = args.tiles * args.rows
    flops = 2.0 * m * args.dots * WIDTH * WIDTH
    rng = np.random.default_rng(0)
    records = []
    for dtype_s, dtype, peak in DTYPES:
        x, w = probe_inputs(rng, dtype, m, args.dots, device)
        bound = kernel_bounds.dot_chain(m, args.dots, peak)
        for mode, independent in MODES:
            for impl, fn in IMPLS:
                ms = best_ms(lambda: fn(x, w, independent), device)
                rec = {"impl": impl, "dtype": dtype_s, "rows": args.rows,
                       "dots_per_tile": args.dots, "tiles": args.tiles,
                       "mode": mode, "ms": ms,
                       "tflops": flops / (ms * 1e-3) / 1e12,
                       "bound_ms": bound["bound_ms"], "device": name}
                print(json.dumps(rec), flush=True)
                records.append(rec)
    return records


if __name__ == "__main__":
    main()
