"""A/B of the residual stack at every symAD width (counterpart of
tools/folded_probe.py):

    python -m audiodec_tpu_torch.bin.folded_probe [--dtype float32|bfloat16]
        [--batch 16] [--int8] [--device cuda] [--shapes 32:480000,...]

For each residual-stack shape of symAD_vctk_48000_hop300 (C, T) = (32,
480000), (64, 160000), (128, 40000), (256, 8000) at B = 16, dilations
(1, 3, 9), it times the plain chain (F.elu / F.conv1d in the working dtype,
TF32 off) and, at each fold f in {128 / C, 256 / C, 512 / C} (at least 1)
that divides T, with the tool's tile_rows (1024, 512 or 256 by f * C), the
folded stack's autoencoder mode with bf16 dots
(`ops/kernels/folded_stack.py`: csrc/folded_stack_mma.cu at C = 32,
csrc/wide_stack_mma.cu above); with --int8 also its int8 modes with "row"
scales (csrc/int8_mma_stack.cu) and "tile" scales (csrc/int8_tile_mma.cu).
Weights are 0.1 * N(0, 1) and x 0.3 * N(0, 1), cast to --dtype, from
`np.random.default_rng(C)`: the tool draws them with `jax.random`, so these
are not its numbers.

Each (C, T, f) prints one JSON line with the tool's keys (`C`, `T`,
`dtype`, `fold`, `folded_ms`, `speedup`, `rel_max_err`, and with --int8
`int8_ms`, `int8_rel_err`, `int8_speedup_vs_chain`, `int8t_ms`,
`int8t_rel_err`, `int8t_speedup_vs_chain`), where the tool's `xla_ms` is
`chain_ms`; errors are the max difference from the chain relative to its
peak.  Each line adds `tile_rows`, `bound_ms` per mode (bin/kernel_bounds.py)
and the device.  Times are the tool's best of 3 loops of 6 calls after a
warm-up call, with CUDA events (on the CPU, the host clock).  `main`
returns the records.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.nn.functional as F

from audiodec_tpu_torch.bin import kernel_bounds
from audiodec_tpu_torch.bin.codec_test import require_device
from audiodec_tpu_torch.ops.kernels.folded_stack import folded_residual_stack

SHAPES = ((32, 480000), (64, 160000), (128, 40000), (256, 8000))
DILATIONS = (1, 3, 9)
ITERS, LOOPS = 6, 3
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def probe_inputs(c: int, t: int, b: int, dtype, device):
    """Seeded units ((w1 (C, C, 7), w2 (C, C, 1)), ...) and x (B, C, T),
    drawn in the tool's (JAX) layouts from `np.random.default_rng(C)`."""
    rng = np.random.default_rng(c)
    units = []
    for _ in DILATIONS:
        w1 = 0.1 * rng.standard_normal((7, c, c), dtype=np.float32)
        w2 = 0.1 * rng.standard_normal((1, c, c), dtype=np.float32)
        units.append(tuple(torch.from_numpy(w).permute(2, 1, 0).contiguous()
                           .to(device, dtype) for w in (w1, w2)))
    x = 0.3 * rng.standard_normal((b, t, c), dtype=np.float32)
    x = torch.from_numpy(x).to(device).transpose(1, 2).contiguous()
    return tuple(units), x.to(dtype)


def chain(x, units):
    """The tool's XLA stack: the units as F.elu / F.conv1d calls in the
    working dtype."""
    v = x
    for (w1, w2), d in zip(units, DILATIONS):
        y = F.conv1d(F.pad(F.elu(v), (6 * d, 0)), w1, dilation=d)
        v = v + F.conv1d(F.elu(y), w2)
    return v


def folds(c: int, t: int) -> list:
    """The tool's folds: f * C = 128, 256, 512 (f at least 1), those that
    divide T."""
    return [f for f in sorted({max(1, 128 // c), max(1, 256 // c),
                               max(1, 512 // c)}) if t % f == 0]


def tile_rows(f: int, c: int) -> int:
    fc = f * c
    return 1024 if fc <= 256 else (512 if fc <= 512 else 256)


def best_ms(fn, device) -> float:
    """Best of LOOPS loops of ITERS calls after one warm-up call: CUDA
    events on the card, the host clock on the CPU."""
    fn()
    best = float("inf")
    for _ in range(LOOPS):
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            for _ in range(ITERS):
                fn()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            for _ in range(ITERS):
                fn()
            ms = 1e3 * (time.perf_counter() - t0)
        best = min(best, ms / ITERS)
    return best


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Time the folded residual stack at every symAD width.")
    p.add_argument("--dtype", default="float32", choices=list(DTYPES))
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--int8", action="store_true",
                   help="also time the int8 modes (row and tile scales)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--shapes", default=None,
                   help="C:T pairs, comma-separated (default: the symAD "
                        "stacks)")
    return p


def _shapes(arg):
    if arg is None:
        return SHAPES
    return tuple(tuple(int(v) for v in pair.split(":"))
                 for pair in arg.split(","))


def main(argv=None) -> list:
    args = _parser().parse_args(argv)
    device = require_device(args.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    dtype = DTYPES[args.dtype]
    storage = kernel_bounds.F32 if dtype == torch.float32 else \
        kernel_bounds.BF16
    b = args.batch
    records = []
    for c, t in _shapes(args.shapes):
        units, x = probe_inputs(c, t, b, dtype, device)
        ya = chain(x, units).float()
        peak = float(ya.abs().max()) + 1e-9
        chain_ms = best_ms(lambda: chain(x, units), device)

        def rel_err(y):
            return float((ya - y.float()).abs().max()) / peak

        bounds = {
            "folded": kernel_bounds.autoencoder_stack(b, t, c, storage),
            "int8": kernel_bounds.int8_stack(b, t, c, storage),
        }
        for f in folds(c, t):
            tile = tile_rows(f, c)
            modes = {"folded": {"bf16_dots": True}}
            if args.int8:
                modes["int8"] = {"int8_dots": True}
                modes["int8t"] = {"int8_dots": True, "int8_scale": "tile"}
            rec = {"C": c, "T": t, "dtype": args.dtype, "fold": f,
                   "tile_rows": tile, "chain_ms": chain_ms}
            for mode, kw in modes.items():
                def run(kw=kw):
                    return folded_residual_stack(
                        x, units, dilations=DILATIONS, fold=f,
                        tile_rows=tile, **kw)

                err = rel_err(run())
                ms = best_ms(run, device)
                if mode == "folded":
                    rec.update(folded_ms=ms, speedup=chain_ms / ms,
                               rel_max_err=err)
                else:
                    rec.update({f"{mode}_ms": ms, f"{mode}_rel_err": err,
                                f"{mode}_speedup_vs_chain": chain_ms / ms})
            rec["bound_ms"] = {mode: bounds["folded" if mode == "folded"
                                            else "int8"]["bound_ms"]
                               for mode in modes}
            rec.update(batch=b, device=name)
            print(json.dumps(rec), flush=True)
            records.append(rec)
    return records


if __name__ == "__main__":
    main()
