"""Cost attribution inside the folded residual stack (counterpart of
tools/folded_ablate.py):

    python -m audiodec_tpu_torch.bin.folded_ablate [--batch 16]
        [--samples 480000] [--device cuda]

Times the C = 32 autoencoder stack with bf16 dots in its five ablation
variants (`ops/kernels/ablate_stack.py`, csrc/ablate_stack.cu on the
tensor cores: default, tree, im2col, noelu, noshift), one `F.elu` pass over
the same x (the tool's `xla_single_elu_pass`: one read and one write), and
the folded stack's autoencoder mode with `bf16_dots=True`
(csrc/folded_stack_mma.cu, the production stack these variants take
apart).
The variants change the stack's numbers: measurement only.  Inputs are
seeded numpy, as the tool's: weights 0.1 * N(0, 1), x 0.3 * N(0, 1),
dilations (1, 3, 9).

Each line prints `ablate`, `ms` (the mean of ITERS = 6 calls after a
warm-up, as the tool times, with CUDA events; on the CPU with the host
clock), `bound_ms` (bin/kernel_bounds.py) and the device.  `main` returns
the records.
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
from audiodec_tpu_torch.ops.kernels.ablate_stack import VARIANTS, ablate_stack
from audiodec_tpu_torch.ops.kernels.folded_stack import folded_residual_stack

DILATIONS = (1, 3, 9)
CHANNELS = 32
ITERS = 6
SEED = 0


def probe_inputs(b: int, t: int, c: int, device):
    """Seeded weights and x in the tool's (JAX) layouts, returned as the
    port's: units ((w1 (C, C, 7), w2 (C, C, 1)), ...), x (B, C, T)."""
    rng = np.random.default_rng(SEED)
    units = []
    for _ in DILATIONS:
        w1 = 0.1 * rng.standard_normal((7, c, c), dtype=np.float32)
        w2 = 0.1 * rng.standard_normal((1, c, c), dtype=np.float32)
        units.append(tuple(torch.from_numpy(w).permute(2, 1, 0).contiguous()
                           .to(device) for w in (w1, w2)))
    x = 0.3 * rng.standard_normal((b, t, c), dtype=np.float32)
    x = torch.from_numpy(x).to(device).transpose(1, 2).contiguous()
    return tuple(units), x


def mean_ms(fn, device) -> float:
    """Mean of ITERS calls after one warm-up: CUDA events on the card, the
    host clock on the CPU."""
    fn()
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(ITERS):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / ITERS
    t0 = time.perf_counter()
    for _ in range(ITERS):
        fn()
    return 1e3 * (time.perf_counter() - t0) / ITERS


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Time the folded stack's ablation variants.")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--samples", type=int, default=480000)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> list:
    args = _parser().parse_args(argv)
    device = require_device(args.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    b, t, c = args.batch, args.samples, CHANNELS
    units, x = probe_inputs(b, t, c, device)
    stack_bound = kernel_bounds.ablate_stack(b, t, c)["bound_ms"]
    # one read and one write of x, nothing to compute on a matrix unit
    elu_bound = kernel_bounds.bound_ms(2 * x.numel() * x.element_size(), 0,
                                       "f32")["bound_ms"]
    runs = [(v, lambda v=v: ablate_stack(x, units, DILATIONS, v),
             stack_bound) for v in VARIANTS]
    runs += [
        ("torch_single_elu_pass", lambda: F.elu(x), elu_bound),
        ("folded_stack_bf16_dots",
         lambda: folded_residual_stack(x, units, dilations=DILATIONS,
                                       bf16_dots=True),
         kernel_bounds.mma_stack(b, t, c)["bound_ms"]),
    ]
    records = []
    for ablate, fn, bound in runs:
        rec = {"ablate": ablate, "ms": mean_ms(fn, device),
               "bound_ms": bound, "shape": [b, c, t], "device": name}
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
