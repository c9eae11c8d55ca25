"""Time the folded stack's int8 modes at the symAD decoder's stacks on the
card: `python -m audiodec_tpu_torch.bin.int8_timing [--reps 10]
[--scale row|tile]`.

At B = 16 x 10 s the decoder's four stacks are (C, T) = (256, 8000),
(128, 40000), (64, 160000), (32, 480000), three k = 7 units at dilations
(1, 3, 9), f32 storage, the trained golden's weights
(tests/golden/gen_symad_trained.npz).  For each the script holds one call of
`folded_residual_stack(int8_dots=True)` against
`folded_residual_stack_int8_plain` on the same inputs (max error relative
to the peak) and times the call with CUDA events (best of --loops runs of
--reps calls, after a warm-up), in f32 and in bf16 storage; then it times
the int8 decode of `BatchTranscoder(int8_decode=True)` on the indices of a
seeded 0.3 * N(0, 1) batch, the same way.  With --scale tile it does the
same for `int8_scale="tile"` (the default fold and tile_rows) against
`folded_residual_stack_int8_tile_plain`, and times no decode (no path
decodes in the tile mode).  It prints the card's name and power limit as
nvidia-smi gives them, then one JSON line.

It imports only the package's public names, which have not changed since
the int8 mode was ported, so it also times an older checkout of the
package: with PYTHONPATH set to that checkout's root and the script run by
its path, `import audiodec_tpu_torch` finds the older package (and builds
its kernels under its own build/).  PERF.md's A/B of the dp4a and the
tensor-core kernels ran it that way, old and new in turns in one call.
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
from audiodec_tpu_torch.bin.codec_test import BatchTranscoder, require_device
from audiodec_tpu_torch.models.autoencoder import GeneratorConfig
from audiodec_tpu_torch.ops.kernels import folded_stack
from audiodec_tpu_torch.utils.bridge import params_from_reference_sd

STACKS = ((256, 8000), (128, 40000), (64, 160000), (32, 480000))
DILATIONS = (1, 3, 9)
BATCH, SECONDS, SR = 16, 10, 48000
GOLDEN = "gen_symad_trained"


def load_params(golden_dir: Path):
    data = np.load(golden_dir / f"{GOLDEN}.npz")
    sd = {k[len("sd__"):]: data[k] for k in data.files
          if k.startswith("sd__")}
    return params_from_reference_sd(sd, GeneratorConfig())


def best_ms(fn, reps: int, loops: int) -> float:
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(loops):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--loops", type=int, default=3)
    ap.add_argument("--scale", choices=("row", "tile"), default="row")
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
    tile = args.scale == "tile"
    counter = "int8_tile_launches" if tile else "int8_launches"
    stacks = []
    for block, (c, t) in enumerate(STACKS):
        bp = params["decoder"]["blocks"][block]
        units = tuple((u["conv1"]["w"].to(device), u["conv2"]["w"].to(device))
                      for u in bp["res"])
        x = torch.randn(BATCH, c, t, generator=gen, device=device)
        out = folded_stack.folded_residual_stack(
            x, units, dilations=DILATIONS, int8_dots=True,
            int8_scale=args.scale)
        plain = (folded_stack.folded_residual_stack_int8_tile_plain if tile
                 else folded_stack.folded_residual_stack_int8_plain)
        ref = plain(x, units, DILATIONS)
        err = float((out - ref).abs().max() / ref.abs().max())
        before = getattr(folded_stack, counter)
        row = {"C": c, "T": t, "max_rel_err": err}
        for name, xs in (("ms", x), ("bf16_storage_ms",
                                     x.to(torch.bfloat16))):
            row[name] = best_ms(
                lambda xs=xs: folded_stack.folded_residual_stack(
                    xs, units, dilations=DILATIONS, int8_dots=True,
                    int8_scale=args.scale),
                args.reps, args.loops)
        row["calls"] = getattr(folded_stack, counter) - before
        stacks.append(row)
        del x, out, ref
    decode_ms = None
    if not tile:
        cfg = GeneratorConfig()
        tc = BatchTranscoder(params, cfg, dtype=torch.float32,
                             dec_dtype=torch.bfloat16, int8_decode=True,
                             stack="folded", device=device)
        x = 0.3 * torch.randn(BATCH, SECONDS * SR, 1, generator=gen,
                              device=device)
        idx = tc.encode(x)
        decode_ms = best_ms(lambda: tc.decode(idx), args.reps, args.loops)
    rec = {"package": str(root), "device": torch.cuda.get_device_name(0),
           "nvidia_smi": card, "scale": args.scale, "stacks": stacks,
           "stacks_ms": sum(s["ms"] for s in stacks),
           "int8_decode_ms": decode_ms,
           "seconds": time.perf_counter() - t0}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
