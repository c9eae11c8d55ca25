"""The readings that a cell's limits are set from: the program's checks
over many seeds, and its controls', in one process on the card.

    python3 benchmark/controls.py --workload <cell> --seeds 1-12 \\
        --seconds 3 --variant program --variant "cli:--dtype bfloat16"

Variants:
- `program`: the cell as it runs (a short window at the cell's own load);
- `cli:<flags>` (transcode cells): the port's own lower-precision path,
  codec_test's transcoder built from these flags instead of the mix's;
- `tf32_program` (transcode cells): the program as the mix builds it,
  with TF32 switched on for its float32 convs and matmuls;
- `fp8_decode` (transcode cells): the program's encode, and the reference's
  decoder or vocoder put in place of the program's, every conv's operands
  rounded to float8 e4m3 (per-tensor scale): the step below bfloat16;
- `tf32_reference` (training cells): the reference put in place of the
  program, in TF32, the step below float32 with TF32 off: the training
  step's first three steps and the window's three probed steps from the
  program's snapshot;
- `fault:half_batch`, `fault:state_unchanged` (training cells): the
  program's step, from set-up's first step on, on the first half of each
  batch only (the mean over the rest), or with the trained leaves put back
  after each step.

Each seed prints one JSON line {"variant", "seed", "readings",
"attempted", "e2e"}.  Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
import types
from pathlib import Path

import torch
import torch.nn.functional as F

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH.parent))

from benchmark.drivers import transcode as TC  # noqa: E402
from benchmark.reference import codec as R  # noqa: E402


def _fp8(a: torch.Tensor) -> torch.Tensor:
    scale = a.abs().amax().clamp(min=1e-30) / 448.0
    return (a / scale).to(torch.float8_e4m3fn).to(a.dtype) * scale


def _fp8_functional():
    """torch.nn.functional with its convs on fp8-rounded operands."""
    ns = types.SimpleNamespace(**{k: getattr(F, k) for k in dir(F)
                                  if not k.startswith("__")})
    ns.conv1d = lambda x, w, b=None, *a, **k: F.conv1d(_fp8(x), _fp8(w), b,
                                                      *a, **k)
    ns.conv_transpose1d = lambda x, w, b=None, *a, **k: F.conv_transpose1d(
        _fp8(x), _fp8(w), b, *a, **k)
    return ns


class _Fp8Decode:
    """The program's encode; the reference's decode in fp8, as PCM16."""

    def __init__(self, ctx, program):
        self.ctx, self.program = ctx, program
        sym, voc = TC.parts(ctx)
        st = ctx.state
        self.embed = R.codebooks(st["sd"], sym["generator_params"])
        if voc is not None:
            st["vsd_folded"] = R.fold_weight_norm(st["vsd"])

    def encode(self, x):
        return self.program.encode(x)

    def decode(self, idx):
        saved, R.F = R.F, _fp8_functional()
        try:
            with torch.no_grad():
                y = TC.reference_decode(self.ctx, idx.long(), self.embed)
        finally:
            R.F = saved
        return TC.pcm16(y).to(torch.int16).transpose(1, 2)


def transcode_variant(ctx):
    st, flags = ctx.state, ctx.params["cli"]
    if ctx.variant.startswith("cli:"):
        return TC.build_program(ctx, st["sd"], st["vsd"],
                                ctx.variant[4:].split())
    if ctx.variant == "tf32_program":
        program = TC.build_program(ctx, st["sd"], st["vsd"], flags)
        torch.backends.cudnn.allow_tf32 = True     # after its set-up
        torch.backends.cuda.matmul.allow_tf32 = True
        return program
    if ctx.variant == "fp8_decode":
        return _Fp8Decode(ctx, TC.build_program(ctx, st["sd"], st["vsd"],
                                                flags))
    raise ValueError(f"no transcode variant {ctx.variant!r}")


def train_tf32_reference(ctx):
    from benchmark.drivers import train_adv
    with TC.tf32(True):
        ctx.state["first"] = train_adv.reference_steps(
            ctx, ctx.state["pool"][:3])
        ctx.state["window_steps"] = train_adv.reference_steps(
            ctx, train_adv.probed_batches(ctx), ctx.state["probe"])


def train_fault(fault: str):
    """The driver's build_program with one of a training step's faults
    planted in the step it returns."""
    from benchmark.drivers import train_adv
    build = train_adv.build_program

    def faulty(ctx, sd, dsd):
        state, adv = build(ctx, sd, dsd)

        def step(state, x):
            if fault == "half_batch":
                return adv(state, x[: x.shape[0] // 2])
            saved = {k: t.detach().clone()
                     for k, t in train_adv._trained(ctx, state).items()}
            state, rec = adv(state, x)
            with torch.no_grad():
                for k, t in train_adv._trained(ctx, state).items():
                    t.copy_(saved[k])
            return state, rec

        return state, step

    return faulty


def seeds(spec: str):
    out = []
    for part in spec.split(","):
        a, _, b = part.partition("-")
        out.extend(range(int(a), int(b) + 1) if b else [int(a)])
    return out


def readings(cell: str, variant: str, seed_list, seconds: float, device):
    """Yield {"variant", "seed", "readings", "attempted", "e2e"} for each
    seed: one set-up, a short window (or the control's outputs) and the
    check, as a run makes them."""
    from benchmark import run
    from benchmark.harness.context import Context
    wl, cfg, traffic, driver = run.cell(cell)
    train = traffic["driver"] == "train_adv"
    build = getattr(driver, "build_program", None)
    if train and variant.startswith("fault:"):
        driver.build_program = train_fault(variant[len("fault:"):])
    try:
        for seed in seed_list:
            ctx = Context(workload=wl, config=cfg, traffic=traffic,
                          seed=seed, seconds=seconds, traced=False,
                          device=device, variant=variant)
            driver.setup(ctx)
            driver.window(ctx)
            if train and variant == "tf32_reference":
                train_tf32_reference(ctx)
            driver.release(ctx)
            torch.backends.cudnn.allow_tf32 = False   # the port's policy
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.cuda.empty_cache()
            yield {"variant": variant, "seed": seed,
                   "readings": driver.check(ctx),
                   "attempted": ctx.attempted, "e2e": ctx.e2e}
    finally:
        if build is not None:
            driver.build_program = build


def main(argv=None):
    from benchmark import run
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="e.g. 1-12 or 5,9")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--variant", action="append", required=True)
    args = ap.parse_args(argv)
    run.cache_env()
    from audiodec_tpu_torch.bin.codec_test import require_device
    device = require_device("cuda:0")
    for variant in args.variant:
        for rec in readings(args.workload, variant, seeds(args.seeds),
                            args.seconds, device):
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
