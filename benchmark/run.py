"""One run of one cell of the benchmark of audiodec_tpu_torch, the PyTorch
and CUDA port, on the machine it starts on:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is found by name: benchmark/workloads/<cell>.json names its
configuration (benchmark/configs/<config>.json), its traffic mix
(benchmark/traffic/<mix>.json), and the mix names its driver
(benchmark/drivers/<driver>.py: set-up, window, check).  BENCHMARK.json, at
the root of the checkout, lists which metrics the cell reports: with
`--trace 0` its end-to-end metrics, with `--trace 1` its per-layer metrics,
each read by benchmark/metrics/<metric>.py.

The run makes its weights and inputs from the seed, on the card, builds the
port through its own import path, warms up the cell's shapes (set-up,
`setup_s`: process start to the window's start), measures for `--seconds`,
reads the device's peak memory, frees the program, checks what the window
produced against the plain reference (benchmark/reference/), and prints
each number compared beside its limit on standard error and one JSON line
last on standard output.  It exits with another code than 0, and prints no
result, where there is no CUDA device or fewer than the cell asks for, or
where JAX or the JAX package was loaded.

Caches: the port builds its CUDA libraries into build/audiodec_tpu_torch/
inside the checkout (keyed on the sources' hashes); torch's and Triton's
caches go to build/bench_cache/ there.  Nothing else is written.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "audiodec_tpu")


def cache_env():
    base = ROOT / "build" / "bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(base / "cuda")
    os.environ["USE_FLAX"] = "0"


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The reader of a per-layer metric: benchmark/metrics/<metric>.py, or,
    for a quantity split by its cells' end-to-end metric
    (`<quantity>.<kind>`), the quantity's own benchmark/metrics/<quantity>.py.
    """
    path = BENCH / "metrics" / f"{metric}.py"
    if not path.exists():
        path = BENCH / "metrics" / f"{metric.split('.')[0]}.py"
    return load_module(path)


def cell(name: str):
    """(workload, configuration, traffic mix, driver module) of a cell."""
    from benchmark.harness.context import config, load_json
    wl = load_json(BENCH / "workloads" / f"{name}.json")
    traffic = load_json(BENCH / "traffic" / f"{wl['traffic']}.json")
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    return wl, config(wl["config"]), traffic, driver


def listed(kind: str, name: str) -> list:
    """BENCHMARK.json's metrics of `kind` that the cell reports."""
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    return [m for m in bench[kind]
            if "workloads" not in m or name in m["workloads"]]


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, traced: bool, device,
             overrides=None, t_start: float = T0) -> dict:
    """Set-up, window, check of one cell -> the result line (a dict).
    overrides: {"config": dict, "configs": fn, "traffic": dict} in place of
    the files (the CPU tests' small sizes)."""
    import torch

    from benchmark.harness.context import Context, summary
    wl, cfg, traffic, driver = cell(name)
    overrides = overrides or {}
    ctx = Context(workload=wl, config=overrides.get("config", cfg),
                  traffic=overrides.get("traffic", traffic), seed=seed,
                  seconds=seconds, traced=traced, device=device)
    if "configs" in overrides:
        ctx.configs = overrides["configs"]
    ctx.setup_phases["start"] = time.perf_counter() - t_start
    cuda = device.type == "cuda"
    driver.setup(ctx)
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    driver.window(ctx)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    driver.release(ctx)
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    correct, checks = summary(ctx.checks(driver.check(ctx)))
    check_s = time.perf_counter() - t_check
    ctx.e2e["setup_s"] = setup_s
    metrics = {}
    if traced:
        for m in listed("per_layer", name):
            value = reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in listed("end_to_end", name):
            metrics[m["name"]] = {"value": ctx.e2e[m["name"]],
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": wl["chips"], "memory_peak_bytes": peak,
           "power_limit": power_limit() if cuda else None}
    out = {"correct": correct, "attempted": ctx.attempted,
           "failed": sum(not c["value"] <= c["limit"]
                         for c in checks.values()),
           "metrics": metrics, "device": dev}
    if traced and ctx.trace is not None:
        dev["busy_s"] = ctx.trace.busy_s()
        dev["window_s"] = ctx.trace.window_s
        out["breakdown"] = {"device_ops": ctx.trace.top_ops(),
                            "idle_gaps": ctx.trace.idle_gaps()}
    # ignored by the reader of the result, kept for PERF.md: set-up's split
    # and the reference check's seconds
    out["setup_phases"] = ctx.setup_phases
    out["check_s"] = check_s
    out["checks"] = checks
    return out


def power_limit():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()
    sys.path.insert(0, str(ROOT))
    import torch
    chips = json.loads((BENCH / "workloads" / f"{args.workload}.json"
                        ).read_text())["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"run.py: the cell needs {chips} CUDA device(s); found "
              f"{found}", file=sys.stderr)
        return 2
    from audiodec_tpu_torch.bin.codec_test import require_device
    device = require_device("cuda:0")    # TF32 off, as every entry point
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   device)
    bad = loaded_forbidden()
    if bad:
        print(f"run.py: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
