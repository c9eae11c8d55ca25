"""Smoke run of the PyTorch port on one NVIDIA H100: `python3 chip_smoke.py`.

Builds the port's CUDA kernel from the sources in this checkout, holds it
against its plain PyTorch version, checks the batch transcode against the
reference goldens, then drives the main path (symAD, B=16 x 10 s at 48 kHz,
mixed mode: f32 encoder and RVQ, bf16 decoder, residual stacks through the
kernel) once, times it and profiles one more transcode.  Each phase
prints one JSON line with its own seconds; any failure raises, so the
script exits non-zero and prints no result.  Without a CUDA device it exits non-zero at once.

Output, in order: the card's name and power limit as nvidia-smi gives
them, one JSON line per phase, a `{"kernels": [...]}` line, and last
`{"ok": true, "device": {...}}`.

In the `kernels` line, `launches` is the count from one main-path
transcode, and `ms`, `plain_ms`, `chain_ms` and `bound_ms` add up those
launches at their shapes (one f32 stack in the encoder, one bf16 stack in
the decoder, both (16, 32, 480000)).  `bound_ms` is the larger of bytes
over 3.35 TB/s and FLOP over 989 TFLOP/s (bf16 operands), per launch.
`library_ms` is null: no single PyTorch call computes the stack; `chain_ms`
is the ELU / F.conv1d chain in the working dtype.  Peaks are the H100 SXM
data sheet's, at 700 W.

Needs only torch, numpy and the repo's `audiodec_tpu_torch` package (no
JAX, no PyYAML) and nvcc; the build goes to build/audiodec_tpu_torch/.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from audiodec_tpu_torch.bin.codec_test import BatchTranscoder, require_device
from audiodec_tpu_torch.models.autoencoder import GeneratorConfig
from audiodec_tpu_torch.ops.kernels import _build, folded_stack
from audiodec_tpu_torch.utils.bridge import params_from_reference_sd

GOLDEN = Path(__file__).resolve().parent / "tests" / "golden"
SR = 48000
BATCH, SECONDS = 16, 10
DILATIONS = (1, 3, 9)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
SEED = 0
PROFILE_TOP = 15


def emit(phase: str, t0: float, **fields):
    print(json.dumps({"phase": phase, "seconds": time.perf_counter() - t0,
                      **fields}), flush=True)


def load_golden(name: str):
    data = np.load(GOLDEN / f"{name}.npz")
    sd = {k[len("sd__"):]: data[k] for k in data.files
          if k.startswith("sd__")}
    return data, params_from_reference_sd(sd, GeneratorConfig())


def stack_units(params, where: str, device, dtype):
    """Unit weights of the two C=32 stacks: encoder block 0, decoder
    block 3."""
    bp = (params["encoder"]["blocks"][0] if where == "encoder"
          else params["decoder"]["blocks"][3])
    return tuple((u["conv1"]["w"].to(device, dtype),
                  u["conv2"]["w"].to(device, dtype)) for u in bp["res"])


def cuda_ms(fn, reps: int) -> float:
    fn()  # warm-up
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def chain(x, units):
    """The yardstick: the same units as plain ELU / F.conv1d calls in the
    working dtype, with no rounding emulation."""
    v = x
    for (w1, w2), d in zip(units, DILATIONS):
        y = F.conv1d(F.pad(F.elu(v), (6 * d, 0)), w1, dilation=d)
        v = v + F.conv1d(F.elu(y), w2)
    return v


def check_kernel(x, units, bf16_dots: bool):
    """Kernel vs plain version on the same inputs; returns (abs, rel)."""
    out = folded_stack.folded_residual_stack(x, units, dilations=DILATIONS,
                                             bf16_dots=bf16_dots)
    ref = folded_stack.folded_residual_stack_plain(x, units, DILATIONS,
                                                   bf16_dots)
    torch.cuda.synchronize()
    out, ref = out.float(), ref.float()
    scale = float(ref.abs().max())
    err = float((out - ref).abs().max())
    if not torch.isfinite(out).all():
        raise AssertionError("kernel output is not finite")
    if torch.equal(out, x.float()):
        raise AssertionError("kernel returned its input unchanged")
    if x.dtype == torch.float32 and not bf16_dots:
        # true f32: only the order of the sums differs
        # (tests/test_folded_stack.py:73-75)
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=5e-5 * scale)
    elif err / scale >= 1e-2:
        raise AssertionError(f"bf16-mode relative error {err / scale:.3g} "
                             f">= 1e-2")
    return err, err / scale


def random_units(c: int, device, dtype, gen):
    """Seeded unit weights at width C, scaled to keep the stack's outputs
    near unit size."""
    return tuple((torch.randn(c, c, 7, generator=gen, device=device)
                  .div((7 * c) ** 0.5).to(dtype),
                  torch.randn(c, c, 1, generator=gen, device=device)
                  .div(c ** 0.5).to(dtype)) for _ in DILATIONS)


def phase_kernel_vs_plain(params, device):
    """C=32 with the golden weights at the main path's length, one more and
    one shorter than the halo; C = 4, 8, 16 and 12 (padded to 16) with
    random weights, so every width the kernel is built for runs."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED)
    shapes = ([(32, t) for t in (48000, 48001, 50)]
              + [(c, t) for c in (4, 8, 16, 12) for t in (1920, 50)])
    cases = []
    for c, t in shapes:
        for storage in (torch.float32, torch.bfloat16):
            if c == 32:
                units = stack_units(params, "encoder"
                                    if storage == torch.float32
                                    else "decoder", device, storage)
            else:
                units = random_units(c, device, storage, gen)
            x = torch.randn(2, c, t, generator=gen, device=device)
            for bf16_dots in (True, False):
                err, rel = check_kernel(x.to(storage), units, bf16_dots)
                cases.append({"C": c, "T": t, "storage": str(storage)[6:],
                              "bf16_dots": bf16_dots, "max_abs_err": err,
                              "max_rel_err": rel})
    emit("kernel_vs_plain", t0, cases=cases)


def phase_golden(device):
    t0 = time.perf_counter()
    cfg = GeneratorConfig()
    results = {}
    for name in ("gen_symad", "gen_symad_trained"):
        data, params = load_golden(name)
        x = data["x"].transpose(0, 2, 1)
        # idx_stream is (Q, T') in the reference's flat format (layer q
        # offset by q*N)
        flat = np.arange(cfg.codebook_num)[:, None] * cfg.codebook_size
        idx, y = BatchTranscoder(params, cfg, stack="folded",
                                 bf16_dots=False, device=device)(x)
        np.testing.assert_array_equal(idx[0].cpu().numpy().T + flat,
                                      data["idx_stream"])
        np.testing.assert_allclose(y.cpu().numpy().transpose(0, 2, 1),
                                   data["y"], rtol=1e-3, atol=1e-4)
        idx16 = BatchTranscoder(params, cfg, stack="folded",
                                device=device).encode(x)
        flips = int((idx16[0].cpu().numpy().T + flat
                     != data["idx_stream"]).sum())
        if name == "gen_symad" and flips:
            raise AssertionError(f"{flips} index flips with bf16 operands")
        results[name] = {"f32_index_flips": 0, "bf16_dots_index_flips": flips,
                         "frames": int(data["idx_stream"].shape[1])}
    emit("golden_parity", t0, goldens=results)


def kernel_timing(params, device, dtype, gen):
    """Kernel, plain and chain ms and the bound at (16, 32, 480000)."""
    b, c, t = BATCH, 32, SECONDS * SR
    units = stack_units(params, "encoder" if dtype == torch.float32
                        else "decoder", device, dtype)
    x = torch.randn(b, c, t, generator=gen, device=device).to(dtype)
    err, _ = check_kernel(x, units, bf16_dots=True)
    row = {
        "shape": [b, c, t], "dtype": str(dtype)[6:], "max_abs_err": err,
        "ms": cuda_ms(lambda: folded_stack.folded_residual_stack(x, units),
                      reps=5),
        "plain_ms": cuda_ms(lambda: folded_stack.folded_residual_stack_plain(
            x, units, DILATIONS), reps=3),
        "chain_ms": cuda_ms(lambda: chain(x, units), reps=3),
    }
    weights = sum(w.numel() * w.element_size() for u in units for w in u)
    nbytes = 2 * x.numel() * x.element_size() + weights
    flop = len(units) * (7 + 1) * c * c * 2 * b * t
    row["bytes_ms"] = 1e3 * nbytes / HBM_BYTES_PER_S
    row["operations_ms"] = 1e3 * flop / BF16_FLOP_PER_S
    row["bound_ms"] = max(row["bytes_ms"], row["operations_ms"])
    row["bound_by"] = ("bytes" if row["bytes_ms"] >= row["operations_ms"]
                       else "operations")
    return row


def phase_main_path(device):
    t0 = time.perf_counter()
    cfg = GeneratorConfig()
    _, params = load_golden("gen_symad_trained")
    tc = BatchTranscoder(params, cfg, dtype=torch.float32,
                         dec_dtype=torch.bfloat16, stack="folded",
                         device=device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    x = 0.3 * torch.randn(BATCH, SECONDS * SR, 1, generator=gen,
                          device=device)

    folded_stack.launches = 0
    idx, y = tc(x)
    torch.cuda.synchronize()
    launches = folded_stack.launches
    if launches != 2:
        raise AssertionError(f"{launches} kernel launches, expected 2")
    frames = SECONDS * SR // cfg.hop_length
    if tuple(idx.shape) != (BATCH, frames, cfg.codebook_num):
        raise AssertionError(f"indices {tuple(idx.shape)}")
    if int(idx.min()) < 0 or int(idx.max()) >= cfg.codebook_size:
        raise AssertionError("index out of range")
    if tuple(y.shape) != tuple(x.shape) or not torch.isfinite(y).all():
        raise AssertionError("decoded waveform not finite or misshapen")

    torch.cuda.reset_peak_memory_stats()
    transcode_ms = cuda_ms(lambda: tc(x), reps=3)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    encode_ms = cuda_ms(lambda: tc.encode(x), reps=3)
    decode_ms = cuda_ms(lambda: tc.decode(idx), reps=3)
    rows = [kernel_timing(params, device, dt, gen)
            for dt in (torch.float32, torch.bfloat16)]
    emit("main_path", t0, batch=BATCH, seconds_of_audio=BATCH * SECONDS,
         transcode_ms=transcode_ms, encode_ms=encode_ms, decode_ms=decode_ms,
         rtf=BATCH * SECONDS / (transcode_ms / 1e3),
         peak_memory_gib=peak_gib, folded_stack_launches=launches,
         folded_stack=rows)
    return launches, rows, tc, x


def phase_profile(tc, x):
    """One more transcode of the main path under torch.profiler: its wall
    time, the device time summed over all kernels, the device's idle share
    (one stream, so kernels do not overlap) and the kernels with the most
    device time."""
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        tc(x)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t1)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if device_ms <= 0:
        raise AssertionError("the profiler saw no device time")
    emit("profile", t0, wall_ms=wall_ms, device_ms=device_ms,
         idle_share=1.0 - device_ms / wall_ms,
         top=[{"name": e.key[:120], "calls": e.count,
               "device_ms": e.self_device_time_total / 1e3}
              for e in kernels[:PROFILE_TOP]])


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    t0 = time.perf_counter()
    device = require_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit("device", t0, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, nvidia_smi=card)

    t0 = time.perf_counter()
    lib = _build.build("folded_stack")
    _build.load("folded_stack")
    emit("build", t0, library=str(lib))

    _, trained = load_golden("gen_symad_trained")
    phase_kernel_vs_plain(trained, device)
    phase_golden(device)
    launches, rows, tc, x = phase_main_path(device)
    phase_profile(tc, x)

    worst = max(rows, key=lambda r: r["bound_ms"])
    print(json.dumps({"kernels": [{
        "name": "folded_residual_stack",
        "route": "cuda",
        "source": "audiodec_tpu_torch/csrc/folded_stack.cu",
        "replaces": "audiodec_tpu/ops/pallas/folded_stack.py:372",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows),
        "bound_by": worst["bound_by"],
        "library_ms": None,
        "chain_ms": sum(r["chain_ms"] for r in rows),
        "per_launch": rows,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
