"""Batch transcode: batches of seeded audio, made on the device, sent back
to back through the port's `BatchTranscoder` (bin/codec_test.py) as
`codec_test` builds it from its command line, and drained as `codec_test`
drains them: the PCM of batch i - 1 fetched to the host after batch i is
queued (`--inflight 2`).

Traffic parameters (benchmark/traffic/<mix>.json): `batch` rows of
`seconds_of_audio` at the config's rate, `amplitude` * N(0, 1); `pool`
distinct batches, cycled; `cli` the codec_test flags that pick the route
(`--dtype`, `--stack`); `check_batches` batches of the window, drawn from
the seed, compared with the reference; `trace_wait`, `trace_steps` the
batches skipped and traced after the window of a traced run.

The configuration is a symAD autoencoder (its own decoder) or a HiFiGAN
vocoder with an `analyzer` configuration (the AD v1 receiver).

End to end: `transcode_rtf`, seconds of audio over the window's wall time,
which ends when the last batch's PCM is on the host.  Checks: `idx_gap`,
the widest gap of a chosen code from the nearest one given the reference's
encode of the same audio in the precision the mix states (float32, the
narrow stacks with bf16 operands; reference/codec.py `code_gap`), and
`pcm_rel_err`, the relative L2 distance of the window's PCM from the
reference's decode of the same indices, rounded to PCM16.
"""

from __future__ import annotations

import random
import time

import torch

from benchmark.harness import weights as W
from benchmark.harness.trace import Tracer, span
from benchmark.reference import codec as R
from benchmark.reference import layout as L

B1_COUNTERS = ("mma_launches", "mma_voc_launches", "mma_other_launches",
               "wide_launches", "resunit_launches", "int8_launches",
               "int8_tile_launches")


def parts(ctx):
    """(symAD config, vocoder config or None) of the cell."""
    cfg = ctx.config
    if cfg["model_type"] == "HiFiGAN":
        return ctx.configs(cfg["analyzer"]), cfg
    return cfg, None


def seeded_state(ctx):
    """The reference-layout state dicts of the cell, on the device."""
    sym, voc = parts(ctx)
    sd = W.state_dict(L.symad_layout(sym["generator_params"],
                                     sym["code_defaults"]), sym["init"],
                      ctx.seed, "symad", ctx.device)
    vsd = None if voc is None else W.state_dict(
        L.vocoder_layout(voc["generator_params"]), voc["init"], ctx.seed,
        "vocoder", ctx.device)
    return sd, vsd


def cli_options(flags):
    """BatchTranscoder's keyword arguments as codec_test's command line
    gives them for `flags`, PCM16 out as its default."""
    from audiodec_tpu_torch.bin import codec_test
    parser = codec_test._parser()
    args = parser.parse_args(["--encoder", "-", "--decoder", "-", *flags])
    return dict(codec_test.transcoder_options(args, parser), pcm16=True)


def build_program(ctx, sd, vsd, flags):
    """The port's transcoder from the seeded state dicts, through its own
    import path (utils/bridge.py, as bin/import_ckpt.py users load a
    reference checkpoint)."""
    from audiodec_tpu_torch.bin.codec_test import BatchTranscoder
    from audiodec_tpu_torch.utils import bridge
    from audiodec_tpu_torch.utils.config import generator_config
    sym, voc = parts(ctx)
    gen_cfg = generator_config(sym)
    params = bridge.params_from_reference_sd(W.to_numpy(sd), gen_cfg)
    voc_pair = None
    if voc is not None:
        voc_cfg = generator_config(voc)
        voc_pair = (bridge.vocoder_params_from_reference_sd(
            W.to_numpy(vsd), voc_cfg), voc_cfg)
    return BatchTranscoder(params, gen_cfg, voc=voc_pair, device=ctx.device,
                           **cli_options(flags))


def b1_launches() -> int:
    from audiodec_tpu_torch.ops.kernels import folded_stack
    return sum(getattr(folded_stack, c) for c in B1_COUNTERS)


def setup(ctx):
    p = ctx.params
    sym, _ = parts(ctx)
    marks = ctx.setup_marks
    sd, vsd = seeded_state(ctx)
    t = int(p["seconds_of_audio"] * sym["sampling_rate"])
    ctx.state.update(
        sd=sd, vsd=vsd, rate=sym["sampling_rate"],
        pool=[W.audio(ctx.seed, f"batch{i}", (p["batch"], t, 1),
                      p["amplitude"], ctx.device) for i in range(p["pool"])])
    marks("weights_and_inputs")
    ctx.state["program"] = (make_variant(ctx) if ctx.variant != "program"
                            else build_program(ctx, sd, vsd, p["cli"]))
    marks("program")
    tc = ctx.state["program"]
    for x in ctx.state["pool"][:2]:     # the one shape, twice
        tc.decode(tc.encode(x)).cpu()
    marks("warm_up")


def make_variant(ctx):
    from benchmark import controls
    return controls.transcode_variant(ctx)


class _Reservoir:
    """A uniform sample of k items of a stream of unknown length."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.n, self.items = k, rng, 0, []

    def offer(self, make):
        self.n += 1
        if len(self.items) < self.k:
            self.items.append(make())
        else:
            j = self.rng.randrange(self.n)
            if j < self.k:
                self.items[j] = make()


def _steps(ctx, until, offer, events=None, tracer=None):
    """Batches back to back, each drained after the next is queued, while
    until(n, elapsed) holds -> (batches, wall seconds); offer(i, idx, pcm)
    takes each batch's outputs.  With `events`, CUDA events around each
    encode and decode; with `tracer`, a profiler step after each batch."""
    tc, pool = ctx.state["program"], ctx.state["pool"]
    cuda, on = ctx.device.type == "cuda", ctx.traced

    def drain(item):
        i, idx, y = item
        with span("download", on):
            pcm = y.cpu()
        offer(i, idx, pcm)

    n, pending = 0, None
    t0 = time.perf_counter()
    while until(n, time.perf_counter() - t0):
        with span("step", on):
            ev = ([torch.cuda.Event(enable_timing=True) for _ in range(3)]
                  if events is not None and cuda else None)
            if ev:
                ev[0].record()
            with span("encode", on):
                idx = tc.encode(pool[n % len(pool)])
            if ev:
                ev[1].record()
            with span("decode", on):
                y = tc.decode(idx)
            if ev:
                ev[2].record()
                events.append(ev)
            if pending is not None:
                drain(pending)
            pending = (n, idx, y)
            n += 1
        if tracer:
            tracer.step()
    drain(pending)
    if cuda:
        torch.cuda.synchronize(ctx.device)
    return n, time.perf_counter() - t0


def window(ctx):
    """The measured window, then, in a traced run, `trace_wait` + 1 +
    `trace_steps` more batches under the profiler (after the window, so
    that the profiler's start and its reading take nothing from it)."""
    p, st = ctx.params, ctx.state
    keep = _Reservoir(p["check_batches"],
                      random.Random(W.derive(ctx.seed, "sample")))
    events = [] if ctx.traced else None
    launches0 = b1_launches()
    n, wall = _steps(ctx, lambda n, dt: dt < ctx.seconds,
                     lambda i, idx, pcm: keep.offer(lambda: (i, idx, pcm)),
                     events)
    ctx.window_s, ctx.attempted = wall, n
    x_shape = st["pool"][0].shape
    ctx.e2e["transcode_rtf"] = n * x_shape[0] * x_shape[1] / st["rate"] / wall
    ctx.counters["batches"] = n
    ctx.counters["b1_launches"] = b1_launches() - launches0
    if events:
        ctx.timings["encode_ms"] = [a.elapsed_time(b) for a, b, _ in events]
        ctx.timings["decode_ms"] = [b.elapsed_time(c) for _, b, c in events]
    st["kept"] = keep.items
    if ctx.traced:
        count = p["trace_wait"] + 1 + p["trace_steps"]
        with Tracer(p["trace_wait"], p["trace_steps"]) as tracer:
            _steps(ctx, lambda n, dt: n < count, lambda *a: None,
                   tracer=tracer)
        ctx.trace = tracer.reduce()


def release(ctx):
    ctx.state.pop("program", None)


def pcm16(y: torch.Tensor) -> torch.Tensor:
    """Round half away from zero to 16-bit PCM, clipped (what a WAV writer
    of float audio does)."""
    v = y.double() * 32768.0
    return torch.clamp(torch.sign(v) * torch.floor(v.abs() + 0.5), -32768,
                       32767)


def reference_decode(ctx, idx, embed):
    """Waveform (B, 1, T) from indices (B, T', Q) by the reference."""
    sym, voc = parts(ctx)
    zq = R.rvq_decode(idx, embed)
    if voc is None:
        return R.decode(zq, ctx.state["sd"], sym["generator_params"],
                        sym["code_defaults"])
    return R.vocode(zq, ctx.state["vsd_folded"], voc["generator_params"])


def check(ctx):
    """Reads the kept batches against the reference, in blocks of rows, in
    float32 with TF32 off."""
    sym, voc = parts(ctx)
    gp, df = sym["generator_params"], sym["code_defaults"]
    st = ctx.state
    if voc is not None:
        st["vsd_folded"] = R.fold_weight_norm(st["vsd"])
    embed = R.codebooks(st["sd"], gp)
    p = ctx.params
    rows = p.get("check_rows", 4)
    # the encoder's narrow stacks in the precision the mix states for them
    upto = (p["kernel_stack_max_channels"]
            if p["operand_precision"]["encoder_kernel_stacks"] == "bf16"
            else 0)
    gap, err2, ref2 = 0.0, 0.0, 0.0
    with torch.no_grad(), tf32(False):
        for i, idx_p, pcm_p in st["kept"]:
            x = st["pool"][i % len(st["pool"])]
            for r in range(0, x.shape[0], rows):
                z = R.encode(x[r:r + rows].transpose(1, 2), st["sd"], gp, df,
                             upto)
                ib = idx_p[r:r + rows].long()
                gap = max(gap, R.code_gap(z, ib, embed))
                ref = pcm16(reference_decode(ctx, ib, embed)
                            ).transpose(1, 2)
                got = pcm_p[r:r + rows].to(ref.device).double()
                err2 += float(((got - ref) ** 2).sum())
                ref2 += float((ref ** 2).sum())
    return {"idx_gap": gap,
            "pcm_rel_err": (err2 / ref2) ** 0.5 if ref2 else float("nan")}


class tf32:
    """TF32 for float32 convs and matmuls on or off, restored on exit."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.saved = (torch.backends.cudnn.allow_tf32,
                      torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = self.on
        torch.backends.cuda.matmul.allow_tf32 = self.on

    def __exit__(self, *exc):
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = self.saved
