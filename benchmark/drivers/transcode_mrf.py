"""Batch transcode through a receiver whose vocoder has MultiReceptiveField
blocks (AD v0): drivers/transcode.py's traffic, program and window, with
the vocoder's seeded state in reference/mrf.py's layout and the check
against reference/mrf.py `vocode_mrf`.

Traffic parameters: those of drivers/transcode.py, read the same way.

End to end: `transcode_rtf`, as drivers/transcode.py takes it.  Checks:
`idx_gap` as there (the same encoder and RVQ), and `pcm_rel_err`, the
relative L2 distance of the window's PCM16 from `vocode_mrf` of the same
indices, rounded to PCM16.  Besides drivers/transcode.py's counters, the
B1 vocoder-mode launches by kernel size per batch (`voc_launches_k<k>`,
from the port's `mma_voc_launches_by_k`, over the window's and the traced
batches), which a program without that counter leaves out.
"""

from __future__ import annotations

import torch

from benchmark.drivers import transcode as TC
from benchmark.harness import weights as W
from benchmark.reference import codec as R
from benchmark.reference import layout as L
from benchmark.reference import mrf as M

release = TC.release


def seeded_state(ctx):
    """The reference-layout state dicts of the cell, on the device."""
    sym, voc = TC.parts(ctx)
    sd = W.state_dict(L.symad_layout(sym["generator_params"],
                                     sym["code_defaults"]), sym["init"],
                      ctx.seed, "symad", ctx.device)
    vsd = W.state_dict(M.mrf_layout(voc["generator_params"]), voc["init"],
                       ctx.seed, "vocoder", ctx.device)
    return sd, vsd


def setup(ctx):
    """drivers/transcode.py's set-up on this state: the seeded batches,
    the program (or a control, benchmark/controls_mrf.py), two
    warm-up batches."""
    p = ctx.params
    sym, _ = TC.parts(ctx)
    sd, vsd = seeded_state(ctx)
    t = int(p["seconds_of_audio"] * sym["sampling_rate"])
    ctx.state.update(
        sd=sd, vsd=vsd, rate=sym["sampling_rate"],
        pool=[W.audio(ctx.seed, f"batch{i}", (p["batch"], t, 1),
                      p["amplitude"], ctx.device) for i in range(p["pool"])])
    ctx.setup_marks("weights_and_inputs")
    if ctx.variant == "program":
        ctx.state["program"] = TC.build_program(ctx, sd, vsd, p["cli"])
    else:
        from benchmark import controls_mrf
        ctx.state["program"] = controls_mrf.transcode_variant(ctx)
    ctx.setup_marks("program")
    tc = ctx.state["program"]
    for x in ctx.state["pool"][:2]:     # the one shape, twice
        tc.decode(tc.encode(x)).cpu()
    ctx.setup_marks("warm_up")


def voc_launches_by_k():
    """A copy of the port's B1 vocoder-mode launches by kernel size, or
    None where the port does not count them."""
    from audiodec_tpu_torch.ops.kernels import folded_stack
    by_k = getattr(folded_stack, "mma_voc_launches_by_k", None)
    return None if by_k is None else dict(by_k)


def window(ctx):
    """drivers/transcode.py's window (and traced batches), counting the
    vocoder-mode launches by kernel size."""
    before = voc_launches_by_k()
    TC.window(ctx)
    after = voc_launches_by_k()
    p = ctx.params
    batches = ctx.attempted + (p["trace_wait"] + 1 + p["trace_steps"]
                               if ctx.traced else 0)
    if before is not None and batches:
        for k, n in after.items():
            ctx.counters[f"voc_launches_k{k}"] = (n - before.get(k, 0)
                                                  ) / batches


def check(ctx):
    """The kept batches against the reference, in blocks of rows, float32
    with TF32 off: drivers/transcode.py's check with `vocode_mrf` as the
    vocoder."""
    sym, voc = TC.parts(ctx)
    gp, df = sym["generator_params"], sym["code_defaults"]
    vp = voc["generator_params"]
    st, p = ctx.state, ctx.params
    vsd = M.fold_weight_norm(st["vsd"])
    embed = R.codebooks(st["sd"], gp)
    rows = p.get("check_rows", 4)
    upto = (p["kernel_stack_max_channels"]
            if p["operand_precision"]["encoder_kernel_stacks"] == "bf16"
            else 0)
    gap, err2, ref2 = 0.0, 0.0, 0.0
    with torch.no_grad(), TC.tf32(False):
        for i, idx_p, pcm_p in st["kept"]:
            x = st["pool"][i % len(st["pool"])]
            for r in range(0, x.shape[0], rows):
                z = R.encode(x[r:r + rows].transpose(1, 2), st["sd"], gp, df,
                             upto)
                ib = idx_p[r:r + rows].long()
                gap = max(gap, R.code_gap(z, ib, embed))
                y = M.vocode_mrf(R.rvq_decode(ib, embed), vsd, vp)
                ref = TC.pcm16(y).transpose(1, 2)
                got = pcm_p[r:r + rows].to(ref.device).double()
                err2 += float(((got - ref) ** 2).sum())
                ref2 += float((ref ** 2).sum())
    return {"idx_gap": gap,
            "pcm_rel_err": (err2 / ref2) ** 0.5 if ref2 else float("nan")}
