"""B1's share of its roofline on the MultiReceptiveField resblocks that the
folded route sends to it (csrc/folded_stack_mma.cu in its vocoder mode,
k = k2): the bound of a batch's vocoder-mode launches (the port's
`mma_voc_launches_by_k` per batch, as drivers/transcode_mrf.py counts it,
each at benchmark/arith/mrf.py's bound for its k at the kernel stage's
shape), times the traced batches, over the device time of the vocoder-mode
`stack_kernel<CP, S, KT, K2T, WG>` launches in the trace: those whose
second conv is not 1x1 (K2T other than 1; the encoder's autoencoder units
have K2T = 1).  A program without the counter, and a cell whose driver
does not count launches by k, read nothing."""

import re

from benchmark.arith import bounds
from benchmark.arith import mrf
from benchmark.arith.flops import hop_length
from benchmark.drivers.transcode import parts

MOVES = "transcode_rtf"
KERNEL = re.compile(r"\bstack_kernel<\s*\d+\s*,[^,]+,\s*\d+\s*,\s*(\d+)\s*,")
COUNTER = re.compile(r"^voc_launches_k(\d+)$")


def bound_per_batch_s(ctx):
    """The least time of a batch's vocoder-mode launches, or None where
    the program does not count them by k."""
    launches = {int(m.group(1)): n for name, n in ctx.counters.items()
                for m in [COUNTER.match(name)] if m}
    if not launches:
        return None
    p = ctx.params
    sym, voc = parts(ctx)
    vp = voc["generator_params"]
    t = int(p["seconds_of_audio"] * sym["sampling_rate"])
    stages = mrf.kernel_stages(vp, t // hop_length(sym["generator_params"]),
                               p["kernel_stack_max_channels"])
    if not stages:
        return None
    storage = bounds.SIZES[p["operand_precision"]["decoder"]]
    return sum(n / len(stages) * sum(
        mrf.mrf_stack_bound_s(vp, p["batch"], c, n_t, k, storage)
        for _, c, n_t in stages) for k, n in launches.items())


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    bound = bound_per_batch_s(ctx)
    launches = [k for k in tr.kernels_named(KERNEL)
                if KERNEL.search(k[0]).group(1) != "1"]
    device_s = sum(e - a for _, a, e in launches) / 1e6
    if bound is None or device_s <= 0:
        return None
    return 100 * bound * tr.steps / device_s
