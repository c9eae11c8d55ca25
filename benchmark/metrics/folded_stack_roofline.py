"""csrc/folded_stack_mma.cu's share of its roofline: the bound of the
cell's B1 work per batch (benchmark/arith/bounds.py `mma_stack` at the
shapes of the stacks that the folded route sends to the kernel: encoder and
decoder stacks of at most `kernel_stack_max_channels` channels, three k = 7
units, and the vocoder's stages of at most that many channels, `groups`
stacks of three k = 11 units with biases), times the traced batches, over
the device time of the kernel's launches in the trace (`stack_kernel<...>`,
the kernel of csrc/folded_stack_mma.cu)."""

import re

from benchmark.arith import bounds
from benchmark.drivers.transcode import parts

MOVES = "transcode_rtf"
KERNEL = re.compile(r"\bstack_kernel<")


def bound_per_batch_s(ctx) -> float:
    p = ctx.params
    prec, cmax = p["operand_precision"], p["kernel_stack_max_channels"]
    sym, voc = parts(ctx)
    gp = sym["generator_params"]
    b = p["batch"]
    t = int(p["seconds_of_audio"] * sym["sampling_rate"])
    total = 0.0
    enc = bounds.SIZES[prec["encoder"]]
    t_i, c = t, gp["encode_channels"]
    for i, s in enumerate(gp["enc_strides"]):
        if c <= cmax:
            total += bounds.mma_stack(b, t_i, c, storage=enc)
        t_i //= s
        c = gp["encode_channels"] * gp["enc_ratios"][i]
    dec = bounds.SIZES[prec["decoder"]]
    n = t_i
    if voc is None:
        ratios = gp["dec_ratios"]
        for i, s in enumerate(gp["dec_strides"]):
            n *= s
            c = (gp["decode_channels"] * ratios[i + 1]
                 if i + 1 < len(ratios) else gp["decode_channels"])
            if c <= cmax:
                total += bounds.mma_stack(b, n, c, storage=dec)
        return total
    vp = voc["generator_params"]
    k = vp["resblock_kernel_sizes"][0]
    for i, s in enumerate(vp["upsample_scales"]):
        n *= s
        c = vp["channels"] // 2 ** (i + 1)
        if c <= cmax:
            total += vp["groups"] * bounds.mma_stack(
                b, n, c, k=k, k2=k, storage=dec, bias=vp["bias"],
                units=len(vp["resblock_dilations"][0]))
    return total


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    launches = tr.kernels_named(KERNEL)
    device_s = sum(e - a for _, a, e in launches) / 1e6
    if device_s <= 0:
        return None
    return 100 * bound_per_batch_s(ctx) * tr.steps / device_s
