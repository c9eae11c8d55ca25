"""The transcode's share of the card's peak: the model FLOPs of a batch
(benchmark/arith/flops.py), each stage at the data-sheet peak of the
precision the traffic mix declares for its operands
(`operand_precision`: the encoder's stacks of at most
`kernel_stack_max_channels` channels, which the folded route sends to the
bf16 kernel, apart from the rest of the encoder), summed into the least
time a batch could take, over the window's wall time per batch."""

from benchmark.arith import bounds, flops
from benchmark.drivers.transcode import parts

MOVES = "transcode_rtf"


def least_time_s(ctx) -> float:
    p = ctx.params
    prec, cmax = p["operand_precision"], p["kernel_stack_max_channels"]
    sym, voc = parts(ctx)
    gp, df = sym["generator_params"], sym["code_defaults"]
    t = int(p["seconds_of_audio"] * sym["sampling_rate"])
    n = t // flops.hop_length(gp)
    peak = bounds.PEAK_FLOPS
    s = 0.0
    cin = gp["encode_channels"]
    for name, f in flops.encoder_flops(gp, df, t).items():
        kind = "encoder"
        if name.startswith("stack"):
            i = int(name[len("stack"):])
            c = cin if i == 0 else gp["encode_channels"] * gp["enc_ratios"][
                i - 1]
            if c <= cmax:
                kind = "encoder_kernel_stacks"
        s += f / peak[prec[kind]]
    s += flops.projector_flops(gp, n) / peak[prec["projector"]]
    s += flops.rvq_flops(gp, n) / peak[prec["rvq"]]
    dec = (flops.decoder_flops(gp, df, n) if voc is None
           else flops.vocoder_flops(voc["generator_params"], n))
    s += dec / peak[prec["decoder"]]
    return p["batch"] * s


def read(ctx):
    if not ctx.attempted or ctx.window_s <= 0:
        return None
    return 100 * least_time_s(ctx) / (ctx.window_s / ctx.attempted)
