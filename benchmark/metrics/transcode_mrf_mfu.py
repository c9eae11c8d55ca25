"""The transcode's share of the card's peak through a MultiReceptiveField
receiver: the model FLOPs of a batch, symAD's encoder, projector and RVQ
(benchmark/arith/flops.py) and the vocoder (benchmark/arith/mrf.py), each
at the data-sheet peak of the precision the traffic mix declares for its
operands (`operand_precision`; the encoder's stacks of at most
`kernel_stack_max_channels` channels apart), summed into the least time a
batch could take, over the window's wall time per batch."""

from benchmark.arith import bounds, flops, mrf
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
    s, c = 0.0, gp["encode_channels"]
    for i in range(len(gp["enc_strides"])):
        kind = "encoder_kernel_stacks" if c <= cmax else "encoder"
        s += flops.encoder_flops(gp, df, t)[f"stack{i}"] / peak[prec[kind]]
        c = gp["encode_channels"] * gp["enc_ratios"][i]
    s += sum(f for name, f in flops.encoder_flops(gp, df, t).items()
             if not name.startswith("stack")) / peak[prec["encoder"]]
    s += flops.projector_flops(gp, n) / peak[prec["projector"]]
    s += flops.rvq_flops(gp, n) / peak[prec["rvq"]]
    s += (sum(mrf.mrf_vocoder_flops(voc["generator_params"], n).values())
          / peak[prec["decoder"]])
    return p["batch"] * s


def read(ctx):
    if not ctx.attempted or ctx.window_s <= 0:
        return None
    return 100 * least_time_s(ctx) / (ctx.window_s / ctx.attempted)
