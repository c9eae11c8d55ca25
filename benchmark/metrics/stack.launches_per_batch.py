"""B1 wrapper calls per transcode, from the port's own launch counters
(ops/kernels/folded_stack.py: `mma_launches`, `mma_voc_launches`, and the
other routes' counters), over the window."""

MOVES = "transcode_rtf"


def read(ctx):
    n = ctx.counters.get("batches")
    return ctx.counters["b1_launches"] / n if n else None
