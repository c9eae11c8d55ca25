"""The median adversarial step on the device's clock: the interval between
the CUDA events recorded as consecutive steps of the traced run's window
start, with nothing waiting for them.  The step is host-paced today, so
this is the host's pace as the device sees it: per-layer only."""

from benchmark.harness.context import percentile

MOVES = "train_audio_s_per_s"


def read(ctx):
    v = ctx.timings.get("step_ms")
    return percentile(v, 50) if v else None
