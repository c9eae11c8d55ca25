"""Host ms per adversarial step in the two optimizers' updates: the
port's `update` spans (the gradients set, clipping, Adam's step, the
schedule's step and the zeroing), over the `adv_step` spans of the traced
steps.  The step is host-paced, so the host's time is what the updates
cost.  Read under the training trace's device-only profiler, which adds
its own cost to every launch (on an H100 a step of about 150-190 ms
against 147 untraced, PERF.md §3): compare it only with readings taken
the same way."""

from benchmark.harness.spans import host_ms_per_step

MOVES = "train_audio_s_per_s"


def read(ctx):
    return host_ms_per_step(("update",))
