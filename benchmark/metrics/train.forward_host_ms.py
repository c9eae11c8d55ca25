"""Host ms per adversarial step in its forward parts: the port's
`generator` (the graded forward with its VQ and metric losses),
`adversarial` (the discriminators on y and the adversarial and
feature-matching losses), `regenerate` (the no-grad forward for y_) and
`discriminate` (the two discriminator passes and their loss) spans, over
the `adv_step` spans of the traced steps.  The step is host-paced, so the
host's time is what these parts cost.  Read under the training trace's
device-only profiler, which adds its own cost to every launch (on an H100
a step of about 150-190 ms against 147 untraced, PERF.md §3): compare it
only with readings taken the same way."""

from benchmark.harness.spans import host_ms_per_step

MOVES = "train_audio_s_per_s"


def read(ctx):
    return host_ms_per_step(("generator", "adversarial", "regenerate",
                             "discriminate"))
