"""Host ms per adversarial step in the two optimizers' backward passes:
the port's `backward` spans (`torch.autograd.grad` and the zero fill of
unused leaves, the generator's and the discriminators'), over the
`adv_step` spans of the traced steps.  The step is host-paced, so the
host's time is what the backward passes cost.  Read under the training
trace's device-only profiler, which adds its own cost to every launch (on
an H100 a step of about 150-190 ms against 147 untraced, PERF.md §3):
compare it only with readings taken the same way."""

from benchmark.harness.spans import host_ms_per_step

MOVES = "train_audio_s_per_s"


def read(ctx):
    return host_ms_per_step(("backward",))
