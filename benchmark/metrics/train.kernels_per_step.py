"""Device kernels per adversarial step (copies and memsets left out), from
torch.profiler over the traced steps."""

MOVES = "train_audio_s_per_s"


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    kernels = [k for k in tr.clipped()
               if not k[0].startswith(("Memcpy", "Memset"))]
    return len(kernels) / tr.steps
