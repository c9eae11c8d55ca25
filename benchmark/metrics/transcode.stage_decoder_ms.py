"""Device ms of the decoder stage of `BatchTranscoder.decode` (the port's
`decoder` span: `dec_apply`, the symAD decoder or the AD v1 vocoder),
from the CUDA events of the port's spans over the traced batches, per
batch."""

from benchmark.harness.spans import device_ms_per_span

MOVES = "transcode_rtf"


def read(ctx):
    return device_ms_per_span("decoder")
