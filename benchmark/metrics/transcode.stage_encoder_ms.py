"""Device ms of the encoder stage of `BatchTranscoder.encode` (the port's
`encoder` span: the encoder's convs and residual stacks, `enc_apply`),
from the CUDA events of the port's spans over the traced batches, per
batch."""

from benchmark.harness.spans import device_ms_per_span

MOVES = "transcode_rtf"


def read(ctx):
    return device_ms_per_span("encoder")
