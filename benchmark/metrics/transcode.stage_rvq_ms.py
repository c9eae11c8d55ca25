"""Device ms of the RVQ search of `BatchTranscoder.encode` (the port's
`rvq` span: `rvq_forward_index`, the nearest code of each of the Q
layers), from the CUDA events of the port's spans over the traced
batches, per batch."""

from benchmark.harness.spans import device_ms_per_span

MOVES = "transcode_rtf"


def read(ctx):
    return device_ms_per_span("rvq")
