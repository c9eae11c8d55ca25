"""Device ms of `BatchTranscoder.encode` (encoder, projector, RVQ), CUDA
events around each encode of the traced run's window, averaged."""

MOVES = "transcode_rtf"


def read(ctx):
    v = ctx.timings.get("encode_ms")
    return sum(v) / len(v) if v else None
