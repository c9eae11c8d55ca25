"""Device ms of `BatchTranscoder.decode` (RVQ lookup, then the decoder or
the vocoder, then PCM16), CUDA events around each decode of the traced
run's window, averaged."""

MOVES = "transcode_rtf"


def read(ctx):
    v = ctx.timings.get("decode_ms")
    return sum(v) / len(v) if v else None
