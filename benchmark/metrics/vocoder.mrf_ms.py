"""Device ms of the MultiReceptiveField blocks per batch (the port's `mrf`
spans, models/vocoder.py `fusion_bct`, all four upsampling stages), from
the CUDA events of the port's spans over the traced batches: the `mrf`
spans' device ms over the `decoder` spans' count.  A program without the
span reads nothing."""

from benchmark.harness.spans import totals

MOVES = "transcode_rtf"


def read(ctx):
    tot = totals()
    mrf, batches = tot.get("mrf"), tot.get("decoder", {}).get("count")
    return mrf["device_ms"] / batches if mrf and batches else None
