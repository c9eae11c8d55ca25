from audiodec_tpu_torch.streaming.engine import (  # noqa: F401
    StreamingCodec,
    scan_streaming_decode,
    scan_streaming_encode,
)
