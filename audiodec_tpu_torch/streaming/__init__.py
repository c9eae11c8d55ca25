from audiodec_tpu_torch.streaming.engine import (  # noqa: F401
    StreamingCodec,
    scan_streaming_decode,
    scan_streaming_encode,
)
from audiodec_tpu_torch.streaming.streamer import (  # noqa: F401
    DeviceStreamer,
    SimulatedStreamer,
)
