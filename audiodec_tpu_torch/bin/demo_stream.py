"""Real-time streaming demo (counterpart of audiodec_tpu/bin/demo_stream.py;
ref demoStream.py).

By default a wav goes through the threaded encoder/decoder pipeline of
`SimulatedStreamer` (no audio device needed) and the latency statistics
are printed as JSON.  With --device it streams live microphone -> codec ->
speaker through `sounddevice` (`DeviceStreamer`; needs the package and
audio hardware).

`--device` keeps the JAX CLI's meaning, the live-audio switch, so the
torch device is `--torch-device cuda|cpu` here (default cuda).

    python -m audiodec_tpu_torch.bin.demo_stream --model vctk_v1 \\
        -i in.wav -o out.wav [--frame-size 300] [--realtime]
    python -m audiodec_tpu_torch.bin.demo_stream --encoder E.ckpt \\
        --decoder D.ckpt --device --input-device 1 --output-device 4
"""

from __future__ import annotations

import argparse
import json
import logging

from audiodec_tpu_torch.bin.demo_file import build_streaming_codec
from audiodec_tpu_torch.data.wav import read_wav, write_wav
from audiodec_tpu_torch.models.registry import assign_model
from audiodec_tpu_torch.streaming import DeviceStreamer, SimulatedStreamer


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Stream a wav, or a microphone, through the codec.")
    p.add_argument("--model", default=None)
    p.add_argument("--encoder", default=None)
    p.add_argument("--decoder", default=None)
    p.add_argument("-i", "--input", default=None,
                   help="wav to stream (simulated mode) / input dump file "
                        "(--device mode)")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--frame-size", type=int, default=300)
    p.add_argument("--max-latency-ms", type=float, default=100.0)
    p.add_argument("--realtime", action="store_true",
                   help="pace the input frames at the audio rate")
    p.add_argument("--device", action="store_true",
                   help="stream live mic -> speaker via sounddevice "
                        "(ref demoStream.py)")
    p.add_argument("--input-device", default=None,
                   help="sounddevice input name/index")
    p.add_argument("--output-device", default=None,
                   help="sounddevice output name/index")
    p.add_argument("--gain", type=float, default=1.0)
    p.add_argument("--duration", type=float, default=None,
                   help="--device mode: stream for N seconds instead of "
                        "waiting for Return")
    p.add_argument("--torch-device", default="cuda",
                   help="where the codec runs: cuda (default) or cpu")
    return p


def main(argv=None):
    """Run the command line; -> the streamer's statistics."""
    parser = _parser()
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    if args.model:
        sr_expected, enc, dec = assign_model(args.model)
    elif args.encoder and args.decoder:
        enc, dec, sr_expected = args.encoder, args.decoder, None
    else:
        parser.error("need --model or --encoder/--decoder")

    codec, config = build_streaming_codec(enc, dec,
                                          device=args.torch_device)

    if args.device:
        sr = sr_expected or config.get("sampling_rate", 48000)

        def dev(d):
            return int(d) if d is not None and str(d).isdigit() else d

        streamer = DeviceStreamer(
            codec, frame_size=args.frame_size,
            input_device=dev(args.input_device),
            output_device=dev(args.output_device),
            sample_rate=sr, gain=args.gain,
            max_latency_ms=args.max_latency_ms)
        if args.input or args.output:
            streamer.enable_filedump(input_stream_file=args.input,
                                     output_stream_file=args.output)
        streamer.run(latency="low", duration=args.duration)
        return streamer.stats()

    if not args.input:
        parser.error("-i/--input is required in simulated mode")
    x, sr = read_wav(args.input)
    streamer = SimulatedStreamer(codec, frame_size=args.frame_size,
                                 max_latency_ms=args.max_latency_ms,
                                 realtime=args.realtime, sample_rate=sr)
    y = streamer.run(x)
    if args.output:
        write_wav(args.output, y, sr)
    stats = streamer.stats()
    print(json.dumps(stats, indent=2))
    return stats


if __name__ == "__main__":
    main()
