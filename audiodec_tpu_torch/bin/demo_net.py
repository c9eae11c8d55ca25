"""Network streaming codec demo: the encoder and the decoder at the two ends
of a TCP connection, RVQ bitstream packets on the wire (counterpart of
audiodec_tpu/bin/demo_net.py).

Receiver (decoder side), started first:

    python -m audiodec_tpu_torch.bin.demo_net rx --listen 0.0.0.0:9900 \\
        --encoder E.ckpt --decoder D.ckpt -o received.wav

Transmitter (encoder side):

    python -m audiodec_tpu_torch.bin.demo_net tx --connect host:9900 \\
        --encoder E.ckpt --decoder D.ckpt -i input.wav [--realtime]

Each side's codec runs on the card unless given `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import logging
import socket

from audiodec_tpu_torch.bin.demo_file import build_streaming_codec
from audiodec_tpu_torch.data.wav import read_wav, write_wav
from audiodec_tpu_torch.models.registry import assign_model
from audiodec_tpu_torch.streaming.net import CodecReceiver, CodecTransmitter


def _addr(s: str):
    host, port = s.rsplit(":", 1)
    return host, int(port)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Send or receive a codec stream over TCP.")
    p.add_argument("mode", choices=["tx", "rx"])
    p.add_argument("--model", default=None)
    p.add_argument("--encoder", default=None)
    p.add_argument("--decoder", default=None)
    p.add_argument("--connect", default=None, help="tx: host:port")
    p.add_argument("--listen", default=None, help="rx: host:port")
    p.add_argument("-i", "--input", default=None, help="tx: wav to send")
    p.add_argument("-o", "--output", default=None, help="rx: wav to write")
    p.add_argument("--frame-size", type=int, default=3000,
                   help="samples per packet (a hop multiple)")
    p.add_argument("--realtime", action="store_true",
                   help="tx: pace packets at the audio rate")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p


def main(argv=None) -> dict:
    """Run one side; prints its statistics as JSON and returns them."""
    parser = _parser()
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    if args.model:
        _, enc, dec = assign_model(args.model)
    elif args.encoder and args.decoder:
        enc, dec = args.encoder, args.decoder
    else:
        parser.error("need --model or --encoder/--decoder")

    codec, config = build_streaming_codec(enc, dec, device=args.device)
    sr = config.get("sampling_rate", 48000)

    if args.mode == "tx":
        if not (args.connect and args.input):
            parser.error("tx needs --connect and --input")
        x, sr_in = read_wav(args.input)
        tx = CodecTransmitter(codec, frame_size=args.frame_size,
                              sample_rate=sr_in or sr)
        with socket.create_connection(_addr(args.connect)) as sock:
            stats = tx.run(x, sock, realtime=args.realtime)
    else:
        if not args.listen:
            parser.error("rx needs --listen")
        host, port = _addr(args.listen)
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as srv:
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind((host, port))
            srv.listen(1)
            logging.info("listening on %s:%d", host, port)
            conn, peer = srv.accept()
            logging.info("connection from %s", peer)
            with conn:
                y, stats = CodecReceiver(codec).run(conn)
        if args.output:
            write_wav(args.output, y, sr)
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
