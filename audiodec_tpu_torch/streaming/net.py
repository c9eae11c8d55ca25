"""Network codec transport: RVQ bitstream packets over a byte stream
(counterpart of audiodec_tpu/streaming/net.py: `send_packet`,
`_recv_exact`, `recv_packet`, `CodecTransmitter`, `CodecReceiver`).

The transmitter runs the streaming encoder and sends each frame's codes as
a length-prefixed `utils/bitstream.py` packet (self-describing, about 12.8
kbps for the canonical codec); the receiver decodes the packets frame by
frame with a stateful `StreamingCodec`.  Works over TCP, Unix sockets or a
`socket.socketpair()`.

Packet framing: [u32 little-endian length][payload]; a zero length marks
the end of the stream.
"""

from __future__ import annotations

import struct
import time
from typing import Optional, Tuple

import numpy as np
import torch

from audiodec_tpu_torch.streaming.engine import StreamingCodec
from audiodec_tpu_torch.utils.bitstream import pack_codes, unpack_codes

_LEN = struct.Struct("<I")

# a generous ceiling (about 21 min of 12.8 kbps audio in one packet);
# anything larger is a corrupt or hostile length prefix
MAX_PACKET = 2 * 1024 * 1024


def send_packet(sock, payload: bytes) -> None:
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def recv_packet(sock) -> Optional[bytes]:
    """-> the payload, or None at the end of the stream (a zero-length
    packet or a closed socket)."""
    head = _recv_exact(sock, _LEN.size)
    if head is None:
        return None
    (n,) = _LEN.unpack(head)
    if n == 0:
        return None
    if n > MAX_PACKET:
        raise ValueError(f"packet length {n} exceeds MAX_PACKET "
                         f"{MAX_PACKET}: corrupt stream")
    return _recv_exact(sock, n)


class CodecTransmitter:
    """Streaming encoder -> bitstream packets (the tx side)."""

    def __init__(self, codec: StreamingCodec, frame_size: int,
                 sample_rate: int = 48000):
        hop = codec.cfg.hop_length
        assert frame_size % hop == 0, \
            f"frame_size {frame_size} % hop {hop} != 0"
        self.codec = codec
        self.frame_size = frame_size
        self.sample_rate = sample_rate
        self.bytes_sent = 0
        self.frames = 0
        self.encode_times = []

    def run(self, x: np.ndarray, sock, realtime: bool = False) -> dict:
        """Stream x (T, C) through the encoder into `sock`, then send the
        end-of-stream packet.  -> the tx statistics."""
        cfg = self.codec.cfg
        size = cfg.codebook_size
        hop = cfg.hop_length
        self.codec.warmup(self.frame_size)
        self.codec.reset()
        # zero-pad a last partial frame (the receiver's output is whole
        # frames; ref demoFile.py:58-61 trims at the sink)
        rem = len(x) % self.frame_size
        if rem:
            pad = np.zeros((self.frame_size - rem, x.shape[-1]), x.dtype)
            x = np.concatenate([x, pad], axis=0)
        frames = x.reshape(-1, self.frame_size, x.shape[-1])
        offsets = np.arange(cfg.codebook_num) * size
        frame_dt = self.frame_size / self.sample_rate
        for f in frames:
            t0 = time.perf_counter()
            idx = self.codec.encode(f[None]).cpu().numpy()
            # streaming indices are flattened (layer q offset by q * size,
            # ref vq_module.py:136-149); the bitstream packs each layer's
            raw = idx[0] - offsets
            payload = pack_codes(raw, size, self.sample_rate, hop)
            self.encode_times.append(time.perf_counter() - t0)
            send_packet(sock, payload)
            self.bytes_sent += _LEN.size + len(payload)
            self.frames += 1
            if realtime:
                time.sleep(max(0.0, frame_dt - self.encode_times[-1]))
        send_packet(sock, b"")
        audio_secs = self.frames * frame_dt
        return {
            "frames": self.frames,
            "audio_seconds": audio_secs,
            "wire_kbps": (self.bytes_sent * 8 / 1000.0 / audio_secs
                          if audio_secs else 0.0),
            "encode_ms_mean": float(np.mean(self.encode_times) * 1000)
            if self.encode_times else 0.0,
        }


class CodecReceiver:
    """Bitstream packets -> streaming decoder (the rx side)."""

    def __init__(self, codec: StreamingCodec):
        self.codec = codec
        self.decode_times = []

    def run(self, sock) -> Tuple[np.ndarray, dict]:
        """Receive until the end of the stream; -> (decoded (T, C), rx
        statistics)."""
        cfg = self.codec.cfg
        offsets = np.arange(cfg.codebook_num) * cfg.codebook_size
        self.codec.reset()
        outs = []
        while True:
            payload = recv_packet(sock)
            if payload is None:
                break
            idx, info = unpack_codes(payload)
            if (info["num_q"] != cfg.codebook_num
                    or info["hop"] != cfg.hop_length):
                raise ValueError(
                    f"bitstream ({info['num_q']} books, hop {info['hop']}) "
                    f"doesn't match codec ({cfg.codebook_num} books, hop "
                    f"{cfg.hop_length})")
            t0 = time.perf_counter()
            flat = torch.from_numpy(idx + offsets)[None].to(self.codec.device)
            y = self.codec.decode(flat).cpu().numpy()
            self.decode_times.append(time.perf_counter() - t0)
            outs.append(y[0])
        y = (np.concatenate(outs, axis=0) if outs
             else np.zeros((0, 1), np.float32))
        return y, {
            "frames": len(outs),
            "decode_ms_mean": float(np.mean(self.decode_times) * 1000)
            if self.decode_times else 0.0,
        }
