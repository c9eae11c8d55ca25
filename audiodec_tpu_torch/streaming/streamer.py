"""Streamers on the streaming codec (counterpart of
audiodec_tpu/streaming/streamer.py: `DeviceStreamer`, `SimulatedStreamer`;
ref bin/stream.py:80-366, demoStream.py).

Frames go through an encoder thread and a decoder thread joined by queues;
the RVQ indices are the only payload between them (the tx -> rx "wire",
ref utils/audiodec.py:100-106).  A latency watchdog drops frames that
arrive later than `max_latency_ms`, and `stats()` gives the reference
streamer's exit statistics (ref bin/stream.py:295-311).

The two threads share one `StreamingCodec`: the encoder's and the
decoder's states are separate, and each call enters inference mode in its
own thread.  Each encode and decode waits for the device
(`torch.cuda.synchronize`) before its clock stops, so the times are the
device's work, not the launches.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from audiodec_tpu_torch.data.wav import write_wav
from audiodec_tpu_torch.streaming.engine import StreamingCodec


def _sync(codec: StreamingCodec):
    if codec.device.type == "cuda":
        torch.cuda.synchronize(codec.device)


def _stats(encoder_times, decoder_times, latencies, frames, drops) -> dict:
    def ms(xs):
        return ((float(np.mean(xs) * 1000), float(np.std(xs) * 1000))
                if xs else (0.0, 0.0))
    em, es = ms(encoder_times)
    dm, ds = ms(decoder_times)
    lm, ls = ms(latencies)
    return {
        "encode_ms_mean": em, "encode_ms_std": es,
        "decode_ms_mean": dm, "decode_ms_std": ds,
        "latency_ms_mean": lm, "latency_ms_std": ls,
        "frames": frames,
        "drop_ratio": drops / max(1, frames),
    }


def _check_frame(codec: StreamingCodec, frame_size: int):
    hop = codec.cfg.hop_length
    assert frame_size % hop == 0, \
        f"frame_size {frame_size} % hop {hop} != 0 (demoStream.py:53-54)"


class DeviceStreamer:
    """Live duplex audio: microphone -> codec -> speaker (ref bin/stream.py
    AudioCodecStreamer and demoStream.py).

    The audio driver's callback pushes each captured frame (times `gain`)
    to the encoder queue and takes the newest decoded frame, or silence
    while the pipeline fills.  When a frame's latency exceeds
    `max_latency_ms` every queue is flushed and the pending frames count as
    drops (ref bin/stream.py:259-266).

    Needs the `sounddevice` package, imported only in `run()`; `sd_module`
    injects a stand-in driver."""

    def __init__(self, codec: StreamingCodec, frame_size: int,
                 input_device=None, output_device=None,
                 input_channels: int = 1, output_channels: int = 1,
                 sample_rate: int = 48000, gain: float = 1.0,
                 max_latency_ms: float = 100.0, sd_module=None):
        _check_frame(codec, frame_size)
        self.codec = codec
        self.frame_size = frame_size
        self.input_device = input_device
        self.output_device = output_device
        self.input_channels = input_channels
        self.output_channels = output_channels
        self.sample_rate = sample_rate
        self.gain = gain
        self.max_latency = max_latency_ms / 1000.0
        self._sd = sd_module
        self.encoder_queue: queue.Queue = queue.Queue()
        self.decoder_queue: queue.Queue = queue.Queue()
        self.output_queue: queue.Queue = queue.Queue()
        self.latency_queue: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        # file dumps (ref enable_filedump, bin/stream.py:313-333)
        self.input_dump = []
        self.output_dump = []
        self.input_dump_filename = None
        self.output_dump_filename = None
        self.frame_drops = 0
        self.n_frames = 0
        self.encoder_times = []
        self.decoder_times = []
        self.latencies = []

    def enable_filedump(self, input_stream_file: Optional[str] = None,
                        output_stream_file: Optional[str] = None):
        """Write the input and/or output audio to wav at exit; call before
        run()."""
        if input_stream_file is None and output_stream_file is None:
            raise ValueError("at least one of input_stream_file and "
                             "output_stream_file must be specified")
        if input_stream_file is not None:
            if not input_stream_file.endswith(".wav"):
                input_stream_file += ".wav"
            self.input_dump_filename = input_stream_file
        if output_stream_file is not None:
            if not output_stream_file.endswith(".wav"):
                output_stream_file += ".wav"
            self.output_dump_filename = output_stream_file

    def _run_encoder(self):
        while not self._stop.is_set():
            try:
                frame = self.encoder_queue.get(timeout=1)
            except queue.Empty:
                continue
            t0 = time.perf_counter()
            idx = self.codec.encode(frame)
            _sync(self.codec)
            self.encoder_times.append(time.perf_counter() - t0)
            self.decoder_queue.put(idx)

    def _run_decoder(self):
        while not self._stop.is_set():
            try:
                idx = self.decoder_queue.get(timeout=1)
            except queue.Empty:
                continue
            t0 = time.perf_counter()
            y = self.codec.decode(idx).cpu().numpy()  # (B, T, C)
            self.decoder_times.append(time.perf_counter() - t0)
            self.output_queue.put(y[0])

    def _process(self, data: np.ndarray) -> np.ndarray:
        """One callback frame: (frame_size, in_ch) -> (frame_size, out_ch)."""
        data = data * self.gain
        if self.input_dump_filename is not None:
            self.input_dump.append(np.array(data, np.float32))
        self.encoder_queue.put(data[None].astype(np.float32))
        self.latency_queue.put(time.perf_counter())
        try:
            output = self.output_queue.get_nowait()
            latency = time.perf_counter() - self.latency_queue.get_nowait()
            self.latencies.append(latency)
            if latency > self.max_latency:
                # flush the pipeline; everything pending is dropped
                self.encoder_queue.queue.clear()
                self.decoder_queue.queue.clear()
                self.output_queue.queue.clear()
                while not self.latency_queue.empty():
                    self.frame_drops += 1
                    self.latency_queue.get_nowait()
        except queue.Empty:
            output = np.zeros((self.frame_size, self.output_channels),
                              np.float32)
        self.n_frames += 1
        if self.output_dump_filename is not None:
            self.output_dump.append(np.array(output, np.float32))
        return output

    def _callback(self, indata, outdata, frames, _time, status):
        if status:
            print(status)
        out = self._process(np.asarray(indata, np.float32))
        outdata[:] = out[:len(outdata)]

    def _exit(self):
        for name, dump in ((self.input_dump_filename, self.input_dump),
                           (self.output_dump_filename, self.output_dump)):
            if name is not None and dump:
                write_wav(name, np.clip(np.concatenate(dump, axis=0), -1, 1),
                          self.sample_rate)
        s = self.stats()
        print("#" * 80)
        print(f"encoder processing time (ms):      "
              f"{s['encode_ms_mean']:.2f} +- {s['encode_ms_std']:.2f}")
        print(f"decoder processing time (ms):      "
              f"{s['decode_ms_mean']:.2f} +- {s['decode_ms_std']:.2f}")
        print(f"system latency (ms):               "
              f"{s['latency_ms_mean']:.2f} +- {s['latency_ms_std']:.2f}")
        print(f"frame drops:                       {self.frame_drops} "
              f"({s['drop_ratio'] * 100:.2f}%)")
        print("#" * 80)

    def run(self, latency="low", duration: Optional[float] = None):
        """Stream from the input device to the output device until Return
        is pressed, or for `duration` seconds; prints the exit statistics
        (ref bin/stream.py:336-366)."""
        sd = self._sd
        if sd is None:
            try:
                import sounddevice as sd  # type: ignore
            except ImportError as e:
                raise RuntimeError(
                    "DeviceStreamer needs the `sounddevice` package (and an "
                    "audio device); without one use SimulatedStreamer / "
                    "demo_stream without --device") from e
        self.codec.warmup(self.frame_size)
        self.codec.reset()
        self._stop.clear()
        enc_t = threading.Thread(target=self._run_encoder, daemon=True)
        dec_t = threading.Thread(target=self._run_decoder, daemon=True)
        enc_t.start()
        dec_t.start()
        try:
            with sd.Stream(
                    device=(self.input_device, self.output_device),
                    samplerate=self.sample_rate,
                    blocksize=self.frame_size,
                    dtype=np.float32,
                    latency=latency,
                    channels=(self.input_channels, self.output_channels),
                    callback=self._callback):
                if duration is None:
                    print("### starting stream [press Return to quit] ###")
                    input()
                else:
                    time.sleep(duration)
        except KeyboardInterrupt:
            pass
        finally:
            self._stop.set()
            enc_t.join(timeout=2)
            dec_t.join(timeout=2)
            self._exit()

    def stats(self) -> dict:
        """Exit statistics (ref bin/stream.py:295-311)."""
        return _stats(self.encoder_times, self.decoder_times, self.latencies,
                      self.n_frames, self.frame_drops)


class SimulatedStreamer:
    """The streaming pipeline without an audio device: `run(x)` pushes the
    frames of a waveform through the encoder and decoder threads, paced at
    the audio rate when `realtime`, and returns the decoded audio, a late
    frame (latency over `max_latency_ms`) replaced by silence."""

    def __init__(self, codec: StreamingCodec, frame_size: int,
                 max_latency_ms: float = 100.0, realtime: bool = False,
                 sample_rate: int = 48000):
        _check_frame(codec, frame_size)
        self.codec = codec
        self.frame_size = frame_size
        self.sample_rate = sample_rate
        self.max_latency = max_latency_ms / 1000.0
        self.realtime = realtime
        self.encoder_queue: queue.Queue = queue.Queue()
        self.decoder_queue: queue.Queue = queue.Queue()
        self.outputs = []
        self.encoder_times = []
        self.decoder_times = []
        self.latencies = []
        self.drops = 0
        self.frames = 0

    def _run_encoder(self):
        while True:
            item = self.encoder_queue.get()
            if item is None:
                self.decoder_queue.put(None)
                return
            t_birth, frame = item
            t0 = time.perf_counter()
            idx = self.codec.encode(frame)
            _sync(self.codec)
            self.encoder_times.append(time.perf_counter() - t0)
            self.decoder_queue.put((t_birth, idx))

    def _run_decoder(self):
        while True:
            item = self.decoder_queue.get()
            if item is None:
                return
            t_birth, idx = item
            t0 = time.perf_counter()
            y = self.codec.decode(idx)
            _sync(self.codec)
            self.decoder_times.append(time.perf_counter() - t0)
            latency = time.perf_counter() - t_birth
            self.latencies.append(latency)
            y = y.cpu().numpy()
            if latency > self.max_latency:
                # watchdog: the late frame becomes silence
                # (ref bin/stream.py:259-266)
                self.drops += 1
                y = np.zeros_like(y)
            self.outputs.append(y)

    def run(self, x: np.ndarray) -> np.ndarray:
        """Stream x (T, C) through the pipeline; -> the decoded audio of its
        whole frames."""
        self.codec.warmup()
        self.codec.reset()
        t = (len(x) // self.frame_size) * self.frame_size
        frames = x[:t].reshape(-1, self.frame_size, x.shape[-1])
        enc_t = threading.Thread(target=self._run_encoder, daemon=True)
        dec_t = threading.Thread(target=self._run_decoder, daemon=True)
        enc_t.start()
        dec_t.start()
        frame_dt = self.frame_size / self.sample_rate
        for f in frames:
            self.frames += 1
            self.encoder_queue.put((time.perf_counter(), f[None]))
            if self.realtime:
                time.sleep(frame_dt)
        self.encoder_queue.put(None)
        enc_t.join()
        dec_t.join()
        return np.concatenate(self.outputs, axis=1)[0]

    def stats(self) -> dict:
        """Exit statistics (ref bin/stream.py:295-311)."""
        return _stats(self.encoder_times, self.decoder_times, self.latencies,
                      self.frames, self.drops)
