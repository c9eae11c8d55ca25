"""The port's streamers (`streaming/streamer.py`), its network transport
(`streaming/net.py`) and their command lines (`bin/demo_stream.py`,
`bin/demo_net.py`), mirroring JAX's cases (tests/test_streaming.py) on
gen_small's weights: against JAX's streamers and transport, and bit for bit
against the port's own StreamingCodec fed the same frames.
"""

import math
import os
import socket
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax

from audiodec_tpu.models.autoencoder import GeneratorConfig as JaxConfig
from audiodec_tpu.streaming import SimulatedStreamer as JaxSimulated
from audiodec_tpu.streaming import StreamingCodec as JaxCodec
from audiodec_tpu.streaming import net as jax_net
from audiodec_tpu.utils.torch_import import import_autoencoder
from audiodec_tpu_torch.bin import demo_net, demo_stream
from audiodec_tpu_torch.data.wav import read_wav, write_wav
from audiodec_tpu_torch.models.autoencoder import GeneratorConfig
from audiodec_tpu_torch.streaming import (
    DeviceStreamer,
    SimulatedStreamer,
    StreamingCodec,
)
from audiodec_tpu_torch.streaming import net
from audiodec_tpu_torch.utils.bridge import params_from_jax, params_to_jax
from audiodec_tpu_torch.utils.checkpoint import save_checkpoint

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
SMALL = dict(encode_channels=4, decode_channels=4, code_dim=16,
             codebook_num=4, codebook_size=32)
CFG = GeneratorConfig(**SMALL)
HOP = CFG.hop_length
FRAME = 2 * HOP
SR = 48000


@pytest.fixture(scope="module")
def weights():
    data = np.load(os.path.join(GOLDEN, "gen_small.npz"))
    sd = {k[len("sd__"):]: data[k] for k in data.files
          if k.startswith("sd__")}
    jparams = jax.tree_util.tree_map(
        np.asarray, import_autoencoder(sd, JaxConfig(**SMALL)))
    return jparams, params_from_jax(jparams)


def _codec(weights):
    return StreamingCodec(weights[1], CFG, device="cpu")


def _signal(seed, n):
    return (0.3 * np.random.default_rng(seed).standard_normal((n, 1))
            ).astype(np.float32)


def _frame_by_frame(codec, x, frame=FRAME):
    """The codec fed x's whole frames one encode and one decode each, from
    the zero state -> (indices, waveform (T, C))."""
    codec.reset()
    idxs, ys = [], []
    for i in range(len(x) // frame):
        idx = codec.encode(x[None, i * frame:(i + 1) * frame])
        idxs.append(idx)
        ys.append(codec.decode(idx))
    return (torch.cat(idxs, dim=1)[0].numpy(),
            torch.cat(ys, dim=1)[0].numpy())


def test_simulated_streamer_matches_jax_and_the_stream(weights):
    """SimulatedStreamer's output equals the port's StreamingCodec fed the
    same frames bit for bit, and JAX's SimulatedStreamer's within 1e-5;
    the statistics are JAX's keys."""
    x = _signal(3, 6 * HOP + 77)             # a partial frame at the end
    streamer = SimulatedStreamer(_codec(weights), frame_size=FRAME,
                                 max_latency_ms=1e5)
    y = streamer.run(x)
    assert y.shape == (6 * HOP, 1)
    _, want = _frame_by_frame(_codec(weights), x)
    np.testing.assert_array_equal(y, want)
    jstreamer = JaxSimulated(JaxCodec(weights[0], JaxConfig(**SMALL)),
                             frame_size=FRAME, max_latency_ms=1e5)
    jy = jstreamer.run(x)
    assert np.abs(jy).max() > 1e-2
    np.testing.assert_allclose(y, jy, rtol=1e-5, atol=1e-5)
    stats = streamer.stats()
    assert stats.keys() == jstreamer.stats().keys()
    assert stats["frames"] == 3 and stats["drop_ratio"] == 0.0
    assert stats["encode_ms_mean"] > 0 and stats["decode_ms_mean"] > 0
    with pytest.raises(AssertionError):
        SimulatedStreamer(_codec(weights), frame_size=HOP + 1)


def test_realtime_streamer_paces_the_frames(weights):
    """realtime=True sleeps a frame's duration per frame; nothing drops at
    a large latency limit and the output is the stream's."""
    x = _signal(5, 8 * HOP)
    streamer = SimulatedStreamer(_codec(weights), frame_size=HOP,
                                 max_latency_ms=1e5, realtime=True)
    t0 = time.perf_counter()
    y = streamer.run(x)
    assert time.perf_counter() - t0 >= 8 * HOP / SR
    _, want = _frame_by_frame(_codec(weights), x, frame=HOP)
    np.testing.assert_array_equal(y, want)
    assert streamer.stats()["drop_ratio"] == 0.0
    assert len(streamer.latencies) == 8


def test_streamer_latency_watchdog(weights):
    """max_latency 0 drops every frame as silence (ref bin/stream.py:
    259-266)."""
    streamer = SimulatedStreamer(_codec(weights), frame_size=FRAME,
                                 max_latency_ms=0.0)
    y = streamer.run(_signal(4, 4 * HOP))
    assert streamer.stats()["drop_ratio"] == 1.0
    np.testing.assert_array_equal(y, np.zeros_like(y))


class _FakeSoundDevice:
    """A stand-in for sounddevice: a duplex Stream whose context drives the
    callback with seeded microphone frames from a thread."""

    def __init__(self, n_frames: int, in_channels: int = 1,
                 out_channels: int = 1):
        self.n_frames = n_frames
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.captured = []
        fake = self

        class Stream:
            def __init__(self, device, samplerate, blocksize, dtype,
                         latency, channels, callback):
                assert channels == (fake.in_channels, fake.out_channels)
                self.blocksize = blocksize
                self.callback = callback

            def __enter__(self):
                def drive():
                    rng = np.random.default_rng(0)
                    for _ in range(fake.n_frames):
                        indata = 0.1 * rng.standard_normal(
                            (self.blocksize, fake.in_channels)).astype(
                                np.float32)
                        outdata = np.zeros(
                            (self.blocksize, fake.out_channels), np.float32)
                        self.callback(indata, outdata, self.blocksize,
                                      None, None)
                        fake.captured.append(outdata.copy())
                        time.sleep(0.002)

                self._t = threading.Thread(target=drive, daemon=True)
                self._t.start()
                return self

            def __exit__(self, *exc):
                self._t.join()

        self.Stream = Stream


def test_device_streamer(weights, tmp_path):
    """The live pipeline against a fake audio driver: every frame flows,
    the dumps are written, the statistics fill."""
    n_frames = 6
    fake = _FakeSoundDevice(n_frames)
    streamer = DeviceStreamer(_codec(weights), frame_size=FRAME,
                              max_latency_ms=1e5, sd_module=fake)
    streamer.enable_filedump(input_stream_file=str(tmp_path / "in"),
                             output_stream_file=str(tmp_path / "out.wav"))
    streamer.run(duration=1.0)
    stats = streamer.stats()
    assert stats["frames"] == n_frames and stats["drop_ratio"] == 0.0
    assert stats["decode_ms_mean"] > 0
    xi, sri = read_wav(str(tmp_path / "in.wav"))
    xo, _ = read_wav(str(tmp_path / "out.wav"))
    assert xi.shape == xo.shape == (n_frames * FRAME, 1) and sri == SR
    with pytest.raises(ValueError):
        streamer.enable_filedump()
    with pytest.raises(AssertionError):
        DeviceStreamer(_codec(weights), frame_size=HOP + 1, sd_module=fake)


def test_device_streamer_requires_sounddevice(weights, monkeypatch):
    monkeypatch.setitem(sys.modules, "sounddevice", None)
    streamer = DeviceStreamer(_codec(weights), frame_size=HOP)
    with pytest.raises(RuntimeError, match="sounddevice"):
        streamer.run(duration=0.01)


def _transport(tx_codec, rx_codec, tx_cls, rx_cls, x):
    a, b = socket.socketpair()
    results = {}

    def rx():
        results["y"], results["stats"] = rx_cls(rx_codec).run(b)

    t = threading.Thread(target=rx)
    t.start()
    tx_stats = tx_cls(tx_codec, frame_size=FRAME, sample_rate=SR).run(x, a)
    t.join(timeout=60)
    a.close()
    b.close()
    return tx_stats, results["y"], results["stats"]


def test_network_transport_matches_jax(weights):
    """tx and rx over a socketpair: the received waveform equals the port's
    StreamingCodec decode of the same (tail-padded) frames bit for bit and
    JAX's transport within 1e-5; the wire carries the packets' exact
    bytes."""
    n = 6
    x = _signal(9, n * FRAME - 13)          # tx zero-pads the last frame
    tx_stats, y, rx_stats = _transport(_codec(weights), _codec(weights),
                                       net.CodecTransmitter,
                                       net.CodecReceiver, x)
    assert tx_stats["frames"] == rx_stats["frames"] == n
    xp = np.concatenate([x, np.zeros((n * FRAME - len(x), 1), x.dtype)])
    _, want = _frame_by_frame(_codec(weights), xp)
    np.testing.assert_array_equal(y, want)
    jcodec = (JaxCodec(weights[0], JaxConfig(**SMALL)),
              JaxCodec(weights[0], JaxConfig(**SMALL)))
    jtx, jy, _ = _transport(*jcodec, jax_net.CodecTransmitter,
                            jax_net.CodecReceiver, x)
    np.testing.assert_allclose(y, jy, rtol=1e-5, atol=1e-5)
    assert tx_stats["wire_kbps"] == jtx["wire_kbps"]
    bits = math.ceil(math.log2(CFG.codebook_size))
    per_packet = 4 + 24 + math.ceil((FRAME // HOP) * CFG.codebook_num
                                    * bits / 8)
    assert tx_stats["wire_kbps"] == pytest.approx(
        n * per_packet * 8 / 1000.0 / (n * FRAME / SR), rel=1e-9)


def test_packets_frame_and_refuse(weights):
    a, b = socket.socketpair()
    net.send_packet(a, b"abc")
    net.send_packet(a, b"")
    assert net.recv_packet(b) == b"abc"
    assert net.recv_packet(b) is None
    a.sendall(net._LEN.pack(net.MAX_PACKET + 1))
    with pytest.raises(ValueError, match="MAX_PACKET"):
        net.recv_packet(b)
    a.close()
    assert net.recv_packet(b) is None
    b.close()


@pytest.fixture(scope="module")
def narrow(tmp_path_factory, weights):
    """gen_small's weights as a JAX-format checkpoint beside an `inherit:`
    of the symAD config, and a seeded wav of 8 hops and a bit."""
    exp = tmp_path_factory.mktemp("stream_exp")
    with open(os.path.join(ROOT, "configs", "autoencoder",
                           "symAD_vctk_48000_hop300.yaml")) as f:
        (exp / "base.yaml").write_text(f.read())
    (exp / "config.yml").write_text(
        "inherit: base.yaml\ngenerator_params:\n"
        + "".join(f"    {k}: {v}\n" for k, v in SMALL.items()))
    ckpt = str(exp / "checkpoint-1.ckpt")
    save_checkpoint(ckpt, {"gen": params_to_jax(weights[1])}, 1)
    wav = str(exp / "in.wav")
    write_wav(wav, _signal(6, 8 * HOP + 50), SR)
    return ckpt, wav


def test_demo_stream_main(narrow, weights, tmp_path, monkeypatch, capsys):
    """demo_stream on the CPU (--torch-device cpu): the simulated mode
    writes the stream's output; --device streams through sounddevice (a
    fake here) and dumps both sides."""
    ckpt, wav = narrow
    common = ["--encoder", ckpt, "--decoder", ckpt, "--torch-device", "cpu",
              "--frame-size", str(FRAME)]
    stats = demo_stream.main(common + ["-i", wav, "-o",
                                       str(tmp_path / "out.wav")])
    assert stats["frames"] == 4 and stats["drop_ratio"] == 0.0
    y, sr = read_wav(str(tmp_path / "out.wav"))
    x, _ = read_wav(wav)
    _, want = _frame_by_frame(_codec(weights), x)
    assert sr == SR and y.shape == want.shape == (8 * HOP, 1)
    np.testing.assert_allclose(y, want, atol=1 / 32768)
    monkeypatch.setitem(sys.modules, "sounddevice", _FakeSoundDevice(5))
    stats = demo_stream.main(common + [
        "--device", "--duration", "0.5", "--max-latency-ms", "1e5", "-i",
        str(tmp_path / "mic.wav"), "-o", str(tmp_path / "spk.wav")])
    assert stats["frames"] == 5
    assert read_wav(str(tmp_path / "spk.wav"))[0].shape == (5 * FRAME, 1)
    with pytest.raises(SystemExit):
        demo_stream.main(common)            # the simulated mode needs -i


def test_demo_net_main(narrow, weights, tmp_path):
    """demo_net rx and tx over TCP on localhost on the CPU: the received
    wav is the stream's decode of the padded frames."""
    ckpt, wav = narrow
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    common = ["--encoder", ckpt, "--decoder", ckpt, "--device", "cpu",
              "--frame-size", str(FRAME)]
    out = str(tmp_path / "rx.wav")
    results = {}
    rx = threading.Thread(target=lambda: results.update(rx=demo_net.main(
        ["rx", "--listen", f"127.0.0.1:{port}", "-o", out] + common)))
    rx.start()
    deadline = time.monotonic() + 60
    while True:
        try:
            results["tx"] = demo_net.main(
                ["tx", "--connect", f"127.0.0.1:{port}", "-i", wav] + common)
            break
        except ConnectionRefusedError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)
    rx.join(timeout=60)
    assert results["tx"]["frames"] == results["rx"]["frames"] == 5
    x, _ = read_wav(wav)
    xp = np.concatenate([x, np.zeros((5 * FRAME - len(x), 1), np.float32)])
    _, want = _frame_by_frame(_codec(weights), xp)
    y, _ = read_wav(out)
    assert y.shape == want.shape
    np.testing.assert_allclose(y, want, atol=1 / 32768)
