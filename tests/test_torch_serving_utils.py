"""The port's serving helpers against the JAX package's: the quality
metrics (`utils/metrics.py`) and the analytic FLOP counts
(`utils/flops.py`); and the Chrome trace of `utils/profiling.py`
`device_trace` and `codec_test --profile` (the spans:
tests/test_torch_spans.py).
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from audiodec_tpu.utils import config as jax_config
from audiodec_tpu.utils import flops as jax_flops
from audiodec_tpu.utils import metrics as jax_metrics
from audiodec_tpu_torch.bin import codec_test as cli
from audiodec_tpu_torch.data.wav import write_wav
from audiodec_tpu_torch.models.vocoder import VocoderConfig
from audiodec_tpu_torch.utils import config, flops, metrics
from audiodec_tpu_torch.utils.bridge import params_to_jax
from audiodec_tpu_torch.utils.checkpoint import save_checkpoint
from audiodec_tpu_torch.utils.profiling import device_trace

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = [p for p in sorted(glob.glob(os.path.join(ROOT, "configs", "**",
                                                    "*.yaml"),
                                       recursive=True))
           if config.load_config(p).get("model_type") in ("symAudioDec",
                                                          "HiFiGAN")]
SR = 48000


@pytest.fixture(scope="module")
def signals():
    rng = np.random.default_rng(11)
    a = (0.3 * rng.standard_normal(19200)).astype(np.float32)
    b = (a + 0.05 * rng.standard_normal(19200)).astype(np.float32)
    c = np.sin(np.arange(14000) * 0.03).astype(np.float32) * 0.4
    return a, b, c


@pytest.mark.parametrize("metric", ["snr_db", "mel_distance", "mcd_db"])
def test_metrics_match_jax(signals, metric):
    """Each metric equals JAX's within a relative 1e-6 on seeded signals of
    unequal lengths (both take the shorter), and on a signal against
    itself."""
    a, b, c = signals
    ours, theirs = getattr(metrics, metric), getattr(jax_metrics, metric)
    kw = {} if metric == "snr_db" else {"sr": SR}
    for x, y in ((a, b), (b, a), (a, c[:9000] + a[:9000]), (c, c)):
        got, want = ours(x, y, **kw), theirs(x, y, **kw)
        if np.isinf(want):
            assert got == want
        else:
            assert got == pytest.approx(want, rel=1e-6, abs=1e-12), (
                metric, got, want)


def test_log_mel_matches_jax_front_end(signals):
    """The metrics' log-mel front end against JAX's mel_spectrogram at the
    metrics' settings, elementwise."""
    import jax.numpy as jnp

    from audiodec_tpu.ops.spectral import mel_spectrogram

    a, _, _ = signals
    want = np.asarray(mel_spectrogram(
        jnp.asarray(a)[None], fs=SR, fft_size=2048, hop_size=300,
        num_mels=80, fmin=0, fmax=SR / 2, log_base=None))[0]
    got = metrics.log_mel(a, SR)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("path", CONFIGS,
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_flops_match_jax(path):
    """Every *_flops function equals JAX's exactly, for every shipped
    config, at lengths of whole hops and not."""
    ours = config.generator_config(config.load_config(path))
    theirs = jax_config.generator_config(jax_config.load_config(path))
    if isinstance(ours, VocoderConfig):
        for n in (1, 160, 1601):
            assert flops.vocoder_flops(ours, n) == jax_flops.vocoder_flops(
                theirs, n)
        return
    for t in (ours.hop_length, 480000, 480000 + 137):
        n = t // ours.hop_length
        assert flops.encoder_flops(ours, t) == jax_flops.encoder_flops(
            theirs, t)
        assert flops.projector_flops(ours, n) == jax_flops.projector_flops(
            theirs, n)
        assert flops.rvq_flops(ours, n) == jax_flops.rvq_flops(theirs, n)
        assert flops.decoder_flops(ours, n) == jax_flops.decoder_flops(
            theirs, n)
        assert flops.transcode_flops(ours, t) == jax_flops.transcode_flops(
            theirs, t)


def _traces(d):
    return sorted(glob.glob(os.path.join(str(d), "trace-*.json")))


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(None):
        pass
    assert not os.listdir(tmp_path)
    with device_trace(str(tmp_path / "prof"), device="cpu"):
        torch.nn.functional.conv1d(torch.ones(1, 2, 64), torch.ones(3, 2, 5))
    (trace,) = _traces(tmp_path / "prof")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    assert any("conv" in e.get("name", "") for e in events)


def test_codec_test_profile_writes_a_trace(tmp_path):
    """`codec_test --profile DIR` traces the transcode loop."""
    from audiodec_tpu_torch.models.autoencoder import (
        GeneratorConfig,
        generator_init,
    )

    small = dict(encode_channels=4, decode_channels=4, code_dim=16,
                 codebook_num=4, codebook_size=32)
    exp = tmp_path / "exp"
    exp.mkdir()
    with open(os.path.join(ROOT, "configs", "autoencoder",
                           "symAD_vctk_48000_hop300.yaml")) as f:
        (exp / "base.yaml").write_text(f.read())
    (exp / "config.yml").write_text(
        "inherit: base.yaml\ngenerator_params:\n"
        + "".join(f"    {k}: {v}\n" for k, v in small.items()))
    params = generator_init(GeneratorConfig(**small),
                            torch.Generator().manual_seed(0))
    ckpt = str(exp / "checkpoint-1.ckpt")
    save_checkpoint(ckpt, {"gen": params_to_jax(params)}, 1)
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        write_wav(str(wavs / f"u{i}.wav"),
                  (0.3 * rng.standard_normal((3000, 1))).astype(np.float32),
                  SR)
    summary = cli.main(["--encoder", ckpt, "--decoder", ckpt, "--data-path",
                        str(wavs), "--outdir", str(tmp_path / "out"),
                        "--device", "cpu", "--profile",
                        str(tmp_path / "prof")])
    assert summary["utterances"] == 2
    (trace,) = _traces(tmp_path / "prof")
    assert os.path.getsize(trace) > 0
