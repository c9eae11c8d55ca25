"""The port's spectral ops (`ops/spectral.py`) and training losses
(`losses/`) against the JAX package's, on the same seeded inputs.

Tolerances: spectra and losses within a relative 1e-5 of JAX's (float32
FFTs from two libraries), mel-loss gradients within a relative 1e-4 of the
largest entry; the filterbank and the window to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodec_tpu import losses as jax_losses
from audiodec_tpu.losses import mel as jax_mel
from audiodec_tpu.ops import spectral as jax_spectral
from audiodec_tpu_torch import losses
from audiodec_tpu_torch.losses import mel as mel_mod
from audiodec_tpu_torch.ops import spectral

torch.set_num_threads(1)

# (fft, hop, win): full window; a window shorter than the FFT, zero-padded
# (the UnivNet discriminator's and the reference losses'); an odd hop
POINTS = [(512, 128, 512), (1024, 120, 600), (256, 50, 240)]


def _signal(seed, shape):
    return (0.3 * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(got, want, rtol=1e-5):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def test_window_and_filterbank_match_jax():
    for n, fft in ((240, 256), (600, 1024), (2048, 2048)):
        np.testing.assert_array_equal(spectral._padded_window(n, fft),
                                      jax_spectral._padded_window(n, fft))
    for args in ((48000, 2048, 80, 0.0, 24000.0), (22050, 1024, 80, 80.0,
                                                   7600.0)):
        np.testing.assert_allclose(spectral.mel_filterbank(*args),
                                   jax_spectral.mel_filterbank(*args),
                                   rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("pad", [0, 7])
@pytest.mark.parametrize("fft,hop,win", POINTS)
def test_stft_magnitude_matches_jax(fft, hop, win, pad):
    """Framing (zero `pad` first, then reflect padding) and |STFT|, with and
    without the eps clamp."""
    x = _signal(1, (2, 2400))
    frames = spectral.frame_signal(torch.from_numpy(x), fft, hop, pad=pad)
    _close(frames, jax_spectral.frame_signal(jnp.asarray(x), fft, hop,
                                             pad=pad), rtol=0)
    for eps in (0.0, 1e-7):
        got = spectral.stft_magnitude(torch.from_numpy(x), fft, hop, win,
                                      pad=pad, eps=eps)
        want = jax_spectral.stft_magnitude(jnp.asarray(x), fft, hop, win,
                                           pad=pad, eps=eps)
        _close(got, want)


@pytest.mark.parametrize("log_base", [None, 2.0, 10.0])
def test_mel_spectrogram_matches_jax(log_base):
    x = _signal(2, (2, 4800))
    kw = dict(fs=48000, fft_size=1024, hop_size=120, win_length=600,
              num_mels=40, fmin=0, fmax=24000, log_base=log_base)
    _close(spectral.mel_spectrogram(torch.from_numpy(x), **kw),
           jax_spectral.mel_spectrogram(jnp.asarray(x), **kw))


def _pair(seed, channels=1):
    y = _signal(seed, (2, 3000, channels))
    y_hat = (y + _signal(seed + 1, y.shape) * 0.5).astype(np.float32)
    return y_hat, y


@pytest.mark.parametrize("channels", [1, 2])
def test_mel_loss_and_gradient_match_jax(channels):
    """The symAD config's mel loss block (one resolution, natural log) and
    the defaults' three resolutions, with d loss / d y_hat against
    jax.grad."""
    y_hat, y = _pair(3, channels)
    for params in ({"fs": 48000, "fft_sizes": [2048], "hop_sizes": [300],
                    "win_lengths": [2048], "num_mels": 80, "fmin": 0,
                    "fmax": 24000, "log_base": None}, {}):
        ours = mel_mod.from_config(48000, params)
        theirs = jax_mel.from_config(48000, params)
        t = torch.from_numpy(y_hat).requires_grad_(True)
        loss = ours(t, torch.from_numpy(y))
        loss.backward()
        want, grad = jax.jit(jax.value_and_grad(theirs))(
            jnp.asarray(y_hat), jnp.asarray(y))
        _close(loss.detach(), want)
        _close(t.grad, grad, rtol=1e-4)


@pytest.mark.parametrize("fft,hop,win", POINTS)
def test_stft_loss_matches_jax(fft, hop, win):
    y_hat, y = _pair(4)
    ours = losses.MultiResolutionSTFTLoss((fft,), (hop,), (win,))
    theirs = jax_losses.MultiResolutionSTFTLoss((fft,), (hop,), (win,))
    for got, want in zip(ours(torch.from_numpy(y_hat), torch.from_numpy(y)),
                         theirs(jnp.asarray(y_hat), jnp.asarray(y))):
        _close(got, want)


@pytest.mark.parametrize("winlen", [(300,), (300, 200, 100)])
def test_shape_loss_matches_jax(winlen):
    y_hat, y = _pair(5, channels=2)
    _close(losses.MultiWindowShapeLoss(winlen)(torch.from_numpy(y_hat),
                                               torch.from_numpy(y)),
           jax_losses.MultiWindowShapeLoss(winlen)(jnp.asarray(y_hat),
                                                   jnp.asarray(y)))


def _disc_outputs(seed):
    """Nested discriminator-like outputs: 3 sub-discriminators of 2-4
    feature maps, logits last."""
    rng = np.random.default_rng(seed)
    return [[rng.standard_normal((2, 3, 5 + j)).astype(np.float32)
             for j in range(n)] for n in (2, 3, 4)]


def _to(tree, fn):
    return [[fn(a) for a in branch] for branch in tree]


@pytest.mark.parametrize("loss_type", ["mse", "hinge"])
@pytest.mark.parametrize("average", [True, False])
def test_adversarial_losses_match_jax(loss_type, average):
    p_hat, p = _disc_outputs(6), _disc_outputs(7)
    kw = dict(loss_type=loss_type, average_by_discriminators=average)
    _close(losses.generator_adversarial_loss(_to(p_hat, torch.from_numpy),
                                             **kw),
           jax_losses.generator_adversarial_loss(_to(p_hat, jnp.asarray),
                                                 **kw))
    got = losses.discriminator_adversarial_loss(
        _to(p_hat, torch.from_numpy), _to(p, torch.from_numpy), **kw)
    want = jax_losses.discriminator_adversarial_loss(
        _to(p_hat, jnp.asarray), _to(p, jnp.asarray), **kw)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("flags", [(True, True, False), (False, False, False),
                                   (True, False, True)])
def test_feature_match_loss_matches_jax(flags):
    layers, discs, final = flags
    p_hat, p = _disc_outputs(8), _disc_outputs(9)
    kw = dict(average_by_layers=layers, average_by_discriminators=discs,
              include_final_outputs=final)
    _close(losses.feature_match_loss(_to(p_hat, torch.from_numpy),
                                     _to(p, torch.from_numpy), **kw),
           jax_losses.feature_match_loss(_to(p_hat, jnp.asarray),
                                         _to(p, jnp.asarray), **kw))


def test_metrics_front_end_reads_ops_spectral():
    """utils/metrics.py's log-mel is ops/spectral.py's mel_spectrogram."""
    from audiodec_tpu_torch.utils import metrics

    x = _signal(10, (9600,))
    want = spectral.mel_spectrogram(torch.from_numpy(x)[None], fs=48000,
                                    fft_size=2048, hop_size=300, fmin=0,
                                    fmax=24000, log_base=None)[0]
    np.testing.assert_array_equal(metrics.log_mel(x, 48000), want.numpy())
