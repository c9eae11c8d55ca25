"""The port's code statistics (`bin/codec_stats.py`: `RunningMoments`,
`_windows`, `extract_stats`) against the JAX package's on seeded wavs at
gen_small-like widths, against a whole-utterance encode, and against the
reference's sklearn StandardScaler.

An analyzer at the init's 0.01 weight scale puts out codes a hair from
constant (z about 1e-7 against unit codebooks: one code per layer); the
`analyzer` fixture rescales the encoder's and projector's weights to unit
gain so that every codebook entry is used, and the collapsed init is the
constant-feature case.  There the port's scale is StandardScaler's 1,
where JAX's is 0 (ROADMAP.md §C).

Tolerances: windows exactly; moments against StandardScaler within a
relative 1e-12; mean and scale within a relative 1e-5 of the largest entry
against JAX's and against the whole-utterance encode.
"""

import jax
import numpy as np
import pytest
import torch

from audiodec_tpu.bin import codec_stats as jax_stats
from audiodec_tpu.data.dataset import SingleDataset as JaxDataset
from audiodec_tpu.models import autoencoder as jax_ae
from audiodec_tpu_torch.bin import codec_stats
from audiodec_tpu_torch.data.dataset import SingleDataset
from audiodec_tpu_torch.data.wav import write_wav
from audiodec_tpu_torch.models import autoencoder as ae
from audiodec_tpu_torch.parallel.codec import encoder_halo_samples
from audiodec_tpu_torch.utils import bridge

torch.set_num_threads(1)

WIDTHS = dict(encode_channels=4, decode_channels=4, code_dim=16,
              codebook_num=4, codebook_size=32)
CFG = ae.GeneratorConfig(**WIDTHS)
# whole windows, tails of every size class (under a hop, over one, a
# whole-window multiple) and an utterance shorter than one window
LENGTHS = (48000, 50000, 96150, 20000, 110, 60299)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("stats")
    rng = np.random.default_rng(11)
    for i, n in enumerate(LENGTHS):
        t = np.arange(n)
        x = 0.3 * np.sin(t * rng.uniform(0.01, 0.2))
        x = x + 0.05 * rng.standard_normal(n)
        write_wav(str(root / f"u{i}.wav"), x.astype(np.float32), 48000)
    return str(root)


def _unit_gain(tree):
    """Every conv weight rescaled to std 1 / sqrt(fan-in)."""
    if isinstance(tree, list):
        return [_unit_gain(v) for v in tree]
    if "w" in tree:
        w = tree["w"]
        return dict(tree, w=w / w.std() / w[0].numel() ** 0.5)
    return {k: _unit_gain(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def collapsed():
    return ae.generator_init(CFG, torch.Generator().manual_seed(3))


@pytest.fixture(scope="module")
def params(collapsed):
    return dict(collapsed, encoder=_unit_gain(collapsed["encoder"]),
                projector=_unit_gain(collapsed["projector"]))


def _scaler(chunks):
    from sklearn.preprocessing import StandardScaler

    scaler = StandardScaler()
    for c in chunks:
        if len(c):
            scaler.partial_fit(c)
    return scaler


def test_running_moments_match_standard_scaler():
    """Chan's merge and the finalized [mean, scale] against the
    reference's StandardScaler.partial_fit, a constant feature (scale 1)
    and one 1e-9 from constant included; JAX's RunningMoments differs only
    at the constant one (its rounding noise, about 1e-16, as the
    scale)."""
    rng = np.random.default_rng(1)
    chunks = [rng.standard_normal((n, 5)) * 3 + 1 for n in (7, 1, 0, 30)]
    for c in chunks:
        c[:, 3] = 0.7
        c[:, 4] = 1.0 + 1e-9 * rng.standard_normal(len(c))
    ours, theirs = codec_stats.RunningMoments(5), jax_stats.RunningMoments(5)
    for c in chunks:
        ours.update(c)
        theirs.update(c)
    scaler = _scaler(chunks)
    np.testing.assert_allclose(ours.mean, scaler.mean_, rtol=1e-12)
    np.testing.assert_allclose(ours.m2 / ours.n, scaler.var_, rtol=1e-12,
                               atol=1e-24)
    mean, scale = ours.finalize()
    np.testing.assert_allclose(scale, scaler.scale_.astype(np.float32),
                               rtol=1e-6)
    assert scale[3] == 1.0 and 0 < scale[4] < 1e-8
    jmean, jscale = theirs.finalize()
    np.testing.assert_array_equal(mean, jmean)
    assert jscale[3] < 1e-12
    np.testing.assert_array_equal(np.delete(scale, 3), np.delete(jscale, 3))


def test_windows_match_jax(corpus):
    halo = encoder_halo_samples(CFG)
    assert halo > 0
    ours = list(codec_stats._windows(SingleDataset(corpus), 1500, 300, halo))
    theirs = list(jax_stats._windows(JaxDataset(corpus), 1500, 300, halo))
    assert len(ours) == len(theirs) > len(LENGTHS)
    for (w, n), (jw, jn) in zip(ours, theirs):
        assert n == jn
        np.testing.assert_array_equal(w, jw)


@pytest.mark.parametrize("batch_size", [3, 8])
def test_extract_stats_matches_jax(corpus, params, batch_size):
    """Any grouping of the windows gives JAX's mean and scale (JAX jits
    one batch shape per batch size)."""
    want = jax_stats.extract_stats(
        jax.tree_util.tree_map(np.asarray, bridge.params_to_jax(params)),
        jax_ae.GeneratorConfig(**WIDTHS), JaxDataset(corpus),
        batch_size=batch_size)
    got = codec_stats.extract_stats(params, CFG, SingleDataset(corpus),
                                    batch_size=batch_size)
    assert got.shape == (2, CFG.code_dim) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def test_windowed_equals_whole_utterance(corpus, params):
    """The halo makes the windowed codes a whole-utterance encode's: the
    moments of every frame of every utterance, each encoded whole."""
    mom = codec_stats.RunningMoments(CFG.code_dim)
    dataset = SingleDataset(corpus)
    with torch.no_grad():
        for i in range(len(dataset)):
            x = torch.from_numpy(dataset[i])[None]
            n = x.shape[1] // CFG.hop_length
            if n == 0:
                continue
            h = ae.encoder_apply(params["encoder"], x, CFG)
            z = ae.projector_apply(params["projector"], h, CFG)
            zq = codec_stats.rvq_forward_index(z, params["quantizer"])[0]
            mom.update(zq[0, :n].numpy().astype(np.float64))
    want = np.stack(mom.finalize())
    got = codec_stats.extract_stats(params, CFG, dataset, window_hops=4,
                                    batch_size=5)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def test_collapsed_codes_give_standard_scalers_scale(corpus, collapsed):
    """The init's one code per layer: every frame's codes within rounding
    of each other.  The port gives StandardScaler's scale over the same
    frames (1 where a feature is constant); its mean is JAX's."""
    frames = []
    dataset = SingleDataset(corpus)
    halo = encoder_halo_samples(CFG)
    with torch.no_grad():
        for w, n in codec_stats._windows(dataset, 300 * 160, 300, halo):
            x = torch.from_numpy(w)[None]
            h = ae.encoder_apply(collapsed["encoder"], x, CFG)
            z = ae.projector_apply(collapsed["projector"], h, CFG)
            zq = codec_stats.rvq_forward_index(z, collapsed["quantizer"])[0]
            frames.append(zq[0, halo // 300:][:n].numpy().astype(np.float64))
    scaler = _scaler(frames)
    got = codec_stats.extract_stats(collapsed, CFG, dataset)
    assert np.any(scaler.scale_ == 1.0)
    np.testing.assert_allclose(got[0], scaler.mean_, rtol=1e-5)
    np.testing.assert_allclose(got[1], scaler.scale_, rtol=1e-5, atol=1e-12)
    want = jax_stats.extract_stats(
        jax.tree_util.tree_map(np.asarray, bridge.params_to_jax(collapsed)),
        jax_ae.GeneratorConfig(**WIDTHS), JaxDataset(corpus))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert np.all(want[1][got[1] == 1.0] < 1e-6)
