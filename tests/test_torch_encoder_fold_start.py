"""The encoder's batch fold at the utterance's start, on biased weights.

`models/fast.py encoder_apply_batchfold` folds the waveform's time axis
into the batch with a zero halo before the first chunk.  With biased
convs a conv of that halo gives its bias, not the batch path's per-layer
zero padding, so the first frames (those whose receptive field reaches
before the first sample) come out wrong unless they are encoded again
directly.  The port patches them; JAX's fold
(`audiodec_tpu/models/fast.py:312 encoder_apply_batchfold`) does not, and
differs from its direct encoder there.  `tests/test_torch_batchfold.py`
holds the port's fold to JAX's on gen_small, whose biases are zero.

Weights: the trained symAD golden's reference state dict (biased convs);
input: its first 48000 samples.  Tolerance: rtol 1e-5, atol 1e-5 of the
direct encoder's features (peak about 11.6), f32 on the CPU.
"""

import os

import numpy as np
import pytest
import torch

import jax

from audiodec_tpu.models import fast as jax_fast
from audiodec_tpu.models.autoencoder import GeneratorConfig as JaxConfig
from audiodec_tpu.models.autoencoder import encoder_apply as jax_encoder
from audiodec_tpu.utils.torch_import import import_autoencoder
from audiodec_tpu_torch.models import fast
from audiodec_tpu_torch.models.autoencoder import (
    GeneratorConfig,
    encoder_apply,
)
from audiodec_tpu_torch.utils.bridge import params_from_reference_sd

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "gen_symad_trained.npz")
SAMPLES = 48000
RTOL = ATOL = 1e-5


@pytest.fixture(scope="module")
def trained():
    data = np.load(GOLDEN)
    sd = {k[len("sd__"):]: data[k] for k in data.files
          if k.startswith("sd__")}
    x = data["x"][0, 0, :SAMPLES].reshape(1, SAMPLES, 1).astype(np.float32)
    assert any(k.startswith("encoder.conv_blocks") and k.endswith("bias")
               and np.abs(v).max() > 0 for k, v in sd.items())
    params = params_from_reference_sd(sd, GeneratorConfig())["encoder"]
    x = torch.from_numpy(x)
    return sd, x, params, encoder_apply(params, x, GeneratorConfig())


@pytest.mark.parametrize("unfold_after", ["auto", None])
@pytest.mark.parametrize("fold", [2, 4, 8])
def test_encoder_fold_equals_the_direct_encoder(trained, fold,
                                                unfold_after):
    """Every frame of the fold, the first ones included, is the direct
    encoder's (the parent tree differed on frames 0-15 by up to 2e-2)."""
    _, x, params, direct = trained
    got = fast.encoder_apply_batchfold(params, x, GeneratorConfig(),
                                       fold=fold, unfold_after=unfold_after)
    assert got.shape == direct.shape == (1, SAMPLES // 300, 512)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_jax_fold_differs_at_the_start_on_biased_weights(trained):
    """The witness of the reference's fault: on the same weights JAX's
    fold differs from its direct encoder in the first frames only, where
    the port's fold above does not."""
    sd, x, _, direct = trained
    jcfg = JaxConfig()
    jp = import_autoencoder(sd, jcfg)["encoder"]
    xj = x.numpy()

    @jax.jit
    def run(p, x):
        return (jax_encoder(p, x, jcfg),
                jax_fast.encoder_apply_batchfold(p, x, jcfg, fold=4,
                                                 unfold_after=None))

    jdirect, jfold = map(np.asarray, run(jp, xj))
    np.testing.assert_allclose(jdirect, direct.numpy(), rtol=RTOL,
                               atol=ATOL)
    err = np.abs(jfold - jdirect).max(axis=(0, 2))
    halo = 7500 // 300
    assert err[:halo].max() > 1e-3
    assert err[halo:].max() <= ATOL + RTOL * np.abs(jdirect).max()
