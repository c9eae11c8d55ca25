"""The discriminators' batched variants (`models/discriminators.py`
`msd_apply_batched`, `mpd_apply_batched`, the combined applies'
`batched=True`) against the port's sequential applies and the JAX
package's batched variants, in every feature map and in the gradients of a
loss over all of them with respect to the discriminator's parameters.

Tolerances: within a relative 1e-5 of the largest entry, per map and per
gradient leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodec_tpu.models import discriminators as JD
from audiodec_tpu.ops import norms as jax_norms
from audiodec_tpu_torch.models import discriminators as D
from audiodec_tpu_torch.ops import norms
from audiodec_tpu_torch.train.optim import tree_leaves
from audiodec_tpu_torch.utils import bridge
from tests.test_torch_discriminators import (
    CASES,
    SMALL_MSD,
    _close,
    _layout,
    _port_cfg,
    _trees_close,
    _with,
)

torch.set_num_threads(1)

BATCHED = {
    "hifigan_spectral_norm": CASES["hifigan_spectral_norm"],
    "univnet": CASES["univnet"],
    # the shipped configs' branch counts: 3 scales, 5 periods
    "hifigan_every_branch": JD.HiFiGANDiscriminatorConfig(
        msd=JD.MultiScaleConfig(scales=3,
                                discriminator=SMALL_MSD.discriminator),
        mpd=JD.MultiPeriodConfig(
            discriminator=JD.PeriodDiscriminatorConfig(
                channels=4, max_downsample_channels=16))),
}


def _case(name, seed):
    cfg = BATCHED[name]
    univ = name.startswith("univnet")
    init = (D.univnet_discriminator_init if univ
            else D.hifigan_discriminator_init)
    params = init(torch.Generator().manual_seed(seed), _port_cfg(cfg))
    apply = (D.univnet_discriminator_apply if univ
             else D.hifigan_discriminator_apply)
    japply = (JD.univnet_discriminator_apply if univ
              else JD.hifigan_discriminator_apply)
    return cfg, params, apply, japply


def _loss(outs):
    """Every map's mean square, the logits' against 1."""
    total = 0.0
    for branch in outs:
        for o in branch[:-1]:
            total = total + (o * o).mean()
        total = total + ((branch[-1] - 1.0) ** 2).mean()
    return total


def _grads(params, apply, x, cfg, batched):
    paths = [p for p, _ in tree_leaves(params) if not p.endswith("/u")]
    leaves = dict(tree_leaves(params))
    for p in paths:
        leaves[p].requires_grad_(True)
    eff, _ = norms.resolve_params(params)
    outs = apply(eff, x, cfg, batched=batched)
    grads = torch.autograd.grad(_loss(outs), [leaves[p] for p in paths])
    return outs, dict(zip(paths, grads))


@pytest.mark.parametrize("name", sorted(BATCHED))
def test_batched_equals_sequential_and_jax(name):
    cfg, params, apply, japply = _case(name, 8)
    pcfg = _port_cfg(cfg)
    # 1001 samples: no period divides it, so every fold is reflect-padded
    x = (0.3 * np.random.default_rng(9).standard_normal((2, 1001, 1))
         ).astype(np.float32)
    seq, g_seq = _grads(params, apply, torch.from_numpy(x), pcfg, False)
    bat, g_bat = _grads(params, apply, torch.from_numpy(x), pcfg, True)
    assert len(bat) == len(seq)
    for branch_b, branch_s in zip(bat, seq):
        assert len(branch_b) == len(branch_s)
        for b, s in zip(branch_b, branch_s):
            _close(b, s)
    assert sorted(g_bat) == sorted(g_seq)
    for p in g_bat:
        _close(g_bat[p], g_seq[p])

    jparams = bridge.disc_params_to_jax(params)

    def jloss(p, v):
        eff, _ = jax_norms.resolve_params(p)
        outs = japply(eff, v, cfg, batched=True)
        return _loss(outs), outs

    (_, want), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jparams, jnp.asarray(x))
    for branch_b, branch_w in zip(bat, want):
        for b, w in zip(branch_b, branch_w):
            _close(b, _layout(w))
    _trees_close(bridge.disc_params_to_jax(_with(params, g_bat)), jgrad,
                 only=lambda path: not path.endswith("/u"))
