"""The port's discriminators (`models/discriminators.py`), norms
(`ops/norms.py`) and their weight bridge against the reference goldens and
the JAX package.

Tolerances: every feature map within the JAX golden tests' rtol 1e-3 /
atol 1e-4 of the reference's; against JAX on the same weights, every
feature map, resolved weight and advanced spectral-norm `u` within a
relative 1e-5 of the largest entry, gradients within 1e-4.
"""

import os

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

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _golden(name):
    data = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    sd = {k[len("sd__"):]: data[k] for k in data.files
          if k.startswith("sd__")}
    return data, sd


def _check_golden(outs, data):
    assert len(outs) == int(data["n_branches"])
    for i, branch in enumerate(outs):
        assert len(branch) == int(data[f"n_layers_{i}"])
        for j, t in enumerate(branch):
            np.testing.assert_allclose(t.detach().numpy(),
                                       data[f"out_{i}_{j}"], rtol=1e-3,
                                       atol=1e-4,
                                       err_msg=f"branch {i} layer {j}")


@pytest.mark.parametrize("fold", [True, False])
def test_hifigan_discriminator_golden(fold):
    """disc_hifigan (tests/test_discriminators.py's config); fold=False keeps
    the MPD's weight norm as training does and resolves it."""
    data, sd = _golden("disc_hifigan")
    cfg = D.HiFiGANDiscriminatorConfig(
        msd=D.MultiScaleConfig(follow_official_norm=False,
                               discriminator=D.ScaleDiscriminatorConfig(
                                   channels=16, max_downsample_channels=64)),
        mpd=D.MultiPeriodConfig(discriminator=D.PeriodDiscriminatorConfig(
            channels=8, max_downsample_channels=64)))
    params = bridge.hifigan_disc_params_from_reference_sd(sd, cfg, fold=fold)
    assert ("v" in params["mpd"]["discriminators"][0]["layers"][0]) != fold
    eff, _ = norms.resolve_params(params)
    x = torch.from_numpy(data["x"].transpose(0, 2, 1).copy())
    _check_golden(D.hifigan_discriminator_apply(eff, x, cfg), data)


def test_univnet_mrsd_golden():
    data, sd = _golden("disc_univnet")
    cfg = D.MultiResolutionSpectralConfig(
        discriminator=D.SpectralDiscriminatorConfig(channels=16))
    params = bridge.mrsd_params_from_reference_sd(sd, cfg)
    x = torch.from_numpy(data["x"].transpose(0, 2, 1).copy())
    _check_golden(D.mrsd_apply(params, x, cfg), data)


SMALL_MSD = JD.MultiScaleConfig(
    scales=2, discriminator=JD.ScaleDiscriminatorConfig(
        channels=16, max_downsample_channels=32, max_groups=4))


def _mpd(spectral):
    return JD.MultiPeriodConfig(periods=(2, 3, 5),
                                discriminator=JD.PeriodDiscriminatorConfig(
                                    channels=4, max_downsample_channels=16,
                                    use_spectral_norm=spectral))


CASES = {
    "hifigan_weight_norm": JD.HiFiGANDiscriminatorConfig(msd=SMALL_MSD,
                                                         mpd=_mpd(False)),
    "hifigan_spectral_norm": JD.HiFiGANDiscriminatorConfig(msd=SMALL_MSD,
                                                           mpd=_mpd(True)),
    "univnet": JD.UnivNetDiscriminatorConfig(
        mrsd=JD.MultiResolutionSpectralConfig(
            fft_sizes=(256, 128), hop_sizes=(64, 30), win_lengths=(200, 128),
            discriminator=JD.SpectralDiscriminatorConfig(channels=4)),
        mpd=_mpd(False)),
    "univnet_flat_channel": JD.UnivNetDiscriminatorConfig(
        mrsd=JD.MultiResolutionSpectralConfig(
            fft_sizes=(256,), hop_sizes=(64,), win_lengths=(256,),
            discriminator=JD.SpectralDiscriminatorConfig(channels=4)),
        mpd=_mpd(True), flat_channel=True),
}


def _port_cfg(cfg):
    """The JAX dataclass config rebuilt from the port's classes."""
    import dataclasses

    def conv(v):
        if dataclasses.is_dataclass(v):
            cls = getattr(D, type(v).__name__)
            return cls(**{f.name: conv(getattr(v, f.name))
                          for f in dataclasses.fields(v)})
        return v
    return conv(cfg)


def _jax_case(name, seed):
    """(JAX config, the port's seeded init as a JAX tree, JAX's apply, the
    port's apply)."""
    cfg = CASES[name]
    univ = name.startswith("univnet")
    init = (D.univnet_discriminator_init if univ
            else D.hifigan_discriminator_init)
    params = bridge.disc_params_to_jax(
        init(torch.Generator().manual_seed(seed), _port_cfg(cfg)))
    apply = (JD.univnet_discriminator_apply if univ
             else JD.hifigan_discriminator_apply)
    port_apply = (D.univnet_discriminator_apply if univ
                  else D.hifigan_discriminator_apply)
    return cfg, params, apply, port_apply


def _np(t):
    return np.asarray(t.detach() if torch.is_tensor(t) else t, np.float64)


def _close(got, want, rtol=1e-5):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _trees_close(ours, theirs, rtol=1e-5, only=lambda path: True) -> int:
    """Leaf by leaf, by path (JAX's tree_map sorts dict keys) -> the number
    of leaves compared."""
    a = dict(tree_leaves(ours))
    b = dict(tree_leaves(jax.tree_util.tree_map(np.asarray, theirs)))
    assert sorted(a) == sorted(b)
    paths = [p for p in a if only(p)]
    for p in paths:
        _close(a[p], b[p], rtol=rtol)
    return len(paths)


def _layout(t):
    """A JAX feature map in the port's layout: (B, T, C) -> (B, C, T),
    (B, H, W, C) -> (B, C, H, W)."""
    a = np.asarray(t)
    if a.ndim == 3:
        return a.transpose(0, 2, 1)
    if a.ndim == 4:
        return a.transpose(0, 3, 1, 2)
    return a


@pytest.mark.parametrize("name", sorted(CASES))
def test_discriminator_matches_jax(name):
    """Every feature map on JAX's weights carried across, and the tree
    resolve_params returns: weights resolved, spectral norm's `u`
    advanced one power iteration."""
    cfg, jparams, japply, port_apply = _jax_case(name, 3)
    channels = 2 if name.endswith("flat_channel") else 1
    x = (0.3 * np.random.default_rng(4).standard_normal(
        (2, 1000, channels))).astype(np.float32)

    @jax.jit
    def jax_side(p, v):
        eff, upd = jax_norms.resolve_params(p)
        return eff, upd, japply(eff, v, cfg)

    jeff, jupd, want = jax_side(jparams, jnp.asarray(x))
    params = bridge.disc_params_from_jax(jparams)
    eff, upd = norms.resolve_params(params)
    got = port_apply(eff, torch.from_numpy(x), _port_cfg(cfg))
    assert len(got) == len(want)
    for branch_g, branch_w in zip(got, want):
        assert len(branch_g) == len(branch_w)
        for g, w in zip(branch_g, branch_w):
            _close(g, _layout(w))
    _trees_close(bridge.disc_params_to_jax(eff), jeff, rtol=2e-5)
    n_u = _trees_close(bridge.disc_params_to_jax(upd), jupd,
                       only=lambda path: path.endswith("/u"))
    assert (n_u > 0) == ("spectral" in name or "flat" in name)


@pytest.mark.parametrize("name", ["hifigan_spectral_norm", "univnet"])
def test_discriminator_loss_gradient_matches_jax(name):
    """d(mean (logits - 1)^2) / d params through the norms, against
    jax.grad: the path the train step's discriminator update takes."""
    cfg, jparams, japply, port_apply = _jax_case(name, 5)
    x = (0.3 * np.random.default_rng(6).standard_normal(
        (1, 900, 1))).astype(np.float32)

    def jloss(p):
        eff, _ = jax_norms.resolve_params(p)
        return sum(jnp.mean(jnp.square(o[-1] - 1.0))
                   for o in japply(eff, jnp.asarray(x), cfg))

    jgrad = jax.jit(jax.grad(jloss))(jparams)
    params = bridge.disc_params_from_jax(jparams)
    leaves = [t.requires_grad_(True) for p, t in tree_leaves(params)
              if not p.endswith("/u")]
    eff, _ = norms.resolve_params(params)
    loss = sum(torch.mean(torch.square(o[-1] - 1.0))
               for o in port_apply(eff, torch.from_numpy(x), _port_cfg(cfg)))
    grads = dict(zip([p for p, _ in tree_leaves(params)
                      if not p.endswith("/u")],
                     torch.autograd.grad(loss, leaves)))
    _trees_close(bridge.disc_params_to_jax(_with(params, grads)), jgrad,
                 rtol=1e-4, only=lambda path: not path.endswith("/u"))


def _with(tree, values, prefix=""):
    """tree with the leaves at the paths of `values` replaced."""
    if isinstance(tree, dict):
        return {k: _with(v, values, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_with(v, values, f"{prefix}/{i}") for i, v in enumerate(tree)]
    return values.get(prefix, torch.zeros_like(tree))


@pytest.mark.parametrize("name", sorted(CASES))
def test_init_and_bridge_keep_jax_tree(name):
    """The port's seeded init has JAX's tree, shapes and norm
    reparametrizations (the MSD plain, as the reference's; JAX's by
    eval_shape); the bridge is a round trip."""
    cfg = CASES[name]
    univ = name.startswith("univnet")
    jinit = (JD.univnet_discriminator_init if univ
             else JD.hifigan_discriminator_init)
    init = (D.univnet_discriminator_init if univ
            else D.hifigan_discriminator_init)
    theirs = dict(tree_leaves(jax.eval_shape(
        lambda k: jinit(k, cfg), jax.random.PRNGKey(0))))
    tree = bridge.disc_params_to_jax(
        init(torch.Generator().manual_seed(7), _port_cfg(cfg)))
    ours = dict(tree_leaves(tree))
    assert sorted(ours) == sorted(theirs)
    assert all(ours[p].shape == theirs[p].shape for p in ours)
    back = dict(tree_leaves(bridge.disc_params_to_jax(
        bridge.disc_params_from_jax(tree))))
    for p in ours:
        np.testing.assert_array_equal(back[p], ours[p])


def test_weight_norm_tree_matches_jax():
    """apply_weight_norm_tree on a generator tree (transposed convs
    included: in torch's orientation the preserved axis is always 0) gives
    JAX's {v, g} with its transposed-conv axis rule, and resolves back."""
    from audiodec_tpu_torch.models.autoencoder import (
        GeneratorConfig,
        generator_init,
    )

    cfg = GeneratorConfig(encode_channels=4, decode_channels=4, code_dim=16,
                          codebook_num=2, codebook_size=8)
    jgen = bridge.params_to_jax(generator_init(
        cfg, torch.Generator().manual_seed(1)))
    tp = tuple(f"decoder/blocks/{i}/conv"
               for i in range(len(cfg.dec_strides)))
    want = jax.jit(lambda t: jax_norms.apply_weight_norm_tree(
        t, transposed_paths=tp))(jgen)
    port = norms.apply_weight_norm_tree(bridge.params_from_jax(jgen))
    _trees_close(bridge.params_to_jax(port), want, rtol=1e-6)
    eff, _ = norms.resolve_params(port)
    _trees_close(bridge.params_to_jax(eff), jgen, rtol=1e-6)


def test_spectral_norm_reaches_unit_sigma():
    rng = torch.Generator().manual_seed(1)
    from audiodec_tpu_torch.ops.conv import conv1d_init

    p = norms.spectral_norm_params(rng, conv1d_init(rng, 15, 3, 16))
    for _ in range(50):
        eff, p = norms.resolve_params(p)
    sigma = np.linalg.svd(eff["w"].reshape(16, -1).numpy(),
                          compute_uv=False)[0]
    np.testing.assert_allclose(sigma, 1.0, rtol=1e-3)
