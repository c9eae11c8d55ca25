"""GAN discriminators: HiFiGAN's MSD + MPD and UnivNet's MRSD + MPD
(counterpart of audiodec_tpu/models/discriminators.py; ref
models/vocoder/modules/discriminator.py, HiFiGAN.py:308-395,
UnivNet.py:23-103).

The applies take JAX's (B, T, C) waveform and return the reference's nested
output: a list (one entry per sub-discriminator) of lists of every layer's
feature map, the logits last, in torch's layouts: (B, C, T) for the scale
discriminators, (B, C, T / P, P) for the period ones (their logits
flattened to (B, n)), (B, C, frames, bins) for the spectral ones.  Feature
matching reads every map.

Params are trees of plain convs in torch's orientation (utils/bridge.py
carries them to and from the JAX tree).  The period and spectral
discriminators are weight-normed (or, with use_spectral_norm, spectral-
normed) as in the reference; ops/norms.py `resolve_params` resolves them
before an apply.  The scale discriminators stay plain: the reference's norm
walk tests isinstance(m, nn.Conv2d) on Conv1d stacks and never applies,
follow_official_norm included (ref discriminator.py:355-373).

The batched variants (`msd_apply_batched`, `mpd_apply_batched`, the
combined applies' `batched=True`) run every layer of all the branches (the
scales, the periods) as one grouped conv, the branches' weights stacked on
the output axis and their inputs zero padded to the largest branch; a mask
zeroes each branch's padded rows after every layer, and the maps come out
sliced to the sequential applies' shapes, so outputs and gradients equal
theirs to f32 reassociation.  They are the JAX package's TPU layout
experiment; codec_train does not call them.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F

from audiodec_tpu_torch.ops.activations import get_activation
from audiodec_tpu_torch.ops.conv import conv1d_init, conv2d_init
from audiodec_tpu_torch.ops.norms import (
    spectral_norm_params,
    weight_norm_params,
)
from audiodec_tpu_torch.ops.spectral import stft_magnitude

_INIT_SCALE = 0.1  # the JAX package's discriminator init scale


# ---------------------------------------------------------------------------
# scale discriminator (ref: discriminator.py:213-373)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ScaleDiscriminatorConfig:
    in_channels: int = 1
    out_channels: int = 1
    kernel_sizes: Sequence[int] = (15, 41, 5, 3)
    channels: int = 128
    max_downsample_channels: int = 1024
    max_groups: int = 16
    bias: bool = True
    downsample_scales: Sequence[int] = (2, 2, 4, 4, 1)
    nonlinear_activation: str = "LeakyReLU"
    nonlinear_activation_params: tuple = (("negative_slope", 0.1),)

    def layer_shapes(self):
        """[(k, in, out, stride, groups)] of every layer."""
        ks = self.kernel_sizes
        layers = [(ks[0], self.in_channels, self.channels, 1, 1)]
        in_chs, out_chs, groups = self.channels, self.channels, 4
        for ds in self.downsample_scales:
            layers.append((ks[1], in_chs, out_chs, ds, groups))
            in_chs = out_chs
            out_chs = min(in_chs * 2, self.max_downsample_channels)
            groups = min(groups * 4, self.max_groups)
        out_chs = min(in_chs * 2, self.max_downsample_channels)
        layers.append((ks[2], in_chs, out_chs, 1, 1))
        layers.append((ks[3], out_chs, self.out_channels, 1, 1))
        return layers


def scale_discriminator_init(gen: torch.Generator,
                             cfg: ScaleDiscriminatorConfig) -> dict:
    """Plain conv params (see the module docstring)."""
    return {"layers": [conv1d_init(gen, k, ci, co, groups=g, bias=cfg.bias,
                                   scale=_INIT_SCALE)
                       for k, ci, co, _, g in cfg.layer_shapes()]}


def scale_discriminator_bct(p, x, cfg: ScaleDiscriminatorConfig):
    """x: (B, C, T) -> every layer's output (logits last)."""
    act = get_activation(cfg.nonlinear_activation,
                         dict(cfg.nonlinear_activation_params))
    outs = []
    shapes = cfg.layer_shapes()
    for i, (k, _, _, stride, groups) in enumerate(shapes):
        lp = p["layers"][i]
        x = F.conv1d(x, lp["w"], lp.get("b"), stride=stride,
                     padding=(k - 1) // 2, groups=groups)
        if i < len(shapes) - 1:
            x = act(x)
        outs.append(x)
    return outs


@dataclasses.dataclass(frozen=True)
class MultiScaleConfig:
    scales: int = 3
    follow_official_norm: bool = True
    pool_kernel: int = 4
    pool_stride: int = 2
    pool_padding: int = 2
    discriminator: ScaleDiscriminatorConfig = ScaleDiscriminatorConfig()


def msd_init(gen: torch.Generator, cfg: MultiScaleConfig) -> dict:
    return {"discriminators": [scale_discriminator_init(gen,
                                                        cfg.discriminator)
                               for _ in range(cfg.scales)]}


def msd_bct(p, x, cfg: MultiScaleConfig):
    """x: (B, C, T); AvgPool1d (count_include_pad) between the scales."""
    outs = []
    for i in range(cfg.scales):
        outs.append(scale_discriminator_bct(p["discriminators"][i], x,
                                            cfg.discriminator))
        x = F.avg_pool1d(x, cfg.pool_kernel, cfg.pool_stride,
                         cfg.pool_padding)
    return outs


# ---------------------------------------------------------------------------
# period discriminator (ref: discriminator.py:27-210)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PeriodDiscriminatorConfig:
    in_channels: int = 1
    out_channels: int = 1
    kernel_sizes: Sequence[int] = (5, 3)
    channels: int = 32
    downsample_scales: Sequence[int] = (3, 3, 3, 3, 1)
    max_downsample_channels: int = 1024
    bias: bool = True
    nonlinear_activation: str = "LeakyReLU"
    nonlinear_activation_params: tuple = (("negative_slope", 0.1),)
    use_spectral_norm: bool = False

    def layer_shapes(self):
        layers = []
        in_chs, out_chs = self.in_channels, self.channels
        for ds in self.downsample_scales:
            layers.append((self.kernel_sizes[0], in_chs, out_chs, ds))
            in_chs = out_chs
            out_chs = min(out_chs * 4, self.max_downsample_channels)
        return layers


def period_discriminator_init(gen: torch.Generator,
                              cfg: PeriodDiscriminatorConfig) -> dict:
    def normed(p):
        return (spectral_norm_params(gen, p) if cfg.use_spectral_norm
                else weight_norm_params(p))

    shapes = cfg.layer_shapes()
    layers = [normed(conv2d_init(gen, (k, 1), ci, co, bias=cfg.bias,
                                 scale=_INIT_SCALE))
              for k, ci, co, _ in shapes]
    # the output conv's kernel is (k2 - 1, 1), as the reference's
    out_k = max(cfg.kernel_sizes[1] - 1, 1)
    po = normed(conv2d_init(gen, (out_k, 1), shapes[-1][2],
                            cfg.out_channels, bias=cfg.bias,
                            scale=_INIT_SCALE))
    return {"layers": layers, "output_conv": po}


def period_discriminator_bct(p, x, cfg: PeriodDiscriminatorConfig,
                             period: int):
    """x: (B, C, T) -> every layer's output; the logits flattened last."""
    act = get_activation(cfg.nonlinear_activation,
                         dict(cfg.nonlinear_activation_params))
    b, c, t = x.shape
    if t % period != 0:
        x = F.pad(x, (0, period - t % period), mode="reflect")
        t = x.shape[-1]
    x = x.reshape(b, c, t // period, period)
    outs = []
    for i, (k, _, _, ds) in enumerate(cfg.layer_shapes()):
        lp = p["layers"][i]
        x = act(F.conv2d(x, lp["w"], lp.get("b"), stride=(ds, 1),
                         padding=((k - 1) // 2, 0)))
        outs.append(x)
    po = p["output_conv"]
    x = F.conv2d(x, po["w"], po.get("b"),
                 padding=((cfg.kernel_sizes[1] - 1) // 2, 0))
    outs.append(x.reshape(b, -1))
    return outs


@dataclasses.dataclass(frozen=True)
class MultiPeriodConfig:
    periods: Sequence[int] = (2, 3, 5, 7, 11)
    discriminator: PeriodDiscriminatorConfig = PeriodDiscriminatorConfig()


def mpd_init(gen: torch.Generator, cfg: MultiPeriodConfig) -> dict:
    return {"discriminators": [period_discriminator_init(gen,
                                                         cfg.discriminator)
                               for _ in cfg.periods]}


def mpd_bct(p, x, cfg: MultiPeriodConfig):
    return [period_discriminator_bct(p["discriminators"][i], x,
                                     cfg.discriminator, period)
            for i, period in enumerate(cfg.periods)]


# ---------------------------------------------------------------------------
# batched MSD / MPD: one grouped conv per layer across the branches
# ---------------------------------------------------------------------------

def _stacked_conv(convs: list) -> dict:
    """The branches' convs {"w"[, "b"]} as one conv with their weights
    stacked on the output axis (groups = branches x the convs' groups)."""
    out = {"w": torch.cat([c["w"] for c in convs])}
    if "b" in convs[0]:
        out["b"] = torch.cat([c["b"] for c in convs])
    return out


def _masked(y, lengths):
    """Zero every branch's rows past its valid length.  y: (B, N * C, L,
    ...) with branch j in channels [j * C, (j + 1) * C) -> the same."""
    n = len(lengths)
    keep = torch.arange(y.shape[2], device=y.device)[None, :] < torch.tensor(
        lengths, device=y.device)[:, None]                   # (N, L)
    shape = (1, n, 1, y.shape[2]) + (1,) * (y.ndim - 3)
    mask = keep.reshape(shape).to(y.dtype)
    return (y.reshape((y.shape[0], n, -1) + y.shape[2:]) * mask).reshape(
        y.shape)


def _branch(y, j: int, n: int):
    """Branch j's channels of a stacked map (B, N * C, ...)."""
    c = y.shape[1] // n
    return y[:, j * c:(j + 1) * c]


def msd_apply_batched(p, x, cfg: MultiScaleConfig):
    """msd_bct's outputs, the scale discriminators run as one grouped conv
    per layer.  x: (B, C, T)."""
    dcfg = cfg.discriminator
    act = get_activation(dcfg.nonlinear_activation,
                         dict(dcfg.nonlinear_activation_params))
    xs = [x]
    for _ in range(cfg.scales - 1):
        xs.append(F.avg_pool1d(xs[-1], cfg.pool_kernel, cfg.pool_stride,
                               cfg.pool_padding))
    lens = [xi.shape[-1] for xi in xs]
    y = torch.cat([F.pad(xi, (0, lens[0] - xi.shape[-1])) for xi in xs], 1)
    shapes = dcfg.layer_shapes()
    n = cfg.scales
    outs = []
    for i, (k, _, _, stride, groups) in enumerate(shapes):
        lp = _stacked_conv([d["layers"][i] for d in p["discriminators"]])
        pad = (k - 1) // 2
        y = F.conv1d(y, lp["w"], lp.get("b"), stride=stride, padding=pad,
                     groups=n * groups)
        if i < len(shapes) - 1:
            y = act(y)
        lens = [(t + 2 * pad - k) // stride + 1 for t in lens]
        y = _masked(y, lens)
        outs.append((y, lens))
    return [[_branch(y, j, n)[..., :ls[j]] for y, ls in outs]
            for j in range(n)]


def mpd_apply_batched(p, x, cfg: MultiPeriodConfig):
    """mpd_bct's outputs, the period discriminators run as one grouped
    conv per layer over their folds, zero padded to the tallest fold and
    the longest period.  x: (B, C, T)."""
    dcfg = cfg.discriminator
    act = get_activation(dcfg.nonlinear_activation,
                         dict(dcfg.nonlinear_activation_params))
    periods = tuple(cfg.periods)
    n = len(periods)
    b, c, t = x.shape
    folds = []
    for per in periods:
        xp = x if t % per == 0 else F.pad(x, (0, per - t % per),
                                          mode="reflect")
        folds.append(xp.reshape(b, c, -1, per))
    hs = [f.shape[2] for f in folds]
    hmax, pmax = max(hs), max(periods)
    y = torch.cat([F.pad(f, (0, pmax - f.shape[3], 0, hmax - f.shape[2]))
                   for f in folds], 1)
    outs = []
    for i, (k, _, _, ds) in enumerate(dcfg.layer_shapes()):
        lp = _stacked_conv([d["layers"][i] for d in p["discriminators"]])
        pad = (k - 1) // 2
        y = act(F.conv2d(y, lp["w"], lp.get("b"), stride=(ds, 1),
                         padding=(pad, 0), groups=n))
        hs = [(h + 2 * pad - k) // ds + 1 for h in hs]
        y = _masked(y, hs)
        outs.append((y, hs))
    po = _stacked_conv([d["output_conv"] for d in p["discriminators"]])
    pad = (dcfg.kernel_sizes[1] - 1) // 2
    y = F.conv2d(y, po["w"], po.get("b"), padding=(pad, 0), groups=n)
    h_out = [h + 2 * pad - po["w"].shape[2] + 1 for h in hs]
    return [[_branch(m, j, n)[:, :, :ls[j], :per] for m, ls in outs]
            + [_branch(y, j, n)[:, :, :h_out[j], :per].reshape(b, -1)]
            for j, per in enumerate(periods)]


# ---------------------------------------------------------------------------
# UnivNet spectral discriminator (ref: discriminator.py:451-640)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SpectralDiscriminatorConfig:
    fft_size: int = 1024
    hop_size: int = 120
    win_length: int = 600
    kernel_sizes: Sequence[Sequence[int]] = ((3, 9), (3, 9), (3, 9), (3, 9),
                                             (3, 3), (3, 3))
    strides: Sequence[Sequence[int]] = ((1, 1), (1, 2), (1, 2), (1, 2),
                                        (1, 1), (1, 1))
    channels: int = 32
    bias: bool = True
    nonlinear_activation: str = "LeakyReLU"
    nonlinear_activation_params: tuple = (("negative_slope", 0.2),)

    def layer_shapes(self):
        n = len(self.kernel_sizes)
        layers = [(tuple(self.kernel_sizes[0]), 1, self.channels,
                   tuple(self.strides[0]))]
        for i in range(1, n - 1):
            layers.append((tuple(self.kernel_sizes[i]), self.channels,
                           self.channels, tuple(self.strides[i])))
        layers.append((tuple(self.kernel_sizes[-1]), self.channels, 1,
                       tuple(self.strides[-1])))
        return layers


def spectral_discriminator_init(gen: torch.Generator,
                                cfg: SpectralDiscriminatorConfig) -> dict:
    return {"layers": [
        weight_norm_params(conv2d_init(gen, k, ci, co, bias=cfg.bias,
                                       scale=_INIT_SCALE))
        for k, ci, co, _ in cfg.layer_shapes()]}


def spectral_discriminator_apply(p, x, cfg: SpectralDiscriminatorConfig):
    """x: (B, T, 1) waveform -> every layer's output over the magnitude
    spectrogram (torchaudio.spectrogram(power=1, pad=win // 2)), each
    (B, C, frames, bins)."""
    act = get_activation(cfg.nonlinear_activation,
                         dict(cfg.nonlinear_activation_params))
    # eps > 0 keeps sqrt differentiable on the all-zero padded edge frames
    h = stft_magnitude(x[:, :, 0], cfg.fft_size, cfg.hop_size,
                       cfg.win_length, pad=cfg.win_length // 2,
                       eps=1e-12)[:, None]
    outs = []
    shapes = cfg.layer_shapes()
    for i, (k, _, _, st) in enumerate(shapes):
        lp = p["layers"][i]
        h = F.conv2d(h, lp["w"], lp.get("b"), stride=st,
                     padding=((k[0] - 1) // 2, (k[1] - 1) // 2))
        if i < len(shapes) - 1:
            h = act(h)
        outs.append(h)
    return outs


@dataclasses.dataclass(frozen=True)
class MultiResolutionSpectralConfig:
    fft_sizes: Sequence[int] = (1024, 2048, 512)
    hop_sizes: Sequence[int] = (120, 240, 50)
    win_lengths: Sequence[int] = (600, 1200, 240)
    discriminator: SpectralDiscriminatorConfig = SpectralDiscriminatorConfig()

    def resolution_cfgs(self):
        return [dataclasses.replace(self.discriminator, fft_size=f,
                                    hop_size=h, win_length=w)
                for f, h, w in zip(self.fft_sizes, self.hop_sizes,
                                   self.win_lengths)]


def mrsd_init(gen: torch.Generator, cfg: MultiResolutionSpectralConfig):
    return {"discriminators": [spectral_discriminator_init(gen, rc)
                               for rc in cfg.resolution_cfgs()]}


def mrsd_apply(p, x, cfg: MultiResolutionSpectralConfig):
    """x: (B, T, 1)."""
    return [spectral_discriminator_apply(p["discriminators"][i], x, rc)
            for i, rc in enumerate(cfg.resolution_cfgs())]


# ---------------------------------------------------------------------------
# combined discriminators (ref: HiFiGAN.py:308-395, UnivNet.py:23-103)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HiFiGANDiscriminatorConfig:
    msd: MultiScaleConfig = MultiScaleConfig()
    mpd: MultiPeriodConfig = MultiPeriodConfig()


def hifigan_discriminator_init(gen: torch.Generator,
                               cfg: HiFiGANDiscriminatorConfig) -> dict:
    return {"msd": msd_init(gen, cfg.msd), "mpd": mpd_init(gen, cfg.mpd)}


def _mono_fold(x):
    """(B, T, C) -> (B * C, T, 1) (ref: HiFiGAN.py:390-392)."""
    b, t, c = x.shape
    if c != 1:
        x = torch.movedim(x, 2, 1).reshape(b * c, t, 1)
    return x


def hifigan_discriminator_apply(p, x, cfg: HiFiGANDiscriminatorConfig,
                                batched: bool = False):
    """x: (B, T, C) -> the MSD's outputs, then the MPD's; batched runs
    the stacked variants."""
    x = _mono_fold(x).transpose(1, 2)
    if batched:
        return (msd_apply_batched(p["msd"], x, cfg.msd)
                + mpd_apply_batched(p["mpd"], x, cfg.mpd))
    return msd_bct(p["msd"], x, cfg.msd) + mpd_bct(p["mpd"], x, cfg.mpd)


@dataclasses.dataclass(frozen=True)
class UnivNetDiscriminatorConfig:
    mrsd: MultiResolutionSpectralConfig = MultiResolutionSpectralConfig()
    mpd: MultiPeriodConfig = MultiPeriodConfig()
    flat_channel: bool = False


def univnet_discriminator_init(gen: torch.Generator,
                               cfg: UnivNetDiscriminatorConfig) -> dict:
    return {"mrsd": mrsd_init(gen, cfg.mrsd), "mpd": mpd_init(gen, cfg.mpd)}


def univnet_discriminator_apply(p, x, cfg: UnivNetDiscriminatorConfig,
                                batched: bool = False):
    """x: (B, T, C) -> the MRSD's outputs, then the MPD's (batched: the
    stacked MPD).  Multi-channel input is folded only with flat_channel
    (ref: UnivNet.py:98-100)."""
    if cfg.flat_channel:
        x = _mono_fold(x)
    mpd = mpd_apply_batched if batched else mpd_bct
    return (mrsd_apply(p["mrsd"], x, cfg.mrsd)
            + mpd(p["mpd"], x.transpose(1, 2), cfg.mpd))
