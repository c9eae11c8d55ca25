"""Causal HiFiGAN vocoder, batch inference (counterpart of
audiodec_tpu/models/vocoder.py).

The AD v0/v1/v2 receivers: RVQ codes -> optional input normalization
(c - mean) / scale -> input causal conv -> N x [LeakyReLU -> causal
transposed conv -> fusion block] -> default-slope LeakyReLU -> output
causal conv -> tanh.  The fusion block is MultiGroupConv1d (one grouped
resblock on `groups` copies of the input, then a 1x1 `conv_out`; v1, v2)
or MultiReceptiveField (the mean of resblocks with kernels 3/7/11; v0),
chosen as the reference does.

Params are nested dicts of tensors with the JAX tree's structure and
torch's weight orientation (see utils/bridge.py).  `vocoder_bct` works in
the package's (B, C, T) layout and takes the fusion-block function, so the
plain and the kernel paths (models/fast.py) share one structure; the public
functions take JAX's (B, T, C).

Streaming: `vocoder_stream_bct` and `vocoder_apply(..., state=)` return
(y, new_state); the state is a nested dict of (B, C, L) tensors with the
JAX state tree's structure (`vocoder_state_init`).  The grouped fusion
block streams as the JAX package does: the input tiled `groups` times and
one grouped conv per layer, so its state has channels * groups channels.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from audiodec_tpu_torch.ops.activations import get_activation
from audiodec_tpu_torch.ops.conv import (
    causal_conv1d,
    causal_conv_transpose1d,
    causal_state_init,
    causal_transpose_state_init,
    conv1d_init,
    conv_transpose1d_init,
)
from audiodec_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class VocoderConfig:
    """The JAX VocoderConfig's own copy (field names and defaults)."""
    in_channels: int = 80
    out_channels: int = 1
    channels: int = 512
    kernel_size: int = 7
    upsample_scales: Sequence[int] = (8, 8, 2, 2)
    upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4)
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    resblock_dilations: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5),
                                                  (1, 3, 5))
    groups: int = 1
    bias: bool = True
    use_additional_convs: bool = True
    nonlinear_activation: str = "LeakyReLU"
    nonlinear_activation_params: tuple = (("negative_slope", 0.1),)
    stats: bool = False   # whether params carry input-normalization stats

    @property
    def act(self):
        return get_activation(self.nonlinear_activation,
                              dict(self.nonlinear_activation_params))

    @property
    def grouped(self) -> bool:
        """MultiGroupConv1d vs MultiReceptiveField (ref: HiFiGAN.py:77-81)."""
        return (len(self.resblock_dilations) ==
                len(self.resblock_kernel_sizes) == 1) and self.groups > 1

    @property
    def hop_length(self) -> int:
        return math.prod(self.upsample_scales)

    def stage_channels(self, i: int) -> int:
        return self.channels // (2 ** (i + 1))


def config_from_yaml(d: dict, stats: bool = False) -> VocoderConfig:
    """A config's `generator_params` dict (already parsed) -> VocoderConfig."""
    fields = {f.name for f in dataclasses.fields(VocoderConfig)}
    out = {}
    for k, v in d.items():
        if k not in fields:
            continue
        if k == "nonlinear_activation_params":
            v = tuple(sorted(v.items()))
        elif k == "resblock_dilations":
            v = tuple(tuple(x) for x in v)
        elif isinstance(v, list):
            v = tuple(v)
        out[k] = v
    out["stats"] = stats
    return VocoderConfig(**out)


# ---------------------------------------------------------------------------
# residual block (ref: models/vocoder/modules/residual_block.py:23-106)
# ---------------------------------------------------------------------------

def _resblock_apply(p, x, *, dilations, groups, use_additional, act,
                    state=None):
    """x: (B, C, T); with `state`, (y, new state)."""
    if state is None:
        for j, d in enumerate(dilations):
            xt = causal_conv1d(act(x), p["convs1"][j], dilation=d,
                               groups=groups)
            if use_additional:
                xt = causal_conv1d(act(xt), p["convs2"][j], groups=groups)
            x = xt + x
        return x
    ns = {"convs1": [], "convs2": []}
    for j, d in enumerate(dilations):
        xt, s1 = causal_conv1d(act(x), p["convs1"][j], dilation=d,
                               groups=groups, state=state["convs1"][j])
        ns["convs1"].append(s1)
        if use_additional:
            xt, s2 = causal_conv1d(act(xt), p["convs2"][j], groups=groups,
                                   state=state["convs2"][j])
            ns["convs2"].append(s2)
        x = xt + x
    return x, ns


def _resblock_state(batch, channels, kernel_size, dilations, use_additional,
                    dtype, device):
    s = {"convs1": [], "convs2": []}
    for d in dilations:
        s["convs1"].append(causal_state_init(batch, channels, kernel_size, d,
                                             dtype, device))
        if use_additional:
            s["convs2"].append(causal_state_init(batch, channels,
                                                 kernel_size, 1, dtype,
                                                 device))
    return s


def slice_group(conv_p: dict, g: int, c: int) -> dict:
    """Group g of a grouped conv (torch (G*C, C, K) weight, (G*C,) bias) as
    a dense (C, C, K) conv: output channels g*C:(g+1)*C."""
    pg = {"w": conv_p["w"][g * c:(g + 1) * c]}
    if "b" in conv_p:
        pg["b"] = conv_p["b"][g * c:(g + 1) * c]
    return pg


def group_params(p: dict, g: int, c: int) -> dict:
    """Group g of a grouped resblock, as a dense resblock at width C."""
    return {"convs1": [slice_group(cp, g, c) for cp in p["convs1"]],
            "convs2": [slice_group(cp, g, c) for cp in p["convs2"]]}


# ---------------------------------------------------------------------------
# fusion blocks (ref: models/vocoder/modules/multi_fusion.py)
# ---------------------------------------------------------------------------

Resblock = Callable[..., torch.Tensor]


def fusion_bct(p, x, cfg: VocoderConfig, resblock: Resblock):
    """Fusion block on x (B, C, T), with `resblock(p_block, x, kernel_size,
    dilations, groups)` running each resblock.  MultiGroupConv1d runs its
    grouped resblock as `groups` dense resblocks on weight slices of the
    (untiled) input, as the JAX batch path does: the same math as the
    reference's channel repeat and grouped conv, since each input group is
    a copy of x.  MultiReceptiveField is the mean of its resblocks, under
    the spans `mrf` and `mrf_k<kernel size>` (utils/profiling.py)."""
    if cfg.grouped:
        c = x.shape[1]
        outs = [resblock(group_params(p, g, c), x,
                         cfg.resblock_kernel_sizes[0],
                         cfg.resblock_dilations[0], 1)
                for g in range(cfg.groups)]
        return causal_conv1d(torch.cat(outs, dim=1), p["conv_out"])
    n = len(cfg.resblock_kernel_sizes)
    cs = 0.0
    with span("mrf", x.device):
        for i, k in enumerate(cfg.resblock_kernel_sizes):
            with span(f"mrf_k{k}", x.device):
                cs = cs + resblock(p["blocks"][i], x, k,
                                   cfg.resblock_dilations[i], cfg.groups)
        return cs / n


def _fusion_apply(p, x, cfg: VocoderConfig):
    """Fusion block as plain convs.  x: (B, C, T)."""
    def resblock(p_block, x, _kernel_size, dilations, groups):
        return _resblock_apply(p_block, x, dilations=dilations, groups=groups,
                               use_additional=cfg.use_additional_convs,
                               act=cfg.act)

    return fusion_bct(p, x, cfg, resblock)


def _fusion_stream(p, x, cfg: VocoderConfig, state):
    """Fusion block in streaming mode, x: (B, C, T) -> (y, new state).  The
    grouped block tiles x `groups` times and runs the grouped convs (the
    JAX package's streaming form), not the batch form's weight slices."""
    act = cfg.act
    if cfg.grouped:
        xg = x.repeat(1, cfg.groups, 1)   # (B, G*C, T) channel repeat
        xg, ns = _resblock_apply(p, xg, dilations=cfg.resblock_dilations[0],
                                 groups=cfg.groups,
                                 use_additional=cfg.use_additional_convs,
                                 act=act, state=state)
        return causal_conv1d(xg, p["conv_out"]), ns
    n = len(cfg.resblock_kernel_sizes)
    cs, ns = 0.0, {"blocks": []}
    for i in range(n):
        y, s = _resblock_apply(
            p["blocks"][i], x, dilations=cfg.resblock_dilations[i],
            groups=cfg.groups, use_additional=cfg.use_additional_convs,
            act=act, state=state["blocks"][i])
        cs = cs + y
        ns["blocks"].append(s)
    return cs / n, ns


def _fusion_state(batch, cfg: VocoderConfig, channels, dtype, device):
    if cfg.grouped:
        return _resblock_state(batch, channels * cfg.groups,
                               cfg.resblock_kernel_sizes[0],
                               cfg.resblock_dilations[0],
                               cfg.use_additional_convs, dtype, device)
    return {"blocks": [
        _resblock_state(batch, channels, cfg.resblock_kernel_sizes[i],
                        cfg.resblock_dilations[i], cfg.use_additional_convs,
                        dtype, device)
        for i in range(len(cfg.resblock_kernel_sizes))]}


# ---------------------------------------------------------------------------
# generator
# ---------------------------------------------------------------------------

def _resblock_init(gen, channels, kernel_size, dilations, groups, bias,
                   use_additional):
    p = {"convs1": [], "convs2": []}
    for _ in dilations:
        p["convs1"].append(conv1d_init(gen, kernel_size, channels, channels,
                                       groups, bias))
        if use_additional:
            p["convs2"].append(conv1d_init(gen, kernel_size, channels,
                                           channels, groups, bias))
    return p


def _fusion_init(gen, cfg: VocoderConfig, channels):
    if cfg.grouped:
        p = _resblock_init(gen, channels * cfg.groups,
                           cfg.resblock_kernel_sizes[0],
                           cfg.resblock_dilations[0], cfg.groups, cfg.bias,
                           cfg.use_additional_convs)
        p["conv_out"] = conv1d_init(gen, 1, channels * cfg.groups, channels,
                                    bias=False)
        return p
    return {"blocks": [
        _resblock_init(gen, channels, cfg.resblock_kernel_sizes[i],
                       cfg.resblock_dilations[i], cfg.groups, cfg.bias,
                       cfg.use_additional_convs)
        for i in range(len(cfg.resblock_kernel_sizes))]}


def vocoder_init(cfg: VocoderConfig, generator: torch.Generator) -> dict:
    """Random params with the JAX `vocoder_init`'s structure and scales
    (normal weights at scale 0.01, zero biases, mean 0 and scale 1 with
    `stats`), drawn from `generator` on its device.  The numbers differ
    from JAX's: the two frameworks' generators differ."""
    gen, dev = generator, generator.device
    n_up = len(cfg.upsample_scales)
    p = {
        "input_conv": conv1d_init(gen, cfg.kernel_size, cfg.in_channels,
                                  cfg.channels),
        "upsamples": [],
        "blocks": [],
        "output_conv": conv1d_init(gen, cfg.kernel_size,
                                   cfg.stage_channels(n_up - 1),
                                   cfg.out_channels),
    }
    for i in range(n_up):
        c_in = cfg.channels // (2 ** i)
        c_out = cfg.stage_channels(i)
        k = cfg.upsample_kernel_sizes[i]
        p["upsamples"].append(conv_transpose1d_init(gen, k, c_in, c_out))
        p["blocks"].append(_fusion_init(gen, cfg, c_out))
    if cfg.stats:
        p["mean"] = torch.zeros(cfg.in_channels, device=dev)
        p["scale"] = torch.ones(cfg.in_channels, device=dev)
    return p


Fusion = Callable[[dict, torch.Tensor, VocoderConfig], torch.Tensor]


def vocoder_bct(p, c, cfg: VocoderConfig, fusion: Fusion):
    """c: (B, in_channels, T) codes -> (B, out_channels, T * hop)."""
    act = cfg.act
    lrelu = get_activation("LeakyReLU")  # output act is default-slope
    if cfg.stats and "mean" in p:
        c = (c - p["mean"][:, None]) / p["scale"][:, None]
    c = causal_conv1d(c, p["input_conv"])
    for i, s in enumerate(cfg.upsample_scales):
        c = causal_conv_transpose1d(act(c), p["upsamples"][i], stride=s)
        c = fusion(p["blocks"][i], c, cfg)
    c = causal_conv1d(lrelu(c), p["output_conv"])
    return torch.tanh(c)


def vocoder_stream_bct(p, c, cfg: VocoderConfig, state):
    """One streaming step, c: (B, in_channels, k) codes ->
    ((B, out_channels, k * hop), new state)."""
    act = cfg.act
    lrelu = get_activation("LeakyReLU")  # output act is default-slope
    if cfg.stats and "mean" in p:
        c = (c - p["mean"][:, None]) / p["scale"][:, None]
    c, s_in = causal_conv1d(c, p["input_conv"], state=state["input_conv"])
    ups, blocks = [], []
    for i, s in enumerate(cfg.upsample_scales):
        c, su = causal_conv_transpose1d(act(c), p["upsamples"][i], stride=s,
                                        state=state["upsamples"][i])
        c, sb = _fusion_stream(p["blocks"][i], c, cfg, state["blocks"][i])
        ups.append(su)
        blocks.append(sb)
    c, s_out = causal_conv1d(lrelu(c), p["output_conv"],
                             state=state["output_conv"])
    return torch.tanh(c), {"input_conv": s_in, "upsamples": ups,
                           "blocks": blocks, "output_conv": s_out}


def vocoder_state_init(batch: int, cfg: VocoderConfig, dtype=torch.float32,
                       device=None) -> dict:
    n_up = len(cfg.upsample_scales)
    state = {"input_conv": causal_state_init(batch, cfg.in_channels,
                                             cfg.kernel_size, 1, dtype,
                                             device),
             "upsamples": [], "blocks": [],
             "output_conv": causal_state_init(
                 batch, cfg.stage_channels(n_up - 1), cfg.kernel_size, 1,
                 dtype, device)}
    for i in range(n_up):
        state["upsamples"].append(causal_transpose_state_init(
            batch, cfg.channels // (2 ** i), cfg.upsample_kernel_sizes[i],
            cfg.upsample_scales[i], dtype, device))
        state["blocks"].append(_fusion_state(batch, cfg,
                                             cfg.stage_channels(i), dtype,
                                             device))
    return state


def vocoder_apply(p, c, cfg: VocoderConfig, state=None):
    """c: (B, T, in_channels) codes -> (B, T * hop, out_channels); with
    `state`, (y, new state)."""
    if state is None:
        return vocoder_bct(p, c.transpose(1, 2), cfg,
                           _fusion_apply).transpose(1, 2)
    y, ns = vocoder_stream_bct(p, c.transpose(1, 2), cfg, state)
    return y.transpose(1, 2), ns
