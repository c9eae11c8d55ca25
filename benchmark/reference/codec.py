"""symAD and the causal HiFiGAN vocoder in plain float32 PyTorch, on a state
dict in the reference checkpoint's layout (benchmark/reference/layout.py).

Written from facebookresearch/AudioDec:
- layers/conv_layer.py: a causal conv pads (K - 1) * d zeros on the left;
  a causal transposed conv pads ceil(K / s) - 1 frames on the left by
  replication of the first, runs the full transposed conv and drops s
  outputs at each end;
- models/autoencoder/modules/{encoder,decoder,residual_unit,projector}.py:
  a residual unit is x + conv2(ELU(conv1(ELU(x)))), conv1 dilated with
  kernel 7, conv2 1x1, neither with a bias (an encoder's narrow stacks may
  be stated with bf16 operands, as the AudioDec TPU codec's folded stacks
  run them: each conv's input and weight rounded to bf16, summed in f32);
- layers/vq_module.py: each layer's code is the argmax of -(|r|^2 -
  2 r.E + |E|^2), the lowest index on a tie; the residual drops the code;
- models/vocoder/HiFiGAN.py and modules/multi_fusion.py: (c - mean) /
  scale, the input conv, then per stage LeakyReLU, the transposed conv and
  MultiGroupConv1d (the input repeated `groups` times, one grouped
  residual block, a 1x1 conv back), then LeakyReLU(0.01), the output conv
  and tanh.

Activations are (B, C, T).  Nothing here reads anything the program made;
weight norm is folded here, in float64.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

SD = Dict[str, torch.Tensor]


def fold_weight_norm(sd: SD) -> SD:
    """w = g * v / ||v||, the norm over every axis but the first."""
    out = {}
    for key, a in sd.items():
        if key.endswith(".weight_g"):
            base = key[: -len("_g")]
            v = sd[base + "_v"].double()
            norm = v.flatten(1).norm(dim=1).reshape((-1,) + (1,) * (v.dim()
                                                                   - 1))
            out[base] = (a.double() * v / norm).float()
        elif not key.endswith(".weight_v"):
            out[key] = a
    return out


def causal_conv(x, sd: SD, name: str, stride=1, dilation=1, groups=1):
    w = sd[name + ".weight"]
    pad = (w.shape[-1] - 1) * dilation
    return F.conv1d(F.pad(x, (pad, 0)), w, sd.get(name + ".bias"),
                    stride=stride, dilation=dilation, groups=groups)


def causal_conv_transpose(x, sd: SD, name: str, stride: int):
    w = sd[name + ".weight"]
    pad = math.ceil(w.shape[-1] / stride) - 1
    if pad:
        x = torch.cat([x[..., :1].expand(-1, -1, pad), x], dim=-1)
    y = F.conv_transpose1d(x, w, sd.get(name + ".bias"), stride=stride)
    return y[..., stride:-stride]


# ---------------------------------------------------------------------------
# symAD
# ---------------------------------------------------------------------------

def _bf16(t):
    return t.to(torch.bfloat16).float()


def _res_units(x, sd: SD, pre: str, dilations, act, round_dots=False):
    """round_dots: each conv's operands (input and weight) rounded to bf16,
    products summed in f32: the precision an encoder stack is stated in
    where it runs with bf16 operands."""
    rnd = _bf16 if round_dots else (lambda t: t)
    for j, d in enumerate(dilations):
        w1 = sd[f"{pre}.res_units.{j}.conv1.conv.weight"]
        a = F.pad(rnd(act(x)), ((w1.shape[-1] - 1) * d, 0))
        y = F.conv1d(a, rnd(w1), dilation=d)
        w2 = sd[f"{pre}.res_units.{j}.conv2.weight"]
        y = F.conv1d(rnd(act(y)), rnd(w2))
        x = x + y
    return x


def encode(x, sd: SD, gp: dict, defaults: dict, bf16_stacks_upto: int = 0):
    """x (B, 1, T) -> z (B, code_dim, T / hop): encoder and projector.
    bf16_stacks_upto: the residual stacks of at most this many channels
    take bf16 operands (0: none)."""
    dil, act = defaults["res_dilations"], F.elu
    x = causal_conv(x, sd, "encoder.conv.conv")
    for i, s in enumerate(gp["enc_strides"]):
        pre = f"encoder.conv_blocks.{i}"
        x = _res_units(x, sd, pre, dil, act,
                       round_dots=x.shape[1] <= bf16_stacks_upto)
        x = causal_conv(x, sd, f"{pre}.conv.conv", stride=s)
    return causal_conv(x, sd, "projector.project.conv")


def codebooks(sd: SD, gp: dict) -> torch.Tensor:
    """(Q, D, N): each layer's codes as columns, as the reference keeps
    them."""
    return torch.stack([sd[f"quantizer.codebook.layers.{q}.embed"]
                        for q in range(gp["codebook_num"])])


def rvq_encode(z, embed):
    """z (B, D, T') -> indices (B, T', Q) int64; embed (Q, D, N)."""
    r = z.transpose(1, 2).reshape(-1, z.shape[1])
    idx = []
    for e in embed:
        dist = (r.pow(2).sum(1, keepdim=True) - 2 * r @ e
                + e.pow(2).sum(0, keepdim=True))
        i = torch.argmax(-dist, dim=1)
        idx.append(i)
        r = r - e.t()[i]
    return torch.stack(idx, dim=1).reshape(z.shape[0], z.shape[2], -1)


def rvq_decode(idx, embed):
    """indices (B, T', Q) -> zq (B, D, T'): the sum of each layer's code."""
    zq = sum(embed[q].t()[idx[..., q]] for q in range(embed.shape[0]))
    return zq.transpose(1, 2)


def decode(zq, sd: SD, gp: dict, defaults: dict):
    """zq (B, code_dim, T') -> waveform (B, 1, T' * hop)."""
    dil, act = defaults["res_dilations"], F.elu
    x = causal_conv(zq, sd, "decoder.conv1.conv")
    for i, s in enumerate(gp["dec_strides"]):
        pre = f"decoder.conv_blocks.{i}"
        x = causal_conv_transpose(x, sd, f"{pre}.conv.deconv", s)
        x = _res_units(x, sd, pre, dil, act)
    return causal_conv(x, sd, "decoder.conv2.conv")


# ---------------------------------------------------------------------------
# the causal HiFiGAN vocoder (AD v1)
# ---------------------------------------------------------------------------

def vocode(zq, sd: SD, vp: dict, stats: Optional[bool] = None):
    """zq (B, in_channels, T') -> waveform (B, 1, T' * prod(scales)); sd
    with weight norm folded.  stats: normalize by `mean` / `scale`."""
    slope = vp["nonlinear_activation_params"]["negative_slope"]

    def act(v):
        return F.leaky_relu(v, slope)

    g = vp["groups"]
    dil = vp["resblock_dilations"][0]
    c = zq
    if stats if stats is not None else "mean" in sd:
        c = (c - sd["mean"][:, None]) / sd["scale"][:, None]
    c = causal_conv(c, sd, "input_conv.conv")
    for i, s in enumerate(vp["upsample_scales"]):
        c = causal_conv_transpose(act(c), sd, f"upsamples.{i}.deconv", s)
        x = c.repeat(1, g, 1)
        for j, d in enumerate(dil):
            xt = causal_conv(act(x), sd, f"blocks.{i}.convs1.{j}.conv",
                             dilation=d, groups=g)
            if vp["use_additional_convs"]:
                xt = causal_conv(act(xt), sd, f"blocks.{i}.convs2.{j}.conv",
                                 groups=g)
            x = xt + x
        c = F.conv1d(x, sd[f"blocks.{i}.conv_out.weight"])
    c = causal_conv(F.leaky_relu(c, 0.01), sd, "output_conv.conv")
    return torch.tanh(c)


# ---------------------------------------------------------------------------
# judging indices that another implementation chose
# ---------------------------------------------------------------------------

def code_gap(z, idx, embed) -> float:
    """The widest gap by which a chosen code lies farther from its residual
    than the reference's nearest code does, relative to the residual's
    squared norm, over every frame and layer, in float64; each layer's
    residual follows the chosen codes of the layers before it.  0 where
    every choice is a nearest code; a choice flipped at a near tie reads
    about the size of the rounding that flipped it.
    z (B, D, T') from the reference's encode, idx (B, T', Q) the chosen
    indices, embed (Q, D, N)."""
    r = z.transpose(1, 2).reshape(-1, z.shape[1]).double()
    idx = idx.reshape(-1, embed.shape[0]).long()
    worst = 0.0
    for q, e in enumerate(embed.double()):
        d = (r.pow(2).sum(1, keepdim=True) - 2 * r @ e
             + e.pow(2).sum(0, keepdim=True))
        chosen = d.gather(1, idx[:, q:q + 1]).squeeze(1)
        gap = (chosen - d.min(1).values) / r.pow(2).sum(1).clamp(min=1e-30)
        worst = max(worst, float(gap.max()))
        r = r - e.t()[idx[:, q]]
    return worst
