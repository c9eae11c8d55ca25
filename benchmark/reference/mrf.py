"""The AD v0 receiver's vocoder in plain float32 PyTorch: the causal HiFiGAN
with MultiReceptiveField fusion blocks, on a state dict in the reference
checkpoint's layout.

Written from facebookresearch/AudioDec:
- models/vocoder/HiFiGAN.py: (c - mean) / scale, the input conv, then per
  upsampling stage LeakyReLU, the causal transposed conv and the fusion
  block; then LeakyReLU(0.01), the output conv and tanh;
- models/vocoder/modules/multi_fusion.py MultiReceptiveField: one
  HiFiGANResidualBlock per `resblock_kernel_sizes` entry, each on the same
  input at the stage's full width (groups 1), their outputs summed and
  divided by their number;
- models/vocoder/modules/residual_block.py: per dilation d, x + conv2(
  LeakyReLU(conv1(LeakyReLU(x)))), conv1 of kernel k dilated by d, conv2 of
  kernel k undilated, both causal (K - 1) * d zeros on the left) with a
  bias; every conv weight-normed (`weight_g`, `weight_v`).

The keys are the reference's: `input_conv.conv`, `upsamples.<i>.deconv`,
`blocks.<i>.blocks.<b>.convs1.<j>.conv` and `.convs2.<j>.conv`,
`output_conv.conv`, `mean`, `scale`.

Departures from the published description: none in the arithmetic.  The
statistics file is not public, so the seeded state carries mean 0 and
scale 1 (the configuration's `assumed`); weight norm is folded here, in
float64, before the float32 convs, which run with TF32 off.  Nothing here
reads anything the program made.
"""

from __future__ import annotations

import contextlib
from typing import List

import torch
import torch.nn.functional as F

from benchmark.reference import codec as R
from benchmark.reference.layout import Row, _wn_conv, _wn_convt

fold_weight_norm = R.fold_weight_norm


@contextlib.contextmanager
def tf32_off():
    """TF32 off for float32 convs and matmuls, restored on exit."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def mrf_layout(vp: dict) -> List[Row]:
    """The causal HiFiGAN vocoder with MultiReceptiveField blocks (one
    resblock per kernel size, groups 1) and its input statistics."""
    if vp["groups"] != 1 or len(vp["resblock_kernel_sizes"]) != len(
            vp["resblock_dilations"]):
        raise ValueError("a MultiReceptiveField vocoder has groups 1 and "
                         "one dilation list per resblock kernel size")
    rows: List[Row] = []
    c, k = vp["channels"], vp["kernel_size"]
    convs = (("convs1", "convs2") if vp["use_additional_convs"]
             else ("convs1",))
    _wn_conv(rows, "input_conv.conv", c, vp["in_channels"], k, vp["bias"],
             "conv")
    for i, s in enumerate(vp["upsample_scales"]):
        cin, cout = c // 2 ** i, c // 2 ** (i + 1)
        _wn_convt(rows, f"upsamples.{i}.deconv", cin, cout,
                  vp["upsample_kernel_sizes"][i], s, "conv")
        for b, (rk, dil) in enumerate(zip(vp["resblock_kernel_sizes"],
                                          vp["resblock_dilations"])):
            for name in convs:
                for j in range(len(dil)):
                    _wn_conv(rows, f"blocks.{i}.blocks.{b}.{name}.{j}.conv",
                             cout, cout, rk, vp["bias"], "res")
    n_up = len(vp["upsample_scales"])
    _wn_conv(rows, "output_conv.conv", vp["out_channels"], c // 2 ** n_up, k,
             vp["bias"], "output")
    rows.append(Row("mean", (vp["in_channels"],), "mean", 0, "stats"))
    rows.append(Row("scale", (vp["in_channels"],), "scale", 0, "stats"))
    return rows


def resblock(x, sd: R.SD, pre: str, dilations, act, additional: bool):
    """One HiFiGANResidualBlock on x (B, C, T)."""
    for j, d in enumerate(dilations):
        xt = R.causal_conv(act(x), sd, f"{pre}.convs1.{j}.conv", dilation=d)
        if additional:
            xt = R.causal_conv(act(xt), sd, f"{pre}.convs2.{j}.conv")
        x = xt + x
    return x


def vocode_mrf(zq, sd: R.SD, vp: dict):
    """zq (B, in_channels, T') -> waveform (B, 1, T' * prod(scales)); sd
    with weight norm folded (`fold_weight_norm`), its `mean` and `scale`
    applied where it has them."""
    slope = vp["nonlinear_activation_params"]["negative_slope"]

    def act(v):
        return F.leaky_relu(v, slope)

    n = len(vp["resblock_kernel_sizes"])
    with tf32_off():
        c = zq
        if "mean" in sd:
            c = (c - sd["mean"][:, None]) / sd["scale"][:, None]
        c = R.causal_conv(c, sd, "input_conv.conv")
        for i, s in enumerate(vp["upsample_scales"]):
            c = R.causal_conv_transpose(act(c), sd, f"upsamples.{i}.deconv",
                                        s)
            cs = 0.0
            for b, dil in enumerate(vp["resblock_dilations"]):
                cs = cs + resblock(c, sd, f"blocks.{i}.blocks.{b}", dil, act,
                                   vp["use_additional_convs"])
            c = cs / n
        c = R.causal_conv(F.leaky_relu(c, 0.01), sd, "output_conv.conv")
        return torch.tanh(c)
