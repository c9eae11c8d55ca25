"""Model FLOPs of the codec, a frozen copy of the arithmetic of
audiodec_tpu_torch/utils/flops.py (`encoder_flops`, `projector_flops`,
`rvq_flops`, `decoder_flops`, `vocoder_flops`), on a configuration file's
plain dicts (`generator_params` and the reference's code defaults).

The FLOPs of the direct (unfolded) algorithm: a multiply-add is 2 FLOPs,
and only the conv and matmul terms count; biases, activations and
residual adds are under 1% and left out, as MFU accounting does.  The
encoder is split by block so that a cell can give each part the peak of
its operands' precision.
"""

from __future__ import annotations

import math


def conv1d(t_out: int, k: int, cin: int, cout: int) -> int:
    return 2 * k * cin * cout * t_out


def encoder_flops(gp: dict, df: dict, t: int) -> dict:
    """One batch row of t samples -> {"conv": input conv, "stack<i>": block
    i's residual units, "down<i>": block i's strided conv}."""
    ce = gp["encode_channels"]
    out = {"conv": conv1d(t, df["kernel_size"], gp["input_channels"], ce)}
    t_i, cin = t, ce
    for i, s in enumerate(gp["enc_strides"]):
        out[f"stack{i}"] = len(df["res_dilations"]) * (
            conv1d(t_i, df["res_kernel_size"], cin, cin)
            + conv1d(t_i, 1, cin, cin))
        t_i //= s
        cout = ce * gp["enc_ratios"][i]
        out[f"down{i}"] = conv1d(t_i, 2 * s, cin, cout)
        cin = cout
    return out


def projector_flops(gp: dict, n_frames: int) -> int:
    return conv1d(n_frames, 3, gp["encode_channels"] * gp["enc_ratios"][-1],
                  gp["code_dim"])


def rvq_flops(gp: dict, n_frames: int) -> int:
    """The distance cross terms, r @ E per codebook."""
    return (gp["codebook_num"] * 2 * n_frames * gp["code_dim"]
            * gp["codebook_size"])


def decoder_flops(gp: dict, df: dict, n_frames: int) -> int:
    cd, ratios = gp["decode_channels"], gp["dec_ratios"]
    total = conv1d(n_frames, df["kernel_size"], gp["code_dim"],
                   cd * ratios[0])
    n_i = n_frames
    for i, s in enumerate(gp["dec_strides"]):
        cin = cd * ratios[i]
        cout = cd * ratios[i + 1] if i + 1 < len(ratios) else cd
        total += conv1d(n_i, 2 * s, cin, cout)   # every input frame, 2s taps
        n_i *= s
        total += len(df["res_dilations"]) * (
            conv1d(n_i, df["res_kernel_size"], cout, cout)
            + conv1d(n_i, 1, cout, cout))
    return total + conv1d(n_i, df["kernel_size"], cd, gp["output_channels"])


def vocoder_flops(vp: dict, n_frames: int) -> int:
    """The causal HiFiGAN with MultiGroupConv1d blocks: `groups` dense
    c -> c resblocks per stage and the 1x1 fuse-out."""
    c = vp["channels"]
    total = conv1d(n_frames, vp["kernel_size"], vp["in_channels"], c)
    n_i, g = n_frames, vp["groups"]
    per_dilation = 2 if vp["use_additional_convs"] else 1
    for i, s in enumerate(vp["upsample_scales"]):
        cout = vp["channels"] // 2 ** (i + 1)
        total += conv1d(n_i, vp["upsample_kernel_sizes"][i], c, cout)
        n_i *= s
        c = cout
        k = vp["resblock_kernel_sizes"][0]
        total += (g * per_dilation * len(vp["resblock_dilations"][0])
                  * conv1d(n_i, k, c, c))
        total += conv1d(n_i, 1, g * c, c)
    return total + conv1d(n_i, vp["kernel_size"], c, vp["out_channels"])


def hop_length(gp: dict) -> int:
    return math.prod(gp["enc_strides"])
