"""The AD v0 receiver's vocoder (the causal HiFiGAN with MultiReceptiveField
blocks): its model FLOPs, a frozen copy of the non-grouped branch of
audiodec_tpu_torch/utils/flops.py `vocoder_flops`, and the least time of
the resblocks that the folded route sends to B1
(csrc/folded_stack_mma.cu), through bounds.py `mma_stack`.

FLOPs as flops.py counts them: a multiply-add is 2 FLOPs, convs only.  Each
stage's resblocks are dense C -> C stacks at the stage's full width, one
per kernel size, with no 1x1 fuse-out.
"""

from __future__ import annotations

from benchmark.arith import bounds
from benchmark.arith.flops import conv1d


def mrf_vocoder_flops(vp: dict, n_frames: int) -> dict:
    """One batch row of n_frames code frames -> {"input_conv", "up<i>",
    "mrf<i>" (stage i's resblocks), "output_conv"}."""
    c = vp["channels"]
    out = {"input_conv": conv1d(n_frames, vp["kernel_size"],
                                vp["in_channels"], c)}
    per_dilation = 2 if vp["use_additional_convs"] else 1
    n_i = n_frames
    for i, s in enumerate(vp["upsample_scales"]):
        cout = vp["channels"] // 2 ** (i + 1)
        out[f"up{i}"] = conv1d(n_i, vp["upsample_kernel_sizes"][i], c, cout)
        n_i *= s
        c = cout
        out[f"mrf{i}"] = sum(per_dilation * len(dil) * conv1d(n_i, k, c, c)
                             for k, dil in zip(vp["resblock_kernel_sizes"],
                                               vp["resblock_dilations"]))
    out["output_conv"] = conv1d(n_i, vp["kernel_size"], c,
                                vp["out_channels"])
    return out


def kernel_stages(vp: dict, n_frames: int, cmax: int):
    """[(stage, channels, samples)] of the stages whose resblocks the
    folded route sends to B1: at most `cmax` channels (the traffic mix's
    `kernel_stack_max_channels`)."""
    out, n_i = [], n_frames
    for i, s in enumerate(vp["upsample_scales"]):
        n_i *= s
        c = vp["channels"] // 2 ** (i + 1)
        if c <= cmax:
            out.append((i, c, n_i))
    return out


def mrf_stack_bound_s(vp: dict, b: int, c: int, t: int, k: int,
                      storage: int) -> float:
    """B1's least time for one resblock of kernel size k at (b, c, t):
    k = k2, the stage's dilations, biases as the configuration has them."""
    dil = vp["resblock_dilations"][vp["resblock_kernel_sizes"].index(k)]
    return bounds.mma_stack(b, t, c, k=k, k2=k, storage=storage,
                            bias=vp["bias"], units=len(dil))
