"""The reference checkpoint's state-dict layout, from a configuration file:
every key with its shape and its role in the seeded draw
(benchmark/harness/weights.py).

The keys are those of facebookresearch/AudioDec's modules:
`models/autoencoder/AudioDec.py` (symAD: `encoder.*`, `projector.*`,
`quantizer.codebook.layers.<q>.*`, `decoder.*`, every conv plain) and
`models/vocoder/HiFiGAN.py` (the causal HiFiGAN with MultiGroupConv1d
blocks, every conv weight-normed: `weight_g`, `weight_v`).

A row is (key, shape, role, fan_in): role is one of
  "w"      a plain conv weight, drawn N(0, 1) * gain / sqrt(fan_in)
  "v", "g" a weight-normed conv's direction and per-channel norm (gain)
  "b"      a bias
  "embed", "cluster_size", "embed_avg"  a codebook and its EMA statistics
  "mean", "scale"  the vocoder's input statistics
and `gain` is the row's entry in the configuration's `init` table (by the
layer's name there, `group`).
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple


class Row(NamedTuple):
    key: str
    shape: Tuple[int, ...]
    role: str
    fan_in: int
    group: str


def _conv(rows, name, cout, cin, k, bias, group, groups=1):
    rows.append(Row(name + ".weight", (cout, cin // groups, k), "w",
                    cin // groups * k, group))
    if bias:
        rows.append(Row(name + ".bias", (cout,), "b", 0, group))


def _wn_conv(rows, name, cout, cin, k, bias, group, groups=1):
    rows.append(Row(name + ".weight_g", (cout, 1, 1), "g", 0, group))
    rows.append(Row(name + ".weight_v", (cout, cin // groups, k), "v",
                    cin // groups * k, group))
    if bias:
        rows.append(Row(name + ".bias", (cout,), "b", 0, group))


def _wn_convt(rows, name, cin, cout, k, stride, group):
    # torch weight norm on ConvTranspose1d, dim 0: the input channels; each
    # output sample sums cin * k / stride taps
    rows.append(Row(name + ".weight_g", (cin, 1, 1), "g",
                    cin * k // stride, group))
    rows.append(Row(name + ".weight_v", (cin, cout, k), "v",
                    cin * k // stride, group))
    rows.append(Row(name + ".bias", (cout,), "b", 0, group))


def symad_layout(gp: dict, defaults: dict) -> List[Row]:
    """symAD's generator (encoder, projector, RVQ, decoder)."""
    k, rk = defaults["kernel_size"], defaults["res_kernel_size"]
    dil = defaults["res_dilations"]
    rows: List[Row] = []
    ce, cd, d = gp["encode_channels"], gp["decode_channels"], gp["code_dim"]
    _conv(rows, "encoder.conv.conv", ce, gp["input_channels"], k, False,
          "conv")
    cin = ce
    for i, s in enumerate(gp["enc_strides"]):
        pre = f"encoder.conv_blocks.{i}"
        for j in range(len(dil)):
            _conv(rows, f"{pre}.res_units.{j}.conv1.conv", cin, cin, rk,
                  False, "res")
            _conv(rows, f"{pre}.res_units.{j}.conv2", cin, cin, 1, False,
                  "res")
        cout = ce * gp["enc_ratios"][i]
        _conv(rows, f"{pre}.conv.conv", cout, cin, 2 * s, gp["bias"], "conv")
        cin = cout
    _conv(rows, "projector.project.conv", d, cin, 3, False, "projector")
    for q in range(gp["codebook_num"]):
        pre = f"quantizer.codebook.layers.{q}"
        n = gp["codebook_size"]
        rows.append(Row(f"{pre}.embed", (d, n), "embed", q, "codebook"))
        rows.append(Row(f"{pre}.cluster_size", (n,), "cluster_size", 0,
                        "codebook"))
        rows.append(Row(f"{pre}.embed_avg", (d, n), "embed_avg", q,
                        "codebook"))
    ratios = gp["dec_ratios"]
    _conv(rows, "decoder.conv1.conv", cd * ratios[0], d, k, False, "conv")
    for i, s in enumerate(gp["dec_strides"]):
        pre = f"decoder.conv_blocks.{i}"
        cin = cd * ratios[i]
        cout = cd * ratios[i + 1] if i + 1 < len(ratios) else cd
        rows.append(Row(f"{pre}.conv.deconv.weight", (cin, cout, 2 * s), "w",
                        cin * 2, "conv"))
        if gp["bias"]:
            rows.append(Row(f"{pre}.conv.deconv.bias", (cout,), "b", 0,
                            "conv"))
        for j in range(len(dil)):
            _conv(rows, f"{pre}.res_units.{j}.conv1.conv", cout, cout, rk,
                  False, "res")
            _conv(rows, f"{pre}.res_units.{j}.conv2", cout, cout, 1, False,
                  "res")
    _conv(rows, "decoder.conv2.conv", gp["output_channels"], cd, k, False,
          "output")
    return rows


def vocoder_layout(vp: dict) -> List[Row]:
    """The causal HiFiGAN vocoder with MultiGroupConv1d fusion blocks (one
    resblock kernel size, `groups` > 1) and its input statistics."""
    if len(vp["resblock_kernel_sizes"]) != 1 or vp["groups"] <= 1:
        raise NotImplementedError("only the MultiGroupConv1d vocoder (AD "
                                  "v1/v2) has a reference here")
    rows: List[Row] = []
    c, k, g = vp["channels"], vp["kernel_size"], vp["groups"]
    rk = vp["resblock_kernel_sizes"][0]
    _wn_conv(rows, "input_conv.conv", c, vp["in_channels"], k, vp["bias"],
             "conv")
    for i, s in enumerate(vp["upsample_scales"]):
        cin, cout = c // 2 ** i, c // 2 ** (i + 1)
        _wn_convt(rows, f"upsamples.{i}.deconv", cin, cout,
                  vp["upsample_kernel_sizes"][i], s, "conv")
        for name in ("convs1", "convs2") if vp["use_additional_convs"] \
                else ("convs1",):
            for j in range(len(vp["resblock_dilations"][0])):
                _wn_conv(rows, f"blocks.{i}.{name}.{j}.conv", g * cout,
                         g * cout, rk, vp["bias"], "res", groups=g)
        _wn_conv(rows, f"blocks.{i}.conv_out", cout, g * cout, 1, False,
                 "conv")
    n_up = len(vp["upsample_scales"])
    _wn_conv(rows, "output_conv.conv", vp["out_channels"], c // 2 ** n_up, k,
             vp["bias"], "output")
    rows.append(Row("mean", (vp["in_channels"],), "mean", 0, "stats"))
    rows.append(Row("scale", (vp["in_channels"],), "scale", 0, "stats"))
    return rows
