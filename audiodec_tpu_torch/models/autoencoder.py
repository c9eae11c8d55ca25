"""AudioDec autoencoder (symAD), batch inference (counterpart of
audiodec_tpu/models/autoencoder.py).

Causal mode and codec="audiodec" only; streaming state, the noncausal and
"activate_audiodec" variants and training wait for later slices.  The
initializers (`encoder_init`, `projector_init`, `decoder_init`,
`generator_init`) draw from an explicit `torch.Generator` with the JAX
package's shapes and scales; they do not give JAX's numbers.  Params are
nested dicts of tensors with the JAX tree's structure and torch's weight
orientation (see utils/bridge.py).  The `_bct` functions work in the
package's (B, C, T) layout and take the residual-stack function, so the
plain and the kernel paths share one structure; the public functions take
JAX's (B, T, C).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import torch

from audiodec_tpu_torch.ops.activations import get_activation
from audiodec_tpu_torch.ops.conv import (
    causal_conv1d,
    causal_conv_transpose1d,
    conv1d_init,
    conv_transpose1d_init,
)
from audiodec_tpu_torch.ops.vq import rvq_forward_index, rvq_init, rvq_lookup

_BN_EPS = 1e-5  # torch.nn.BatchNorm1d default


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    """symAD_vctk_48000_hop300 by default (the JAX GeneratorConfig's own
    copy; ref config/autoencoder/symAD_vctk_48000_hop300.yaml:28-44)."""
    input_channels: int = 1
    output_channels: int = 1
    encode_channels: int = 32
    decode_channels: int = 32
    code_dim: int = 64
    codebook_num: int = 8
    codebook_size: int = 1024
    bias: bool = True
    enc_ratios: Sequence[int] = (2, 4, 8, 16)
    dec_ratios: Sequence[int] = (16, 8, 4, 2)
    enc_strides: Sequence[int] = (3, 4, 5, 5)
    dec_strides: Sequence[int] = (5, 5, 4, 3)
    mode: str = "causal"
    codec: str = "audiodec"
    projector: str = "conv1d"
    quantizer: str = "residual_vq"
    nonlinear_activation: str = "ELU"
    nonlinear_activation_params: tuple = ()
    kernel_size: int = 7
    res_dilations: Sequence[int] = (1, 3, 9)
    res_kernel_size: int = 7

    @property
    def act(self):
        return get_activation(self.nonlinear_activation,
                              dict(self.nonlinear_activation_params))

    @property
    def hop_length(self) -> int:
        return math.prod(self.enc_strides)

    @property
    def enc_out_channels(self) -> int:
        return self.encode_channels * self.enc_ratios[-1]


def config_from_yaml(d: dict) -> GeneratorConfig:
    """A config's `generator_params` dict (already parsed) -> GeneratorConfig;
    the reference's `quantier` key (its typo) is read as `quantizer`, and
    keys the config has no field for are skipped."""
    aliases = {"quantier": "quantizer"}
    fields = {f.name for f in dataclasses.fields(GeneratorConfig)}
    out = {}
    for k, v in d.items():
        k = aliases.get(k, k)
        if k not in fields:
            continue
        if k == "nonlinear_activation_params":
            v = tuple(sorted(v.items()))
        elif isinstance(v, list):
            v = tuple(v)
        out[k] = v
    return GeneratorConfig(**out)


def _check_supported(cfg: GeneratorConfig):
    if cfg.mode != "causal" or cfg.codec != "audiodec":
        raise NotImplementedError(
            f"mode={cfg.mode}, codec={cfg.codec}: only the causal audiodec "
            f"codec is ported")


def _res_unit_init(gen, channels: int, kernel_size: int) -> dict:
    return {"conv1": conv1d_init(gen, kernel_size, channels, channels,
                                 bias=False),
            "conv2": conv1d_init(gen, 1, channels, channels, bias=False)}


def encoder_init(cfg: GeneratorConfig, gen: torch.Generator) -> dict:
    params = {"conv": conv1d_init(gen, cfg.kernel_size, cfg.input_channels,
                                  cfg.encode_channels, bias=False),
              "blocks": []}
    in_ch = cfg.encode_channels
    for i, stride in enumerate(cfg.enc_strides):
        out_ch = cfg.encode_channels * cfg.enc_ratios[i]
        params["blocks"].append({
            "res": [_res_unit_init(gen, in_ch, cfg.res_kernel_size)
                    for _ in cfg.res_dilations],
            "conv": conv1d_init(gen, 2 * stride, in_ch, out_ch,
                                bias=cfg.bias),
        })
        in_ch = out_ch
    return params


def projector_init(cfg: GeneratorConfig, gen: torch.Generator) -> dict:
    if cfg.projector not in ("conv1d", "conv1d_bn"):
        raise NotImplementedError(
            f"Projector ({cfg.projector}) is not supported!")
    p = {"conv": conv1d_init(gen, 3, cfg.enc_out_channels, cfg.code_dim,
                             bias=False)}
    if cfg.projector == "conv1d_bn":
        d, dev = cfg.code_dim, gen.device
        p["bn"] = {"scale": torch.ones(d, device=dev),
                   "bias": torch.zeros(d, device=dev),
                   "mean": torch.zeros(d, device=dev),
                   "var": torch.ones(d, device=dev),
                   "count": torch.zeros((), device=dev)}
    return p


def decoder_init(cfg: GeneratorConfig, gen: torch.Generator) -> dict:
    ch0 = cfg.decode_channels * cfg.dec_ratios[0]
    params = {"conv1": conv1d_init(gen, cfg.kernel_size, cfg.code_dim, ch0,
                                   bias=False),
              "blocks": []}
    out_ch = ch0
    for i, stride in enumerate(cfg.dec_strides):
        in_ch = cfg.decode_channels * cfg.dec_ratios[i]
        out_ch = (cfg.decode_channels * cfg.dec_ratios[i + 1]
                  if i < len(cfg.dec_ratios) - 1 else cfg.decode_channels)
        params["blocks"].append({
            "conv": conv_transpose1d_init(gen, 2 * stride, in_ch, out_ch,
                                          bias=cfg.bias),
            "res": [_res_unit_init(gen, out_ch, cfg.res_kernel_size)
                    for _ in cfg.res_dilations],
        })
    params["conv2"] = conv1d_init(gen, cfg.kernel_size, out_ch,
                                  cfg.output_channels, bias=False)
    return params


def generator_init(cfg: GeneratorConfig, gen: torch.Generator) -> dict:
    """Random generator params with the JAX `generator_init`'s tree,
    shapes and scales (normal convs at 0.01, zero biases, normal codebooks),
    in torch's orientation, drawn from `gen` on its device."""
    return {"encoder": encoder_init(cfg, gen),
            "projector": projector_init(cfg, gen),
            "quantizer": rvq_init(gen, cfg.codebook_num, cfg.codebook_size,
                                  cfg.code_dim),
            "decoder": decoder_init(cfg, gen)}


def _res_unit_apply(p, x, *, dilation, act):
    y = causal_conv1d(act(x), p["conv1"], dilation=dilation)
    y = causal_conv1d(act(y), p["conv2"])
    return x + y


def res_stack_plain(x, block_params, cfg: GeneratorConfig):
    """The 3 residual units of a block as plain convs.  x: (B, C, T)."""
    act = cfg.act
    for j, d in enumerate(cfg.res_dilations):
        x = _res_unit_apply(block_params["res"][j], x, dilation=d, act=act)
    return x


ResStack = Callable[[torch.Tensor, dict, GeneratorConfig], torch.Tensor]


def encoder_bct(p, x, cfg: GeneratorConfig, res_stack: ResStack):
    _check_supported(cfg)
    x = causal_conv1d(x, p["conv"])
    for i, stride in enumerate(cfg.enc_strides):
        bp = p["blocks"][i]
        x = res_stack(x, bp, cfg)
        x = causal_conv1d(x, bp["conv"], stride=stride)
    return x


def decoder_bct(p, z, cfg: GeneratorConfig, res_stack: ResStack):
    _check_supported(cfg)
    x = causal_conv1d(z, p["conv1"])
    for i, stride in enumerate(cfg.dec_strides):
        bp = p["blocks"][i]
        x = causal_conv_transpose1d(x, bp["conv"], stride=stride)
        x = res_stack(x, bp, cfg)
    return causal_conv1d(x, p["conv2"])


def projector_bct(p, x, cfg: GeneratorConfig):
    """conv1d projector, or conv1d_bn with eval-mode (running-stat) BN."""
    z = causal_conv1d(x, p["conv"])
    if cfg.projector == "conv1d_bn":
        bn = p["bn"]
        z = ((z - bn["mean"][:, None]) * torch.rsqrt(bn["var"][:, None]
                                                     + _BN_EPS)
             * bn["scale"][:, None] + bn["bias"][:, None])
    elif cfg.projector != "conv1d":
        raise NotImplementedError(f"Projector ({cfg.projector})")
    return z


def encoder_apply(p, x, cfg: GeneratorConfig):
    """x: (B, T, C_in) -> (B, T', C_enc)."""
    return encoder_bct(p, x.transpose(1, 2), cfg,
                       res_stack_plain).transpose(1, 2)


def projector_apply(p, x, cfg: GeneratorConfig):
    """x: (B, T', C_enc) -> z (B, T', D)."""
    return projector_bct(p, x.transpose(1, 2), cfg).transpose(1, 2)


def decoder_apply(p, z, cfg: GeneratorConfig):
    """z: (B, T', D) -> (B, T, C_out)."""
    return decoder_bct(p, z.transpose(1, 2), cfg,
                       res_stack_plain).transpose(1, 2)


def _channel_fold(x, input_channels: int):
    """(B, T, C) -> (B*C/ic, T, ic) MIMO fold (ref: AudioDec.py:113-115)."""
    b, t, c = x.shape
    if c == input_channels:
        return x
    # (B, T, G*ic) -> (B, G, T, ic) -> (B*G, T, ic), grouping consecutive chans
    g = c // input_channels
    x = x.reshape(b, t, g, input_channels)
    x = torch.movedim(x, 2, 1)
    return x.reshape(b * g, t, input_channels)


def generator_encode(params, x, cfg: GeneratorConfig):
    """Waveform (B, T, C) -> code indices (B*C/ic, T', Q)."""
    x = _channel_fold(x, cfg.input_channels)
    h = encoder_apply(params["encoder"], x, cfg)
    z = projector_apply(params["projector"], h, cfg)
    _, idx = rvq_forward_index(z, params["quantizer"])
    return idx


def generator_decode(params, idx, cfg: GeneratorConfig):
    """Code indices (B, T', Q) -> waveform (B, T, 1)."""
    zq = rvq_lookup(idx, params["quantizer"])
    return decoder_apply(params["decoder"], zq, cfg)
