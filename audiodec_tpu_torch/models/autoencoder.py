"""AudioDec autoencoder (symAD), inference in batch and streaming mode
(counterpart of audiodec_tpu/models/autoencoder.py).

Causal and noncausal modes, codec "audiodec" and "activate_audiodec"
(an activation after the encoder and before each transposed conv and the
last conv of the decoder, which ends in tanh).  Training: `generator_forward`
(train mode's EMA codebook update, the projector's batch-stat BN) and
`merge_forward_buffers`, as the JAX package's train steps call them.  The
initializers (`encoder_init`, `projector_init`, `decoder_init`,
`generator_init`) draw from an explicit `torch.Generator` with the JAX
package's shapes and scales; they do not give JAX's numbers.  Params are
nested dicts of tensors with the JAX tree's structure and torch's weight
orientation (see utils/bridge.py).  The batch `_bct` functions work in
the package's (B, C, T) layout and take the residual-stack function, so the
plain and the kernel paths share one structure; the public functions take
JAX's (B, T, C).

Streaming (causal mode only): the `_stream_bct` functions and the public
functions given `state=` return (y, new_state).  A state is a nested dict
of (B, C, L) tensors with the JAX state tree's structure (`*_state_init`);
a residual unit's 1x1 conv keeps none.  Streaming applies eval-mode BN in
the conv1d_bn projector, as the JAX package defines it (the reference's
own streaming path for that variant does not run).
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
    causal_state_init,
    causal_transpose_state_init,
    conv1d_init,
    conv_transpose1d_init,
    noncausal_conv1d,
    noncausal_conv_transpose1d,
)
from audiodec_tpu_torch.ops.vq import (
    rvq_forward,
    rvq_forward_index,
    rvq_init,
    rvq_lookup,
)

_BN_EPS = 1e-5       # torch.nn.BatchNorm1d defaults
_BN_MOMENTUM = 0.1


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

    @property
    def receptive_field(self) -> int:
        """Encoder-side receptive field in samples, projector included
        (7209 for symAD hop 300, ref utils/audiodec.py:24)."""
        rf = 1 + (3 - 1) * self.hop_length   # projector, k = 3
        rate = self.hop_length
        for stride in reversed(self.enc_strides):
            rate //= stride
            rf += (2 * stride - 1) * rate    # the strided conv, k = 2s
            for d in reversed(tuple(self.res_dilations)):
                rf += (self.res_kernel_size - 1) * d * rate
        return rf + self.kernel_size - 1     # input conv at sample rate


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
        in_ch, out_ch = _decoder_channels(cfg, i)
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


def _res_unit_apply(p, x, *, dilation, act, mode="causal", state=None):
    """x + conv2(act(conv1(act(x)))); with `state` (causal mode), also the
    unit's new state (conv1's: the 1x1 conv keeps none)."""
    if mode != "causal":
        y = noncausal_conv1d(act(x), p["conv1"], dilation=dilation)
        return x + noncausal_conv1d(act(y), p["conv2"])
    if state is None:
        y = causal_conv1d(act(x), p["conv1"], dilation=dilation)
        return x + causal_conv1d(act(y), p["conv2"])
    y, s1 = causal_conv1d(act(x), p["conv1"], dilation=dilation,
                          state=state["conv1"])
    return x + causal_conv1d(act(y), p["conv2"]), {"conv1": s1}


def _res_unit_state(batch, channels, kernel_size, dilation, dtype, device):
    return {"conv1": causal_state_init(batch, channels, kernel_size,
                                       dilation, dtype, device)}


def res_stack_plain(x, block_params, cfg: GeneratorConfig):
    """The residual units of a block as plain convs.  x: (B, C, T)."""
    act = cfg.act
    for j, d in enumerate(cfg.res_dilations):
        x = _res_unit_apply(block_params["res"][j], x, dilation=d, act=act,
                            mode=cfg.mode)
    return x


def _res_stack_stream(x, block_params, block_state, cfg: GeneratorConfig):
    """The residual units of a block in streaming mode -> (x, states)."""
    act, states = cfg.act, []
    for j, d in enumerate(cfg.res_dilations):
        x, s = _res_unit_apply(block_params["res"][j], x, dilation=d,
                               act=act, state=block_state["res"][j])
        states.append(s)
    return x, states


def _conv_of(cfg: GeneratorConfig):
    return causal_conv1d if cfg.mode == "causal" else noncausal_conv1d


def _require_causal(cfg: GeneratorConfig):
    if cfg.mode != "causal":
        raise ValueError(f"streaming needs mode='causal', got {cfg.mode!r} "
                         f"(as in the JAX package)")


ResStack = Callable[[torch.Tensor, dict, GeneratorConfig], torch.Tensor]


def encoder_bct(p, x, cfg: GeneratorConfig, res_stack: ResStack):
    """Batch encoder, x: (B, C_in, T) -> (B, C_enc, T / hop)."""
    conv = _conv_of(cfg)
    x = conv(x, p["conv"])
    for i, stride in enumerate(cfg.enc_strides):
        bp = p["blocks"][i]
        x = res_stack(x, bp, cfg)
        x = conv(x, bp["conv"], stride=stride)
    return cfg.act(x) if cfg.codec == "activate_audiodec" else x


def encoder_stream_bct(p, x, cfg: GeneratorConfig, state):
    """One streaming step of the encoder, x: (B, C_in, k * hop) ->
    ((B, C_enc, k), new state)."""
    _require_causal(cfg)
    x, s_conv = causal_conv1d(x, p["conv"], state=state["conv"])
    blocks = []
    for i, stride in enumerate(cfg.enc_strides):
        bp, bs = p["blocks"][i], state["blocks"][i]
        x, res = _res_stack_stream(x, bp, bs, cfg)
        x, sc = causal_conv1d(x, bp["conv"], stride=stride, state=bs["conv"])
        blocks.append({"res": res, "conv": sc})
    if cfg.codec == "activate_audiodec":
        x = cfg.act(x)
    return x, {"conv": s_conv, "blocks": blocks}


def encoder_state_init(batch: int, cfg: GeneratorConfig,
                       dtype=torch.float32, device=None) -> dict:
    state = {"conv": causal_state_init(batch, cfg.input_channels,
                                       cfg.kernel_size, 1, dtype, device),
             "blocks": []}
    in_ch = cfg.encode_channels
    for i, stride in enumerate(cfg.enc_strides):
        state["blocks"].append({
            "res": [_res_unit_state(batch, in_ch, cfg.res_kernel_size, d,
                                    dtype, device)
                    for d in cfg.res_dilations],
            "conv": causal_state_init(batch, in_ch, 2 * stride, 1, dtype,
                                      device)})
        in_ch = cfg.encode_channels * cfg.enc_ratios[i]
    return state


def decoder_bct(p, z, cfg: GeneratorConfig, res_stack: ResStack):
    """Batch decoder, z: (B, D, T') -> (B, C_out, T' * hop)."""
    causal = cfg.mode == "causal"
    conv = _conv_of(cfg)
    convt = (causal_conv_transpose1d if causal
             else noncausal_conv_transpose1d)
    activate = cfg.codec == "activate_audiodec"
    x = conv(z, p["conv1"])
    for i, stride in enumerate(cfg.dec_strides):
        bp = p["blocks"][i]
        if activate:
            x = cfg.act(x)
        x = convt(x, bp["conv"], stride=stride)
        x = res_stack(x, bp, cfg)
    if activate:
        return torch.tanh(conv(cfg.act(x), p["conv2"]))
    return conv(x, p["conv2"])


def decoder_stream_bct(p, z, cfg: GeneratorConfig, state):
    """One streaming step of the decoder, z: (B, D, k) ->
    ((B, C_out, k * hop), new state)."""
    _require_causal(cfg)
    activate = cfg.codec == "activate_audiodec"
    x, s1 = causal_conv1d(z, p["conv1"], state=state["conv1"])
    blocks = []
    for i, stride in enumerate(cfg.dec_strides):
        bp, bs = p["blocks"][i], state["blocks"][i]
        if activate:
            x = cfg.act(x)
        x, sc = causal_conv_transpose1d(x, bp["conv"], stride=stride,
                                        state=bs["conv"])
        x, res = _res_stack_stream(x, bp, bs, cfg)
        blocks.append({"conv": sc, "res": res})
    if activate:
        x = cfg.act(x)
    x, s2 = causal_conv1d(x, p["conv2"], state=state["conv2"])
    y = torch.tanh(x) if activate else x
    return y, {"conv1": s1, "blocks": blocks, "conv2": s2}


def _decoder_channels(cfg: GeneratorConfig, i: int):
    """(in, out) channels of decoder block i."""
    in_ch = cfg.decode_channels * cfg.dec_ratios[i]
    out_ch = (cfg.decode_channels * cfg.dec_ratios[i + 1]
              if i < len(cfg.dec_ratios) - 1 else cfg.decode_channels)
    return in_ch, out_ch


def decoder_state_init(batch: int, cfg: GeneratorConfig,
                       dtype=torch.float32, device=None) -> dict:
    state = {"conv1": causal_state_init(batch, cfg.code_dim, cfg.kernel_size,
                                        1, dtype, device),
             "blocks": []}
    out_ch = cfg.decode_channels
    for i, stride in enumerate(cfg.dec_strides):
        in_ch, out_ch = _decoder_channels(cfg, i)
        state["blocks"].append({
            "conv": causal_transpose_state_init(batch, in_ch, 2 * stride,
                                                stride, dtype, device),
            "res": [_res_unit_state(batch, out_ch, cfg.res_kernel_size, d,
                                    dtype, device)
                    for d in cfg.res_dilations]})
    state["conv2"] = causal_state_init(batch, out_ch, cfg.kernel_size, 1,
                                       dtype, device)
    return state


def _bn_eval(bn, z):
    """Eval-mode (running-stat) BN of z (B, D, T)."""
    return ((z - bn["mean"][:, None]) * torch.rsqrt(bn["var"][:, None]
                                                    + _BN_EPS)
            * bn["scale"][:, None] + bn["bias"][:, None])


def _bn_train(bn, z):
    """Train-mode BN of z (B, D, T): batch statistics, and the running
    statistics advanced as torch's BatchNorm1d does (unbiased variance,
    momentum 0.1, count + 1) -> (zn, new running stats, no gradient)."""
    n = z.shape[0] * z.shape[2]
    mean_b = torch.mean(z, dim=(0, 2))
    var_b = torch.mean(torch.square(z - mean_b[:, None]), dim=(0, 2))
    zn = ((z - mean_b[:, None]) * torch.rsqrt(var_b[:, None] + _BN_EPS)
          * bn["scale"][:, None] + bn["bias"][:, None])
    m = _BN_MOMENTUM
    with torch.no_grad():
        new = {"mean": (1 - m) * bn["mean"] + m * mean_b,
               "var": (1 - m) * bn["var"] + m * var_b * (n / max(n - 1, 1)),
               "count": bn["count"] + 1}
    return zn, new


def _check_projector(cfg: GeneratorConfig):
    if cfg.projector not in ("conv1d", "conv1d_bn"):
        raise NotImplementedError(f"Projector ({cfg.projector})")


def projector_bct(p, x, cfg: GeneratorConfig):
    """conv1d projector, or conv1d_bn with eval-mode (running-stat) BN."""
    _check_projector(cfg)
    z = _conv_of(cfg)(x, p["conv"])
    return _bn_eval(p["bn"], z) if cfg.projector == "conv1d_bn" else z


def projector_train_bct(p, x, cfg: GeneratorConfig):
    """The projector with train-mode BN -> (z, new BN running stats, or
    None for the plain conv1d projector)."""
    _check_projector(cfg)
    z = _conv_of(cfg)(x, p["conv"])
    if cfg.projector != "conv1d_bn":
        return z, None
    return _bn_train(p["bn"], z)


def projector_stream_bct(p, x, cfg: GeneratorConfig, state):
    """One streaming step of the projector -> (z, new state)."""
    _require_causal(cfg)
    _check_projector(cfg)
    z, s = causal_conv1d(x, p["conv"], state=state["conv"])
    if cfg.projector == "conv1d_bn":
        z = _bn_eval(p["bn"], z)
    return z, {"conv": s}


def projector_state_init(batch: int, cfg: GeneratorConfig,
                         dtype=torch.float32, device=None) -> dict:
    return {"conv": causal_state_init(batch, cfg.enc_out_channels, 3, 1,
                                      dtype, device)}


def _bct_apply(fn, x):
    """Run fn, a (B, C, T) function, on JAX's (B, T, C) layout; a streaming
    function's state passes through as it is."""
    out = fn(x.transpose(1, 2))
    if isinstance(out, tuple):
        return out[0].transpose(1, 2), out[1]
    return out.transpose(1, 2)


def encoder_apply(p, x, cfg: GeneratorConfig, state=None):
    """x: (B, T, C_in) -> (B, T', C_enc); with `state`, (h, new state)."""
    if state is None:
        return _bct_apply(lambda v: encoder_bct(p, v, cfg, res_stack_plain),
                          x)
    return _bct_apply(lambda v: encoder_stream_bct(p, v, cfg, state), x)


def projector_apply(p, x, cfg: GeneratorConfig, state=None, *,
                    train: bool = False):
    """x: (B, T', C_enc) -> z (B, T', D); with `state`, (z, new state);
    with train (batch mode), (z, new BN running stats or None)."""
    if train:
        z, new_bn = projector_train_bct(p, x.transpose(1, 2), cfg)
        return z.transpose(1, 2), new_bn
    if state is None:
        return _bct_apply(lambda v: projector_bct(p, v, cfg), x)
    return _bct_apply(lambda v: projector_stream_bct(p, v, cfg, state), x)


def decoder_apply(p, z, cfg: GeneratorConfig, state=None):
    """z: (B, T', D) -> (B, T, C_out); with `state`, (y, new state)."""
    if state is None:
        return _bct_apply(lambda v: decoder_bct(p, v, cfg, res_stack_plain),
                          z)
    return _bct_apply(lambda v: decoder_stream_bct(p, v, cfg, state), z)


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


def generator_forward(params, x, cfg: GeneratorConfig, *,
                      train: bool = False, bn_train=None, axis_name=None):
    """The full train / eval forward on the plain residual stacks
    (ref: AudioDec.py:112-120).  x: (B, T, C) -> (y (B, T, C), zq, z
    (B, T', D), vqloss (Q,), perplexity (Q,), new_buffers), new_buffers =
    {"quantizer": the EMA-updated codebooks (the old ones unless train)
    [, "projector_bn": BN running stats {mean, var, count}]}, the buffers a
    train step merges back (merge_forward_buffers).

    bn_train (default: train) sets BN's mode apart from the codebook's: the
    reference's adversarial stage keeps a frozen BN projector in train mode
    while the codebook is in eval mode (ref: trainer/autoencoder.py:66-79).
    axis_name: the data axis the RVQ's statistics are reduced over
    (ops/vq.py `rvq_forward`), or None.
    """
    bn_train = train if bn_train is None else bn_train
    x = _channel_fold(x, cfg.input_channels).transpose(1, 2)
    h = encoder_bct(params["encoder"], x, cfg, res_stack_plain)
    if bn_train:
        z, new_bn = projector_train_bct(params["projector"], h, cfg)
    else:
        z, new_bn = projector_bct(params["projector"], h, cfg), None
    z = z.transpose(1, 2)
    zq, vqloss, ppl, new_q = rvq_forward(z, params["quantizer"], train=train,
                                         axis_name=axis_name)
    y = decoder_bct(params["decoder"], zq.transpose(1, 2), cfg,
                    res_stack_plain)
    new_buffers = {"quantizer": new_q}
    if new_bn is not None:
        new_buffers["projector_bn"] = new_bn
    return y.transpose(1, 2), zq, z, vqloss, ppl, new_buffers


def merge_forward_buffers(gen_params: dict, new_buffers: dict) -> dict:
    """Overwrite the buffers no optimizer drives (the quantizer's EMA
    codebooks, BN's running stats) with those generator_forward returned,
    after the optimizer step -> a new tree that shares every other leaf."""
    out = dict(gen_params, quantizer=new_buffers["quantizer"])
    if "projector_bn" in new_buffers:
        out["projector"] = dict(
            out["projector"],
            bn=dict(out["projector"]["bn"], **new_buffers["projector_bn"]))
    return out


def generator_encode(params, x, cfg: GeneratorConfig, state=None):
    """Waveform (B, T, C) -> code indices (B*C/ic, T', Q); with `state`
    ({"encoder", "projector"}), (indices, new state)."""
    x = _channel_fold(x, cfg.input_channels)
    if state is None:
        h = encoder_apply(params["encoder"], x, cfg)
        z = projector_apply(params["projector"], h, cfg)
        return rvq_forward_index(z, params["quantizer"])[1]
    h, se = encoder_apply(params["encoder"], x, cfg, state=state["encoder"])
    z, sp = projector_apply(params["projector"], h, cfg,
                            state=state["projector"])
    _, idx = rvq_forward_index(z, params["quantizer"])
    return idx, {"encoder": se, "projector": sp}


def generator_decode(params, idx, cfg: GeneratorConfig, state=None):
    """Code indices (B, T', Q) -> waveform (B, T, 1); with `state`
    ({"decoder"}), (waveform, new state)."""
    zq = rvq_lookup(idx, params["quantizer"])
    if state is None:
        return decoder_apply(params["decoder"], zq, cfg)
    y, sd = decoder_apply(params["decoder"], zq, cfg, state=state["decoder"])
    return y, {"decoder": sd}


def codec_state_init(batch: int, cfg: GeneratorConfig, dtype=torch.float32,
                     device=None) -> dict:
    """Zero streaming state of the encode and decode paths."""
    return {"encoder": encoder_state_init(batch, cfg, dtype, device),
            "projector": projector_state_init(batch, cfg, dtype, device),
            "decoder": decoder_state_init(batch, cfg, dtype, device)}
