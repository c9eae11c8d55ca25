"""Tensor (channel) parallelism of the codec's conv stacks (counterpart of
audiodec_tpu/parallel/tp.py: `make_tp_mesh`, `generator_tp_specs`,
`make_tp_codec`).

JAX annotates the conv weights' shardings over a 'model' mesh axis and lets
GSPMD insert the collectives; torch has no GSPMD, so this module writes the
Megatron pair out with explicit collectives over the ranks of the axis:

  a residual unit's conv1 (k = 7, dilated) is column-parallel: each rank
    holds w's output channels of its index and computes them from the
    whole input; the activation between the two convs stays split;
  its conv2 (1x1) is row-parallel: each rank holds w's input channels of
    its index, its partial sums are all-reduced, and the sum is added to
    the skip, whole on every rank;
  the strided encoder convs, the decoder's transposed convs, the input
    conv, the decoder's conv1 and the projector are column-parallel where
    their output width divides the axis, their outputs all-gathered before
    the next whole-width consumer;
  everything else, the decoder's conv2 (1-2 output channels) and the whole
  RVQ, is replicated: splitting the codebook argmin would reorder the f32
  distance sums that the index parity pins.

The batch rows are split over the 'data' axis with no exchange.  The
specs name, for each leaf, the dim of the port's weight layout that is
split ((O, I, K) for a conv, (I, O, K) for a transposed conv), or None.
"""

from __future__ import annotations

import torch

from audiodec_tpu_torch.models.autoencoder import (
    GeneratorConfig,
    _bn_eval,
    _conv_of,
    _decoder_channels,
    _res_unit_apply,
)
from audiodec_tpu_torch.ops.conv import (
    causal_conv_transpose1d,
    noncausal_conv_transpose1d,
)
from audiodec_tpu_torch.ops.vq import rvq_forward_index, rvq_lookup
from audiodec_tpu_torch.parallel.mesh import Mesh, _mesh_shape
from audiodec_tpu_torch.utils.bridge import tree_map


def make_tp_mesh(data: int = -1, model: int = 1, device=None) -> Mesh:
    """A ('data', 'model') mesh over the first data * model ranks;
    data=-1 takes the rest of the world."""
    return Mesh(_mesh_shape("data", data, "model", model, False), device)


def _replicate(p):
    return tree_map(lambda _: None, p)


def _col(p: dict, width: int, tp: int, transposed: bool = False) -> dict:
    """Column-parallel conv: w split on its output channels (dim 1 of a
    transposed conv's), the bias with them; replicated when the width
    does not divide the axis."""
    if width % tp:
        return _replicate(p)
    spec = {"w": 1 if transposed else 0}
    if "b" in p:
        spec["b"] = 0
    return spec


def _unit(p: dict, channels: int, tp: int) -> dict:
    """The Megatron pair of one residual unit (its convs have no bias):
    conv1 split on its outputs, conv2 on its inputs."""
    if channels % tp:
        return _replicate(p)
    return {"conv1": {"w": 0}, "conv2": {"w": 1}}


def generator_tp_specs(params: dict, cfg: GeneratorConfig, tp: int) -> dict:
    """The split dim of every leaf of a generator tree (None: replicated)
    for a model axis of size tp."""
    enc_p = params["encoder"]
    enc = {"conv": _col(enc_p["conv"], cfg.encode_channels, tp),
           "blocks": []}
    in_ch = cfg.encode_channels
    for i in range(len(cfg.enc_strides)):
        out_ch = cfg.encode_channels * cfg.enc_ratios[i]
        bp = enc_p["blocks"][i]
        enc["blocks"].append({
            "res": [_unit(r, in_ch, tp) for r in bp["res"]],
            "conv": _col(bp["conv"], out_ch, tp)})
        in_ch = out_ch

    dec_p = params["decoder"]
    ch0 = cfg.decode_channels * cfg.dec_ratios[0]
    dec = {"conv1": _col(dec_p["conv1"], ch0, tp), "blocks": []}
    for i in range(len(cfg.dec_strides)):
        _, out_ch = _decoder_channels(cfg, i)
        bp = dec_p["blocks"][i]
        dec["blocks"].append({
            "conv": _col(bp["conv"], out_ch, tp, transposed=True),
            "res": [_unit(r, out_ch, tp) for r in bp["res"]]})
    dec["conv2"] = _replicate(dec_p["conv2"])  # 1-2 output channels

    proj = {"conv": _col(params["projector"]["conv"], cfg.code_dim, tp)}
    if "bn" in params["projector"]:
        proj["bn"] = _replicate(params["projector"]["bn"])
    return {"encoder": enc, "projector": proj,
            "quantizer": _replicate(params["quantizer"]), "decoder": dec}


def tp_shard_params(params, specs, index: int, size: int):
    """This rank's shard of a full tree: each split leaf cut into `size`
    parts along its dim, part `index`; replicated leaves as they are."""
    if isinstance(params, dict):
        return {k: tp_shard_params(v, specs[k], index, size)
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [tp_shard_params(v, s, index, size)
                for v, s in zip(params, specs)]
    if specs is None:
        return params
    n = params.shape[specs] // size
    return params.narrow(specs, index * n, n).contiguous()


def _gathered(axis, spec, y):
    """A column-parallel output made whole; a replicated one as it is."""
    return axis.all_gather(y, 1) if spec["w"] is not None else y


def _res_stack(x, bp, bspec, cfg: GeneratorConfig, axis):
    conv = _conv_of(cfg)
    for j, d in enumerate(cfg.res_dilations):
        p, s = bp["res"][j], bspec["res"][j]
        if s["conv1"]["w"] is None:
            x = _res_unit_apply(p, x, dilation=d, act=cfg.act, mode=cfg.mode)
            continue
        y = conv(cfg.act(x), p["conv1"], dilation=d)
        x = x + axis.all_reduce(conv(cfg.act(y), p["conv2"]))
    return x


def _encoder(p, s, x, cfg: GeneratorConfig, axis):
    """x (B, C_in, T) -> (B, C_enc, T / hop), whole on every rank."""
    conv = _conv_of(cfg)
    x = _gathered(axis, s["conv"], conv(x, p["conv"]))
    for i, stride in enumerate(cfg.enc_strides):
        bp, bs = p["blocks"][i], s["blocks"][i]
        x = _res_stack(x, bp, bs, cfg, axis)
        x = _gathered(axis, bs["conv"], conv(x, bp["conv"], stride=stride))
    return cfg.act(x) if cfg.codec == "activate_audiodec" else x


def _decoder(p, s, z, cfg: GeneratorConfig, axis):
    """z (B, D, T') -> (B, C_out, T' * hop), whole on every rank."""
    conv = _conv_of(cfg)
    convt = (causal_conv_transpose1d if cfg.mode == "causal"
             else noncausal_conv_transpose1d)
    activate = cfg.codec == "activate_audiodec"
    x = _gathered(axis, s["conv1"], conv(z, p["conv1"]))
    for i, stride in enumerate(cfg.dec_strides):
        bp, bs = p["blocks"][i], s["blocks"][i]
        if activate:
            x = cfg.act(x)
        x = _gathered(axis, bs["conv"], convt(x, bp["conv"], stride=stride))
        x = _res_stack(x, bp, bs, cfg, axis)
    if activate:
        return torch.tanh(conv(cfg.act(x), p["conv2"]))
    return conv(x, p["conv2"])


def make_tp_codec(mesh: Mesh, params: dict, cfg: GeneratorConfig,
                  axis: str = "model"):
    """Encode and decode of this rank's batch rows with the conv channels
    split over the mesh's `axis` -> (encode, decode):

      encode(x (b, T, C)) -> idx (b, T / hop, Q)
      decode(idx) -> y (b, T, C)

    Every rank of an `axis` line calls both with the same rows.  A channel
    split never cuts a conv's time axis, but the row-parallel 1x1 sums
    reorder f32 additions, so the waveform matches the unsharded one to
    f32 rounding and an index on a near tie may flip."""
    ax = mesh.axis(axis)
    device = mesh.device
    specs = generator_tp_specs(params, cfg, ax.size)
    local = tree_map(lambda t: t.to(device),
                     tp_shard_params(params, specs, ax.index, ax.size))

    @torch.no_grad()
    def encode(x: torch.Tensor) -> torch.Tensor:
        h = _encoder(local["encoder"], specs["encoder"],
                     x.to(device).transpose(1, 2), cfg, ax)
        pp, ps = local["projector"], specs["projector"]
        z = _gathered(ax, ps["conv"], _conv_of(cfg)(h, pp["conv"]))
        if "bn" in pp:
            z = _bn_eval(pp["bn"], z)
        _, idx = rvq_forward_index(z.transpose(1, 2), local["quantizer"])
        return idx

    @torch.no_grad()
    def decode(idx: torch.Tensor) -> torch.Tensor:
        zq = rvq_lookup(idx.to(device), local["quantizer"])
        return _decoder(local["decoder"], specs["decoder"],
                        zq.transpose(1, 2), cfg, ax).transpose(1, 2)

    return encode, decode
