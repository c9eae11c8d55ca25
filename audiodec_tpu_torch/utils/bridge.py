"""Weights carried into the port: from the JAX package's param tree, and from
the reference implementation's checkpoints (`load_reference_checkpoint`,
`load_reference_meta`) and state dicts (the port's own copy of
audiodec_tpu/utils/torch_import.py `fold_weight_norm`, `import_autoencoder`,
`import_vocoder`, `import_hifigan_discriminator` with either fold,
`import_univnet_mrsd` and `import_univnet_discriminator`, under the names
`*_params_from_reference_sd`); and back to the
JAX tree (`params_to_jax`, `vocoder_params_to_jax`,
`disc_params_to_jax`), so that port weights can be written as a JAX-format
checkpoint (utils/checkpoint.py).  A conv carried either way keeps its norm
reparametrization: {"v", "g"} and {"w_raw", "u"} leaves move as "w" does.

The port's tree is the JAX tree's structure with torch's weight
orientation, as CPU float32 tensors; the JAX tree holds numpy arrays.

    JAX conv           (K, I, O)            -> (O, I, K)
    JAX conv2d         (KH, KW, I, O)       -> (O, I, KH, KW)
    JAX transposed     (K, I, O) gathering  -> (I, O, K), K flipped
                       (w[k, i, o] = W_torch[i, o, K-1-k])
    reference conv     (O, I, K), reference transposed (I, O, K): as is
    reference embed    (D, N) per quantizer -> (N, D)

Streaming states (`state_from_jax`, `state_to_jax`): the JAX package keeps
each layer's past inputs as (B, L, C), the port as (B, C, L); the trees
have the same structure.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def tree_map(fn: Callable, tree):
    """Apply fn to every tensor of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


# ---------------------------------------------------------------------------
# from the JAX param tree (numpy leaves)
# ---------------------------------------------------------------------------

# a conv's weight-like leaves: plain "w", weight norm's "v" and "g" (g keeps
# the preserved axis, size 1 elsewhere), spectral norm's "w_raw"; the
# others ("b", spectral norm's "u", one entry per output channel) carry over
_WEIGHTS = ("w", "v", "g", "w_raw")


def _conv_leaves(p: dict, weight, other) -> dict:
    return {k: weight(v) if k in _WEIGHTS else other(v) for k, v in p.items()}


def _conv_from_jax(p: dict) -> dict:
    """(K..., I, O) -> (O, I, K...), for 1-D and 2-D convs."""
    return _conv_leaves(
        p, lambda a: _tensor(np.transpose(
            a, (2, 1, 0) if np.ndim(a) == 3 else (3, 2, 0, 1))), _tensor)


def _convt_from_jax(p: dict) -> dict:
    return _conv_leaves(
        p, lambda a: _tensor(np.transpose(np.asarray(a)[::-1], (1, 2, 0))),
        _tensor)


def _res_from_jax(units) -> list:
    return [{"conv1": _conv_from_jax(u["conv1"]),
             "conv2": _conv_from_jax(u["conv2"])} for u in units]


def unit_params_from_jax(units) -> tuple:
    """A bare JAX unit tuple ((w1 (K, C, C), w2 (1, C, C)), ...) -> torch's
    ((w1 (C, C, K), w2 (C, C, 1)), ...)."""
    return tuple((_tensor(np.transpose(w1, (2, 1, 0))),
                  _tensor(np.transpose(w2, (2, 1, 0)))) for w1, w2 in units)


def params_from_jax(tree: dict) -> dict:
    """JAX generator params (as numpy arrays) -> the port's params."""
    enc, dec = tree["encoder"], tree["decoder"]
    proj = {"conv": _conv_from_jax(tree["projector"]["conv"])}
    if "bn" in tree["projector"]:
        proj["bn"] = {k: _tensor(v)
                      for k, v in tree["projector"]["bn"].items()}
    return {
        "encoder": {
            "conv": _conv_from_jax(enc["conv"]),
            "blocks": [{"res": _res_from_jax(b["res"]),
                        "conv": _conv_from_jax(b["conv"])}
                       for b in enc["blocks"]],
        },
        "projector": proj,
        # the EMA statistics (training state) ride along, unused
        "quantizer": {k: _tensor(v) for k, v in tree["quantizer"].items()},
        "decoder": {
            "conv1": _conv_from_jax(dec["conv1"]),
            "blocks": [{"conv": _convt_from_jax(b["conv"]),
                        "res": _res_from_jax(b["res"])}
                       for b in dec["blocks"]],
            "conv2": _conv_from_jax(dec["conv2"]),
        },
    }


def _voc_resblock_from_jax(blk: dict) -> dict:
    return {"convs1": [_conv_from_jax(c) for c in blk["convs1"]],
            "convs2": [_conv_from_jax(c) for c in blk["convs2"]]}


def vocoder_params_from_jax(tree: dict) -> dict:
    """JAX vocoder params (as numpy arrays) -> the port's params.  A grouped
    conv's JAX (K, C, G*C) weight becomes torch's (G*C, C, K)."""
    blocks = []
    for blk in tree["blocks"]:
        if "blocks" in blk:   # MultiReceptiveField
            blocks.append({"blocks": [_voc_resblock_from_jax(b)
                                      for b in blk["blocks"]]})
        else:                 # MultiGroupConv1d
            blocks.append({**_voc_resblock_from_jax(blk),
                           "conv_out": _conv_from_jax(blk["conv_out"])})
    out = {
        "input_conv": _conv_from_jax(tree["input_conv"]),
        "upsamples": [_convt_from_jax(u) for u in tree["upsamples"]],
        "blocks": blocks,
        "output_conv": _conv_from_jax(tree["output_conv"]),
    }
    for k in ("mean", "scale"):
        if k in tree:
            out[k] = _tensor(tree[k])
    return out


# ---------------------------------------------------------------------------
# back to the JAX param tree (numpy leaves)
# ---------------------------------------------------------------------------

def _array(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _conv_to_jax(p: dict) -> dict:
    """(O, I, K...) -> (K..., I, O), for 1-D and 2-D convs."""
    return _conv_leaves(
        p, lambda t: np.ascontiguousarray(np.transpose(
            _array(t), (2, 1, 0) if t.ndim == 3 else (2, 3, 1, 0))), _array)


def _convt_to_jax(p: dict) -> dict:
    return _conv_leaves(
        p, lambda t: np.ascontiguousarray(
            np.transpose(_array(t), (2, 0, 1))[::-1]), _array)


def _res_to_jax(units) -> list:
    return [{"conv1": _conv_to_jax(u["conv1"]),
             "conv2": _conv_to_jax(u["conv2"])} for u in units]


def _quantizer_to_jax(q: dict) -> dict:
    """The codebooks, with the EMA statistics the JAX tree holds for
    training: carried where the port's params have them, else as JAX's
    init sets them (cluster_size 0, embed_avg = embed)."""
    embed = _array(q["embed"])
    out = {"embed": embed,
           "cluster_size": np.zeros(embed.shape[:2], np.float32),
           "embed_avg": embed.copy()}
    out.update({k: _array(v) for k, v in q.items()})
    return out


def params_to_jax(params: dict) -> dict:
    """The port's generator params -> the JAX tree (inverse of
    params_from_jax)."""
    enc, dec = params["encoder"], params["decoder"]
    proj = {"conv": _conv_to_jax(params["projector"]["conv"])}
    if "bn" in params["projector"]:
        proj["bn"] = {k: _array(v)
                      for k, v in params["projector"]["bn"].items()}
    return {
        "encoder": {
            "conv": _conv_to_jax(enc["conv"]),
            "blocks": [{"res": _res_to_jax(b["res"]),
                        "conv": _conv_to_jax(b["conv"])}
                       for b in enc["blocks"]],
        },
        "projector": proj,
        "quantizer": _quantizer_to_jax(params["quantizer"]),
        "decoder": {
            "conv1": _conv_to_jax(dec["conv1"]),
            "blocks": [{"conv": _convt_to_jax(b["conv"]),
                        "res": _res_to_jax(b["res"])}
                       for b in dec["blocks"]],
            "conv2": _conv_to_jax(dec["conv2"]),
        },
    }


def _voc_resblock_to_jax(blk: dict) -> dict:
    return {"convs1": [_conv_to_jax(c) for c in blk["convs1"]],
            "convs2": [_conv_to_jax(c) for c in blk["convs2"]]}


def vocoder_params_to_jax(params: dict) -> dict:
    """The port's vocoder params -> the JAX tree (inverse of
    vocoder_params_from_jax)."""
    blocks = []
    for blk in params["blocks"]:
        if "blocks" in blk:   # MultiReceptiveField
            blocks.append({"blocks": [_voc_resblock_to_jax(b)
                                      for b in blk["blocks"]]})
        else:                 # MultiGroupConv1d
            blocks.append({**_voc_resblock_to_jax(blk),
                           "conv_out": _conv_to_jax(blk["conv_out"])})
    out = {
        "input_conv": _conv_to_jax(params["input_conv"]),
        "upsamples": [_convt_to_jax(u) for u in params["upsamples"]],
        "blocks": blocks,
        "output_conv": _conv_to_jax(params["output_conv"]),
    }
    for k in ("mean", "scale"):
        if k in params:
            out[k] = _array(params[k])
    return out


def _is_conv(node) -> bool:
    return isinstance(node, dict) and any(k in node for k in _WEIGHTS)


def _convs(tree, fn):
    """fn applied to every conv dict of a tree of dicts and lists."""
    if _is_conv(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _convs(v, fn) for k, v in tree.items()}
    return [_convs(v, fn) for v in tree]


def disc_params_from_jax(tree: dict) -> dict:
    """JAX discriminator params (numpy leaves; either discriminator, plain,
    weight- or spectral-normed convs) -> the port's."""
    return _convs(tree, _conv_from_jax)


def disc_params_to_jax(params: dict) -> dict:
    """The port's discriminator params -> the JAX tree (inverse of
    disc_params_from_jax)."""
    return _convs(params, _conv_to_jax)


def state_from_jax(tree):
    """A JAX streaming state (numpy leaves, (B, L, C)) -> the port's
    ((B, C, L) CPU float32 tensors)."""
    return tree_map(lambda a: _tensor(np.transpose(a, (0, 2, 1))), tree)


def state_to_jax(tree):
    """The port's streaming state -> the JAX layout (numpy, (B, L, C))."""
    return tree_map(
        lambda t: np.ascontiguousarray(np.transpose(_array(t), (0, 2, 1))),
        tree)


# ---------------------------------------------------------------------------
# from the reference state dict (as in tests/golden/*.npz `sd__*` keys)
# ---------------------------------------------------------------------------

def fold_weight_norm(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Fold every `X.weight_g`/`X.weight_v` pair into `X.weight`
    (torch weight norm, dim=0: w = g * v / ||v|| over the other dims)."""
    out = {}
    for k, a in sd.items():
        if k.endswith("weight_g"):
            base = k[: -len("weight_g")]
            v = np.asarray(sd[base + "weight_v"], dtype=np.float64)
            g = np.asarray(a, dtype=np.float64)
            norm = np.sqrt(np.sum(v * v, axis=tuple(range(1, v.ndim)),
                                  keepdims=True))
            out[base + "weight"] = (g * v / norm).astype(np.float32)
        elif not k.endswith("weight_v"):
            out.setdefault(k, np.asarray(a))
    return out


def _conv_from_sd(sd: Dict[str, np.ndarray], prefix: str) -> dict:
    """A conv (or transposed conv) of the state dict, in its own layout."""
    p = {"w": _tensor(sd[prefix + ".weight"])}
    if prefix + ".bias" in sd:
        p["b"] = _tensor(sd[prefix + ".bias"])
    return p


def params_from_reference_sd(sd: Dict[str, np.ndarray], cfg) -> dict:
    """Reference AudioDec Generator state dict -> the port's params."""
    sd = fold_weight_norm(sd)
    conv = partial(_conv_from_sd, sd)

    def res(prefix):
        return [{"conv1": conv(f"{prefix}.res_units.{j}.conv1.conv"),
                 "conv2": conv(f"{prefix}.res_units.{j}.conv2")}
                for j in range(len(cfg.res_dilations))]

    if "projector.project.conv.weight" in sd:
        proj = {"conv": conv("projector.project.conv")}
    else:  # conv1d_bn: Sequential(CausalConv1d, BatchNorm1d)
        bn = "projector.project.1."
        proj = {"conv": conv("projector.project.0.conv"),
                "bn": {"scale": _tensor(sd[bn + "weight"]),
                       "bias": _tensor(sd[bn + "bias"]),
                       "mean": _tensor(sd[bn + "running_mean"]),
                       "var": _tensor(sd[bn + "running_var"]),
                       "count": _tensor(sd[bn + "num_batches_tracked"])}}

    def dec_block(i):
        # ActivateDecoder wraps each block in Sequential(act, DecoderBlock)
        return (f"decoder.conv_blocks.{i}.1"
                if cfg.codec == "activate_audiodec"
                else f"decoder.conv_blocks.{i}")

    def codebooks(name, transpose):
        return _tensor(np.stack([
            np.asarray(sd[f"quantizer.codebook.layers.{q}.{name}"]).T
            if transpose else sd[f"quantizer.codebook.layers.{q}.{name}"]
            for q in range(cfg.codebook_num)]))

    return {
        "encoder": {
            "conv": conv("encoder.conv.conv"),
            "blocks": [{"res": res(f"encoder.conv_blocks.{i}"),
                        "conv": conv(f"encoder.conv_blocks.{i}.conv.conv")}
                       for i in range(len(cfg.enc_strides))],
        },
        "projector": proj,
        # embed (D, N) -> (N, D); the EMA statistics ride along, unused
        "quantizer": {"embed": codebooks("embed", True),
                      "cluster_size": codebooks("cluster_size", False),
                      "embed_avg": codebooks("embed_avg", True)},
        "decoder": {
            "conv1": conv("decoder.conv1.conv"),
            "blocks": [{"conv": conv(f"{dec_block(i)}.conv.deconv"),
                        "res": res(dec_block(i))}
                       for i in range(len(cfg.dec_strides))],
            "conv2": conv("decoder.conv2.conv"),
        },
    }


def _conv_or_wn_from_sd(sd: Dict[str, np.ndarray], prefix: str) -> dict:
    """A conv of the state dict: weight-normed ones as {"v", "g"[, "b"]}
    (torch's weight_norm dim=0 is the port's preserved axis 0, for the
    transposed convs' input channels too), the others as {"w"[, "b"]}."""
    if prefix + ".weight_v" not in sd:
        return _conv_from_sd(sd, prefix)
    p = {"v": _tensor(sd[prefix + ".weight_v"]),
         "g": _tensor(sd[prefix + ".weight_g"])}
    if prefix + ".bias" in sd:
        p["b"] = _tensor(sd[prefix + ".bias"])
    return p


def vocoder_params_from_reference_sd(sd: Dict[str, np.ndarray], cfg,
                                     fold: bool = True) -> dict:
    """Reference HiFiGAN Generator state dict -> the port's params (key
    scheme of ref models/vocoder/HiFiGAN.py:84-123), the `mean`/`scale`
    stats carried.  fold=True folds weight norm (inference); fold=False
    keeps it as {"v", "g"[, "b"]} (training, where torch's Adam trains
    weight_g and weight_v)."""
    if fold:
        sd = fold_weight_norm(sd)
    conv = partial(_conv_or_wn_from_sd, sd)

    def resblock(prefix, dilations):
        n = len(dilations)
        return {"convs1": [conv(f"{prefix}.convs1.{j}.conv")
                           for j in range(n)],
                "convs2": ([conv(f"{prefix}.convs2.{j}.conv")
                            for j in range(n)]
                           if cfg.use_additional_convs else [])}

    blocks = []
    for i in range(len(cfg.upsample_scales)):
        pre = f"blocks.{i}"
        if cfg.grouped:
            blocks.append({**resblock(pre, cfg.resblock_dilations[0]),
                           "conv_out": conv(f"{pre}.conv_out")})
        else:
            blocks.append({"blocks": [
                resblock(f"{pre}.blocks.{b}", cfg.resblock_dilations[b])
                for b in range(len(cfg.resblock_kernel_sizes))]})
    out = {
        "input_conv": conv("input_conv.conv"),
        "upsamples": [conv(f"upsamples.{i}.deconv")
                      for i in range(len(cfg.upsample_scales))],
        "blocks": blocks,
        "output_conv": conv("output_conv.conv"),
    }
    for k in ("mean", "scale"):
        if k in sd:
            out[k] = _tensor(sd[k])
    return out


def _period_discs(sd, cfg, conv) -> dict:
    n = len(cfg.discriminator.layer_shapes())
    return {"discriminators": [
        {"layers": [conv(f"mpd.discriminators.{i}.convs.{j}.0.conv")
                    for j in range(n)],
         "output_conv": conv(f"mpd.discriminators.{i}.output_conv.conv")}
        for i in range(len(cfg.periods))]}


def _layer_key(prefix: str, j: int, n: int) -> str:
    # every layer but the last is Sequential(conv, act) -> ".0.conv"
    return f"{prefix}.layers.{j}" + (".conv" if j == n - 1 else ".0.conv")


def hifigan_disc_params_from_reference_sd(sd: Dict[str, np.ndarray], cfg,
                                          fold: bool = True) -> dict:
    """Reference HiFiGAN MSD + MPD state dict -> the port's params.
    fold=False keeps the MPD's weight norm as {"v", "g"[, "b"]} (training,
    where torch's Adam trains weight_g and weight_v); the MSD's convs are
    plain in the reference."""
    if fold:
        sd = fold_weight_norm(sd)
    conv = partial(_conv_or_wn_from_sd, sd)
    n = len(cfg.msd.discriminator.layer_shapes())
    msd = {"discriminators": [
        {"layers": [conv(_layer_key(f"msd.discriminators.{i}", j, n))
                    for j in range(n)]}
        for i in range(cfg.msd.scales)]}
    return {"msd": msd, "mpd": _period_discs(sd, cfg.mpd, conv)}


def mrsd_params_from_reference_sd(sd: Dict[str, np.ndarray], cfg,
                                  prefix: str = "") -> dict:
    """Reference UnivNet multi-resolution spectral discriminator state dict
    -> the port's params, weight norm folded; `prefix` is "mrsd." within the
    combined UnivNet discriminator."""
    sd = fold_weight_norm(sd)
    n = len(cfg.discriminator.layer_shapes())
    return {"discriminators": [
        {"layers": [_conv_from_sd(sd, _layer_key(
            f"{prefix}discriminators.{i}", j, n)) for j in range(n)]}
        for i in range(len(cfg.fft_sizes))]}


def univnet_disc_params_from_reference_sd(sd: Dict[str, np.ndarray],
                                          cfg) -> dict:
    """Reference UnivNet MRSD + MPD discriminator state dict -> the port's
    params, weight norm folded (JAX: `import_univnet_discriminator`,
    audiodec_tpu/utils/torch_import.py:325).  cfg:
    UnivNetDiscriminatorConfig."""
    sd = fold_weight_norm(sd)
    return {"mrsd": mrsd_params_from_reference_sd(sd, cfg.mrsd,
                                                  prefix="mrsd."),
            "mpd": _period_discs(sd, cfg.mpd, partial(_conv_from_sd, sd))}


# ---------------------------------------------------------------------------
# reference checkpoints (.pkl)
# ---------------------------------------------------------------------------

def _torch_load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def load_reference_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A reference checkpoint (.pkl) -> its generator's state dict as numpy
    arrays (JAX: `load_torch_checkpoint`, torch_import.py:343).  Takes the
    reference trainer's layout {"model": {"generator": sd, ...}, "steps",
    "epochs", ...} or a bare state dict."""
    obj = _torch_load(path)
    if isinstance(obj, dict) and "model" in obj:
        obj = obj["model"]
        obj = obj.get("generator", obj)
    return {k: v.detach().cpu().numpy() for k, v in obj.items()}


def load_reference_meta(path: str) -> Dict[str, int]:
    """The training progress a reference checkpoint keeps beside its
    weights: `steps` and `epochs`, where present (JAX: `load_torch_meta`,
    torch_import.py:357)."""
    obj = _torch_load(path)
    if not isinstance(obj, dict):
        return {}
    return {k: int(obj[k]) for k in ("steps", "epochs") if k in obj}
