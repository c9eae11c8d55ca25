"""Functional weight-norm and spectral-norm reparametrizations (counterpart
of audiodec_tpu/ops/norms.py).

The reparametrization is explicit in the param tree and resolved once per
loss function:

    weight-normed conv:   {"v", "g"[, "b"]}      w = g * v / ||v||
    spectral-normed conv: {"w_raw", "u"[, "b"]}  w = w_raw / sigma

`resolve_params(tree)` maps the tree to plain {"w"[, "b"]} conv dicts, so
that the models' apply functions know no norm, and returns the updated tree
(spectral norm advances its power-iteration vector `u`).  These are the JAX
package's semantics, not those of torch.nn.utils.spectral_norm: the caller
decides which `u` to keep (a training step keeps the one of the
discriminator's own update and throws away the one of the generator's
adversarial loss).

Weights are in torch's orientation, so the axis a norm preserves is always
axis 0: the output channels of a conv, the input channels of a transposed
conv (torch's weight_norm dim=0).  `g` keeps axis 0 at its size and has
size 1 elsewhere.  Spectral norm's sigma is taken over the (O, the rest)
matricization and its `u` has one entry per output channel, as in JAX.
"""

from __future__ import annotations

from typing import Tuple

import torch


def weight_norm_params(p: dict) -> dict:
    """{"w"[, "b"]} -> weight-normed {"v", "g"[, "b"]}."""
    w = p["w"]
    g = torch.sqrt(torch.sum(w * w, dim=tuple(range(1, w.ndim)),
                             keepdim=True))
    out = {"v": w, "g": g}
    if "b" in p:
        out["b"] = p["b"]
    return out


def spectral_norm_params(gen: torch.Generator, p: dict) -> dict:
    """{"w"[, "b"]} -> spectral-normed {"w_raw", "u"[, "b"]}, `u` a random
    unit vector drawn from `gen`."""
    w = p["w"]
    u = torch.randn(w.shape[0], generator=gen, device=gen.device,
                    dtype=w.dtype)
    out = {"w_raw": w, "u": u / (torch.linalg.vector_norm(u) + 1e-12)}
    if "b" in p:
        out["b"] = p["b"]
    return out


def _resolve_weight_norm(d: dict) -> dict:
    v, g = d["v"], d["g"]
    axes = tuple(i for i, s in enumerate(g.shape) if s == 1)
    norm = torch.sqrt(torch.sum(v * v, dim=axes, keepdim=True))
    out = {"w": g * v / norm}
    if "b" in d:
        out["b"] = d["b"]
    return out


def _resolve_spectral_norm(d: dict, n_iter: int = 1) -> Tuple[dict, dict]:
    w, u = d["w_raw"], d["u"]
    mat = w.reshape(w.shape[0], -1).transpose(0, 1)  # (the rest, O)
    with torch.no_grad():
        for _ in range(n_iter):
            v = mat @ u
            v = v / (torch.linalg.vector_norm(v) + 1e-12)
            u = mat.transpose(0, 1) @ v
            u = u / (torch.linalg.vector_norm(u) + 1e-12)
    sigma = v @ (mat @ u)
    out = {"w": w / sigma}
    if "b" in d:
        out["b"] = d["b"]
    return out, dict(d, u=u)


def resolve_params(tree):
    """Resolve every norm reparametrization of a param tree -> (effective
    tree of plain {"w"[, "b"]} convs, updated tree with advanced `u`s)."""
    if isinstance(tree, dict):
        if "v" in tree and "g" in tree:
            return _resolve_weight_norm(tree), tree
        if "w_raw" in tree and "u" in tree:
            return _resolve_spectral_norm(tree)
        eff, upd = {}, {}
        for k, sub in tree.items():
            eff[k], upd[k] = resolve_params(sub)
        return eff, upd
    if isinstance(tree, (list, tuple)):
        pairs = [resolve_params(x) for x in tree]
        return [p[0] for p in pairs], [p[1] for p in pairs]
    return tree, tree


def apply_weight_norm_tree(tree):
    """Weight-norm every conv dict ({"w"[, "b"]}) of a param tree, as the
    reference's apply_weight_norm walk does; transposed convs need no
    special case in torch's orientation."""
    if isinstance(tree, dict):
        if "w" in tree:
            return weight_norm_params(tree)
        return {k: apply_weight_norm_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [apply_weight_norm_tree(x) for x in tree]
    return tree
