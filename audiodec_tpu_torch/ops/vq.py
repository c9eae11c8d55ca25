"""Residual vector quantization (counterpart of audiodec_tpu/ops/vq.py): the
inference path, the training forward with its EMA codebook update, and the
exact distances that hold the two-pass argmin's shortlist
(`vq_distances_exact`, `rvq_shortlist_ranks`).

params = {"embed": (Q, N, D)[, "cluster_size": (Q, N), "embed_avg":
(Q, N, D)]}; z is (..., D) rows, as in JAX.  The distance
expansion, the straight-through residual arithmetic and the tie rule are
copied term for term, so the indices agree bit for bit with the JAX package
whenever the f32 products agree (TF32 must be off on the card).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def rvq_init(gen: torch.Generator, num_quantizers: int, codebook_size: int,
             dim: int) -> dict:
    """Random-normal codebooks with the JAX `rvq_init`'s keys and shapes
    (`embed` (Q, N, D), `cluster_size` (Q, N) zeros, `embed_avg` a copy of
    `embed`), drawn from `gen` on its device; the numbers differ from
    JAX's."""
    embed = torch.randn(num_quantizers, codebook_size, dim, generator=gen,
                        device=gen.device)
    return {"embed": embed,
            "cluster_size": torch.zeros(num_quantizers, codebook_size,
                                        device=gen.device),
            "embed_avg": embed.clone()}


def vq_distances(z: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances in f32, |z|^2 - 2 z.E^T + |E|^2 in that order.
    z: (..., D); embed: (N, D) -> (..., N).  As in JAX, the squared norms
    are summed in the inputs' dtype and the cross term is taken in f32."""
    z2 = torch.sum(torch.square(z), dim=-1, keepdim=True)
    e2 = torch.sum(torch.square(embed), dim=-1)
    cross = torch.matmul(z.float(), embed.float().transpose(0, 1))
    return z2 - 2.0 * cross + e2


def vq_distances_exact(z: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """vq_distances with the cross term in true f32 whatever the TF32
    setting (JAX's HIGHEST precision; with TF32 off, as the port's entry
    points set it, the same as vq_distances).  The oracle the two-pass
    argmin's shortlist is held to."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return vq_distances(z, embed)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def rvq_shortlist_ranks(z: torch.Tensor, params: dict,
                        pass1_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """The rank of each layer's exact argmin among the first-pass distances
    that vq_nearest_2pass draws its shortlist from (0: the first pass
    already ranks it best; ties count the lower indices before it, the
    order of top-k).  vq_nearest_2pass(k) is exact for a frame iff every
    rank is below k, so the largest rank over a corpus is the least safe k.

    pass1_dtype: a cast of the residual and the codebook for the first
    pass only (a lower-precision first pass, as bf16 multiplies are in the
    JAX package on the TPU).  The residuals follow the exact indices.
    z: (B, T, D) float32 -> ranks (B, T, Q) int32."""
    embed = params["embed"]
    residual = z
    ranks = []
    for q in range(embed.shape[0]):
        e_q = embed[q]
        if pass1_dtype is not None:
            d1 = vq_distances(residual.to(pass1_dtype),
                              e_q.to(pass1_dtype))
        else:
            d1 = vq_distances(residual, e_q)
        true_idx = torch.argmin(vq_distances_exact(residual, e_q), dim=-1)
        d1_true = torch.gather(d1, -1, true_idx.unsqueeze(-1))
        ids = torch.arange(e_q.shape[0], device=z.device)
        below = torch.sum(d1 < d1_true, dim=-1)
        tie_before = torch.sum((d1 == d1_true)
                               & (ids < true_idx.unsqueeze(-1)), dim=-1)
        ranks.append(below + tie_before)
        residual = residual - e_q[true_idx]
    return torch.stack(ranks, dim=-1).to(torch.int32)


def vq_nearest(z: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Nearest-codebook indices; ties go to the lowest index (torch.argmin
    returns the first minimum, as the reference's `(-dist).max(1)`)."""
    return torch.argmin(vq_distances(z, embed), dim=-1).to(torch.int32)


def vq_nearest_2pass(z: torch.Tensor, embed: torch.Tensor,
                     k: int = 16) -> torch.Tensor:
    """Two-pass argmin: shortlist the k nearest codes by vq_distances, then
    re-score only those with an f32 cross term; ties go to the lowest code
    index.  The JAX package needs it where its first pass multiplies in
    bf16; with TF32 off both passes here are f32, so it gives
    vq_nearest's indices.  z: (..., D); embed: (N, D) -> (...) int32."""
    _, cand = torch.topk(-vq_distances(z, embed), k, dim=-1)
    e = embed[cand]                                    # (..., k, D)
    z2 = torch.sum(torch.square(z), dim=-1, keepdim=True)
    e2 = torch.sum(torch.square(e), dim=-1)
    cross = torch.matmul(e, z.unsqueeze(-1)).squeeze(-1)
    dk = z2 - 2.0 * cross + e2
    m = torch.min(dk, dim=-1, keepdim=True).values
    best = torch.where(dk <= m, cand, embed.shape[0]).min(dim=-1).values
    return best.to(torch.int32)


def rvq_forward_index(z: torch.Tensor, params: dict, flatten: bool = False,
                      exact_k: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize-dequantize with indices.  z: (B, T, D) -> (zq, idx (B, T, Q)
    int32); with `flatten`, layer-q indices are offset by q*N (the
    reference's wire format); with `exact_k`, each layer's argmin is
    vq_nearest_2pass with that shortlist."""
    embed = params["embed"]
    num_q, n_embed = embed.shape[0], embed.shape[1]
    residual = z
    zq = torch.zeros_like(z)
    idxs = []
    for q in range(num_q):
        idx = (vq_nearest_2pass(residual, embed[q], k=exact_k) if exact_k
               else vq_nearest(residual, embed[q]))
        quant = embed[q][idx.long()]
        # JAX's straight-through form, residual + (quant - residual), which
        # rounds differently from quant itself
        quant = residual + (quant - residual)
        residual = residual - quant
        zq = zq + quant
        idxs.append(idx + q * n_embed if flatten else idx)
    return zq, torch.stack(idxs, dim=-1)


def rvq_lookup(idx: torch.Tensor, params: dict,
               flattened: bool = False) -> torch.Tensor:
    """Indices (B, T, Q) -> zq (B, T, D): codebook lookup summed over Q."""
    embed = params["embed"]
    num_q, n_embed, dim = embed.shape
    offsets = torch.arange(num_q, device=idx.device,
                           dtype=idx.dtype) * n_embed
    if flattened:
        idx = idx - offsets
    flat = embed.reshape(num_q * n_embed, dim)
    return torch.sum(flat[(idx + offsets).long()], dim=-2)


def rvq_forward(z: torch.Tensor, params: dict, *, train: bool,
                decay: float = 0.8, eps: float = 1e-5,
                commitment: float = 1.0, axis_name=None):
    """Training / eval forward -> (zq, per-layer commitment losses (Q,),
    perplexities (Q,), new params).  z: (B, T, D).

    Term for term JAX's: the straight-through estimator
    residual + sg(quant - residual) with the residual subtraction not
    detached (so only the first layer's gradient reaches the encoder), the
    commitment loss mean((sg(quant) - residual)^2) per layer.  With train,
    the EMA update of the reference (ref: layers/vq_module.py:74-80) is
    computed from the codebooks as they were before the step and returned
    as new buffers (cluster_size, embed_avg, embed); without, `params` is
    returned as it is.  The buffers carry no gradient.

    axis_name: None, or the data axis (parallel/distributed.py `Axis`)
    over whose ranks JAX's `axis_name` reduces: each layer's average code
    probabilities are averaged over it (pmean) and the EMA's code counts
    and sums added (psum), so every rank computes the same perplexities and
    codebooks from the global batch.  The layers' statistics go in one
    buffer and one collective; the per-element sums are the same as one
    collective per statistic.
    """
    embed = params["embed"]
    num_q, n_embed, dim = embed.shape
    residual = z
    zq = torch.zeros_like(z)
    losses, perplexities = [], []
    new_cluster, new_avg, new_embed = [], [], []
    stats = []  # per layer: avg_probs (and with train the EMA sums)
    for q in range(num_q):
        e_q = embed[q]
        with torch.no_grad():
            idx = vq_nearest(residual, e_q).reshape(-1).long()
            onehot = F.one_hot(idx, n_embed).to(z.dtype)
            stats.append([torch.mean(onehot, dim=0)])
            if train:
                stats[-1] += [torch.sum(onehot, dim=0),
                              onehot.transpose(0, 1)
                              @ residual.reshape(-1, dim)]
        quant = e_q.detach()[idx].reshape(residual.shape)
        losses.append(commitment * torch.mean(torch.square(
            quant.detach() - residual)))
        quant = residual + (quant - residual).detach()
        residual = residual - quant
        zq = zq + quant
    if axis_name is not None and axis_name.size > 1:
        stats = _reduce_stats(stats, axis_name)
    with torch.no_grad():
        for q, layer in enumerate(stats):
            avg_probs = layer[0]
            perplexities.append(torch.exp(-torch.sum(
                avg_probs * torch.log(avg_probs + 1e-10))))
            if not train:
                continue
            onehot_sum, embed_sum = layer[1], layer[2]
            cs = (params["cluster_size"][q] * decay
                  + (1 - decay) * onehot_sum)
            ea = params["embed_avg"][q] * decay + (1 - decay) * embed_sum
            total = torch.sum(cs)
            smoothed = (cs + eps) / (total + n_embed * eps) * total
            new_cluster.append(cs)
            new_avg.append(ea)
            new_embed.append(ea / smoothed[:, None])
    new_params = params
    if train:
        new_params = {"embed": torch.stack(new_embed),
                      "cluster_size": torch.stack(new_cluster),
                      "embed_avg": torch.stack(new_avg)}
    return zq, torch.stack(losses), torch.stack(perplexities), new_params


@torch.no_grad()
def _reduce_stats(stats: list, axis) -> list:
    """The layers' statistics summed over the axis in one collective; the
    average probabilities (each layer's first entry) divided by its size
    after the sum, JAX's pmean."""
    flat = torch.cat([t.reshape(-1) for layer in stats for t in layer])
    flat = axis.all_reduce(flat, "sum")
    out, at = [], 0
    for layer in stats:
        parts = []
        for j, t in enumerate(layer):
            part = flat[at:at + t.numel()].reshape(t.shape)
            parts.append(part / axis.size if j == 0 else part)
            at += t.numel()
        out.append(parts)
    return out
