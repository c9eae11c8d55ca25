"""Residual vector quantization, inference path (counterpart of
audiodec_tpu/ops/vq.py).

params = {"embed": (Q, N, D)}; z is (..., D) rows, as in JAX.  The distance
expansion, the straight-through residual arithmetic and the tie rule are
copied term for term, so the indices agree bit for bit with the JAX package
whenever the f32 products agree (TF32 must be off on the card).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


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
    z: (..., D); embed: (N, D) -> (..., N)."""
    z2 = torch.sum(torch.square(z), dim=-1, keepdim=True)
    e2 = torch.sum(torch.square(embed), dim=-1)
    cross = torch.matmul(z, embed.transpose(0, 1))
    return z2 - 2.0 * cross + e2


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
