"""Residual vector quantization, inference path (counterpart of
audiodec_tpu/ops/vq.py).

params = {"embed": (Q, N, D)}; z is (..., D) rows, as in JAX.  The distance
expansion, the straight-through residual arithmetic and the tie rule are
copied term for term, so the indices agree bit for bit with the JAX package
whenever the f32 products agree (TF32 must be off on the card).
"""

from __future__ import annotations

from typing import Tuple

import torch


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


def rvq_forward_index(z: torch.Tensor, params: dict, flatten: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize-dequantize with indices.  z: (B, T, D) -> (zq, idx (B, T, Q)
    int32); with `flatten`, layer-q indices are offset by q*N (the
    reference's wire format)."""
    embed = params["embed"]
    num_q, n_embed = embed.shape[0], embed.shape[1]
    residual = z
    zq = torch.zeros_like(z)
    idxs = []
    for q in range(num_q):
        idx = vq_nearest(residual, embed[q])
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
