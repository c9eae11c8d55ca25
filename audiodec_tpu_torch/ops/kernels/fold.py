"""Time folded into lanes: the TPU folded stack's layout helpers in torch.

Copies of `audiodec_tpu/ops/pallas/folded_stack.py:57-98` and of its time
padding and halo (`:177-199`).  The TPU kernel
folds f samples of C channels into one row of f*C lanes,
x (B, T, C) -> (B, T/f, f*C); a causal conv(k, dilation d) then becomes a
sum over a few non-positive row offsets o of full-width products
X[u + o] @ Wf_o.  The port's kernels keep the unfolded layout, but the
int8 mode's row and tile scales and the ablation probe's `noshift`
variant are defined on folded rows and time tiles, so their plain versions
need the fold and the TPU kernel's tiling.
"""

from __future__ import annotations

import torch


def fold_factor(c: int) -> int:
    """Samples per folded row: f = 128 // C (at least 1)."""
    return max(1, 128 // c)


def fold_offsets(k: int, d: int, f: int) -> list:
    """Distinct folded-row offsets used by a causal conv(k, dilation d)
    under time-fold f: all <= 0, ascending, ending at 0."""
    span = (k - 1) * d
    return sorted({(p + j * d - span) // f
                   for p in range(f) for j in range(k)})


def fold_conv_weight(w: torch.Tensor, dilation: int, f: int) -> torch.Tensor:
    """(k, C, C) tap weights [j][in][out] -> (n_offsets, f*C, f*C) folded
    weights: Wf[i, g*C:(g+1)*C, p*C:(p+1)*C] = w[j] for the (p, j) pairs
    whose source row offset is offsets[i] and source lane group is g."""
    k, c, c_out = w.shape
    if c != c_out:
        raise ValueError(f"square taps only, got {tuple(w.shape)}")
    span = (k - 1) * dilation
    offsets = fold_offsets(k, dilation, f)
    pos = {o: i for i, o in enumerate(offsets)}
    fc = f * c
    wf = w.new_zeros((len(offsets), fc, fc))
    for p in range(f):
        for j in range(k):
            o, g = divmod(p + j * dilation - span, f)
            wf[pos[o], g * c:(g + 1) * c, p * c:(p + 1) * c] = w[j]
    return wf


def fold_1x1_weight(w: torch.Tensor, f: int) -> torch.Tensor:
    """(1, C, C) -> block-diagonal (f*C, f*C)."""
    # torch.kron fails on some non-contiguous inputs
    return torch.kron(torch.eye(f, dtype=w.dtype, device=w.device),
                      w[0].contiguous())


def pick_tile(n_rows: int, target: int) -> int:
    """Largest divisor of n_rows that is <= target and a multiple of 16;
    falls back to any divisor."""
    for cand in range(min(target, n_rows), 15, -1):
        if n_rows % cand == 0 and cand % 16 == 0:
            return cand
    for cand in range(min(target, n_rows), 0, -1):
        if n_rows % cand == 0:
            return cand
    return n_rows


def padded_rows(t: int, f: int) -> int:
    """Folded rows after the TPU kernel's time padding: T is zero-padded to
    a multiple of align * f, align = 256 rows when T has at least 256 rows,
    else 16 (so the row count tiles into aligned blocks)."""
    n_rows0 = -(-t // f)
    align = 256 if n_rows0 >= 256 else 16
    return -(-n_rows0 // align) * align


def halo_rows(k: int, dilations, f: int, k2: int = 1) -> int:
    """h_total: the rows of left context a tile's window carries, the sum
    over the units of each conv's row span."""
    span2 = -fold_offsets(k2, 1, f)[0] if k2 > 1 else 0
    return sum(-fold_offsets(k, d, f)[0] + span2 for d in dilations)
