"""Block-packed causal convolutions (counterpart of
audiodec_tpu/archive/blocked.py), in the port's (B, C, T) layout.

Packing P = 128 // C time phases into the channel axis turns a stride-1
causal conv at C channels into a block-banded conv over (B, P*C, T/P):

    x_b[b, p*C + c, tb] = x[b, c, P*tb + p]
    y_b = conv1d(left-pad(x_b, kb - 1), W'),
    W'[s*C_out + o, p*C_in + c, m] = w[o, c, j]
        whenever  s + shift + j*d = m*P + p,   shift = L - (k-1)*d,
        L = ceil((k-1)*d / P) * P,  kb = L / P + 1

JAX uses it to fill the TPU's 128-wide matrix unit for the C = 32 and 64
residual stacks; it computes in plain XLA convs and has no Pallas kernel,
so the port computes it with plain `torch` convs (cuDNN on the card).  Each
output is the same sum of products as the flat conv's, taken in another
order, so the two agree to f32 rounding.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from audiodec_tpu_torch.models.autoencoder import _res_unit_apply


def pack_factor(channels: int, target: int = 128) -> int:
    """Largest P with P*C <= target (1 when C >= target)."""
    return max(1, target // max(channels, 1))


def pack_weights(w: torch.Tensor, dilation: int, p: int) -> torch.Tensor:
    """w: (C_out, C_in, K) -> W' (P*C_out, P*C_in, kb), the block-banded
    kernel of the blocked conv."""
    co, ci, k = w.shape
    span = (k - 1) * dilation
    L = math.ceil(span / p) * p
    shift = L - span
    wp = w.new_zeros((p * co, p * ci, L // p + 1))
    for s in range(p):
        for j in range(k):
            u = s + shift + j * dilation
            m, pp = u // p, u % p
            wp[s * co:(s + 1) * co, pp * ci:(pp + 1) * ci, m] = w[:, :, j]
    return wp


def block_time(x: torch.Tensor, p: int) -> torch.Tensor:
    """(B, C, T) -> (B, P*C, T/P).  T must be divisible by P."""
    b, c, t = x.shape
    return (x.reshape(b, c, t // p, p).permute(0, 3, 1, 2)
            .reshape(b, p * c, t // p))


def unblock_time(x: torch.Tensor, p: int) -> torch.Tensor:
    """(B, P*C, T/P) -> (B, C, T)."""
    b, pc, tb = x.shape
    return (x.reshape(b, p, pc // p, tb).permute(0, 2, 3, 1)
            .reshape(b, pc // p, tb * p))


def blocked_causal_conv1d(xb: torch.Tensor, w: torch.Tensor, *,
                          dilation: int, p: int,
                          b_bias=None) -> torch.Tensor:
    """A causal stride-1 conv in the blocked layout.  xb: (B, P*C_in, T/P);
    w: the flat (C_out, C_in, K) weight -> (B, P*C_out, T/P), equal to f32
    rounding to block_time(causal_conv1d(unblock_time(xb), w, d))."""
    wp = pack_weights(w, dilation, p)
    y = F.conv1d(F.pad(xb, (wp.shape[-1] - 1, 0)), wp)
    if b_bias is not None:
        y = y + b_bias.repeat(p)[:, None]
    return y


def blocked_res_stack(x: torch.Tensor, units, *, dilations, act,
                      target: int = 128) -> torch.Tensor:
    """A chain of causal residual units (act, conv(k, d), act, 1x1 conv,
    plus the skip) in the blocked layout.  x: (B, C, T); units: the
    blocks' {"conv1", "conv2"} param dicts.  At P = 1 the units run
    flat; T is zero-padded at the end to a multiple of P and trimmed
    back."""
    c = x.shape[1]
    p = pack_factor(c, target)
    if p == 1:
        for u, d in zip(units, dilations):
            x = _res_unit_apply(u, x, dilation=d, act=act)
        return x
    t = x.shape[-1]
    pad = (-t) % p
    xb = block_time(F.pad(x, (0, pad)), p)
    for u, d in zip(units, dilations):
        y = blocked_causal_conv1d(act(xb), u["conv1"]["w"], dilation=d, p=p,
                                  b_bias=u["conv1"].get("b"))
        y = blocked_causal_conv1d(act(y), u["conv2"]["w"], dilation=1, p=p,
                                  b_bias=u["conv2"].get("b"))
        xb = xb + y
    return unblock_time(xb, p)[..., :t]
