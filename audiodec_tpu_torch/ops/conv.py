"""Causal 1-D convolutions, batch mode (counterpart of audiodec_tpu/ops/conv.py).

Activations are (B, C, T); params are {"w": weight, "b": bias (optional)}
with torch's weight orientation: conv (O, I, K), transposed conv (I, O, K).

  - causal conv:   left zero-pad by (K-1)*d, then a VALID conv
                   (ref: layers/conv_layer.py:148-151)
  - causal convT:  left *replication* pad by ceil(K/s)-1 frames, full
                   transposed conv, trim [s:-s]
                   (ref: layers/conv_layer.py:189-192)

Initializers (`conv1d_init`, `conv_transpose1d_init`): the JAX package's
shapes and scale (normal at 0.01, zero bias) in torch's orientation, drawn
from an explicit `torch.Generator` on its device; the numbers differ from
JAX's, since the two frameworks' generators differ.

Streaming state is not ported yet.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

INIT_SCALE = 0.01  # the JAX package's conv1d_init / conv_transpose1d_init


def conv1d_init(gen: torch.Generator, kernel_size: int, in_channels: int,
                out_channels: int, groups: int = 1, bias: bool = True,
                scale: float = INIT_SCALE) -> dict:
    """{'w': (C_out, C_in // groups, K) [, 'b': (C_out,)]}."""
    p = {"w": scale * torch.randn(out_channels, in_channels // groups,
                                  kernel_size, generator=gen,
                                  device=gen.device)}
    if bias:
        p["b"] = torch.zeros(out_channels, device=gen.device)
    return p


def conv_transpose1d_init(gen: torch.Generator, kernel_size: int,
                          in_channels: int, out_channels: int,
                          bias: bool = True,
                          scale: float = INIT_SCALE) -> dict:
    """{'w': (C_in, C_out, K) [, 'b': (C_out,)]}."""
    p = {"w": scale * torch.randn(in_channels, out_channels, kernel_size,
                                  generator=gen, device=gen.device)}
    if bias:
        p["b"] = torch.zeros(out_channels, device=gen.device)
    return p


def causal_conv1d(x: torch.Tensor, params: dict, *, stride: int = 1,
                  dilation: int = 1, groups: int = 1) -> torch.Tensor:
    w = params["w"]
    pad = (w.shape[-1] - 1) * dilation
    return F.conv1d(F.pad(x, (pad, 0)), w, params.get("b"), stride=stride,
                    dilation=dilation, groups=groups)


def causal_conv_transpose1d(x: torch.Tensor, params: dict, *,
                            stride: int) -> torch.Tensor:
    w = params["w"]
    pad = math.ceil(w.shape[-1] / stride) - 1
    if pad > 0:
        x = torch.cat([x[..., :1].expand(-1, -1, pad), x], dim=-1)
    # padding=stride drops `stride` outputs at each end of the full
    # transposed conv: the [s:-s] trim, with a contiguous result
    return F.conv_transpose1d(x, w, params.get("b"), stride=stride,
                              padding=stride)
