"""Causal 1-D convolutions, batch mode (counterpart of audiodec_tpu/ops/conv.py).

Activations are (B, C, T); params are {"w": weight, "b": bias (optional)}
with torch's weight orientation: conv (O, I, K), transposed conv (I, O, K).

  - causal conv:   left zero-pad by (K-1)*d, then a VALID conv
                   (ref: layers/conv_layer.py:148-151)
  - causal convT:  left *replication* pad by ceil(K/s)-1 frames, full
                   transposed conv, trim [s:-s]
                   (ref: layers/conv_layer.py:189-192)

Streaming state is not ported yet.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


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
