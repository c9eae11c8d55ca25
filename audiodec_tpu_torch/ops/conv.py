"""Causal and noncausal 1-D convolutions, batch and streaming (counterpart
of audiodec_tpu/ops/conv.py).

Activations are (B, C, T); params are {"w": weight, "b": bias (optional)}
with torch's weight orientation: conv (O, I, K), transposed conv (I, O, K).

  - causal conv batch:   left zero-pad by (K-1)*d, then a VALID conv
                         (ref: layers/conv_layer.py:148-151)
  - causal conv stream:  concat(state, x), VALID conv, state := the last
                         (K-1)*d inputs (ref: layers/conv_layer.py:153-156)
  - causal convT batch:  left *replication* pad by ceil(K/s)-1 frames, full
                         transposed conv, trim [s:-s]
                         (ref: layers/conv_layer.py:189-192)
  - causal convT stream: concat(state, x) with a zero initial state, the
                         same conv and trim, state := the last ceil(K/s)-1
                         input frames (ref: layers/conv_layer.py:194-197).
                         Batch and streaming differ on the first frames
                         (replication against zeros), as in the reference.
  - noncausal conv:      symmetric zero pad (K-1)//2 * d
                         (ref: layers/conv_layer.py:35-74)
  - noncausal convT:     full transposed conv trimmed by padding=(s+1)//2
                         on the left and padding - output_padding on the
                         right, output_padding = s % 2
                         (ref: layers/conv_layer.py:77-115)

A streaming state is a tensor (B, C_in, L) in the package's layout, L the
number of past inputs the layer keeps; the JAX package keeps the same
numbers as (B, L, C_in) (utils/bridge.py `state_from_jax`, `state_to_jax`).
A conv with nothing to keep (L = 0) returns its state unchanged.

Initializers (`conv1d_init`, `conv_transpose1d_init`, `conv2d_init`, the
last (O, I, KH, KW) for the discriminators): the JAX package's shapes and
scale (normal at 0.01 unless given, zero bias) in torch's orientation, drawn
from an explicit `torch.Generator` on its device; the numbers differ from
JAX's, since the two frameworks' generators differ.
"""

from __future__ import annotations

import math
from typing import Optional

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


def conv2d_init(gen: torch.Generator, kernel_size, in_channels: int,
                out_channels: int, groups: int = 1, bias: bool = True,
                scale: float = INIT_SCALE) -> dict:
    """{'w': (C_out, C_in // groups, KH, KW) [, 'b': (C_out,)]}; an int
    kernel_size is square."""
    kh, kw = ((kernel_size, kernel_size) if isinstance(kernel_size, int)
              else kernel_size)
    p = {"w": scale * torch.randn(out_channels, in_channels // groups, kh,
                                  kw, generator=gen, device=gen.device)}
    if bias:
        p["b"] = torch.zeros(out_channels, device=gen.device)
    return p


def causal_state_init(batch: int, in_channels: int, kernel_size: int,
                      dilation: int = 1, dtype=torch.float32,
                      device=None) -> torch.Tensor:
    """Zero streaming state of a causal conv: (B, C_in, (K-1)*d)."""
    return torch.zeros(batch, in_channels, (kernel_size - 1) * dilation,
                       dtype=dtype, device=device)


def causal_transpose_state_init(batch: int, in_channels: int,
                                kernel_size: int, stride: int,
                                dtype=torch.float32,
                                device=None) -> torch.Tensor:
    """Zero streaming state of a causal transposed conv:
    (B, C_in, ceil(K/s)-1)."""
    return torch.zeros(batch, in_channels,
                       math.ceil(kernel_size / stride) - 1, dtype=dtype,
                       device=device)


def _with_state(x, state, pad: int):
    """(state ++ x, the new state: its last `pad` frames)."""
    if pad == 0:
        return x, state
    xc = torch.cat([state, x], dim=-1)
    return xc, xc[..., xc.shape[-1] - pad:]


def causal_conv1d(x: torch.Tensor, params: dict, *, stride: int = 1,
                  dilation: int = 1, groups: int = 1,
                  state: Optional[torch.Tensor] = None):
    """Causal conv of x (B, C_in, T).  Batch mode (state None) returns y;
    streaming mode prepends `state` and returns (y, new_state)."""
    w = params["w"]
    pad = (w.shape[-1] - 1) * dilation
    if state is None:
        return F.conv1d(F.pad(x, (pad, 0)), w, params.get("b"),
                        stride=stride, dilation=dilation, groups=groups)
    xc, new_state = _with_state(x, state, pad)
    return F.conv1d(xc, w, params.get("b"), stride=stride,
                    dilation=dilation, groups=groups), new_state


def causal_conv_transpose1d(x: torch.Tensor, params: dict, *, stride: int,
                            state: Optional[torch.Tensor] = None):
    """Causal transposed conv of x (B, C_in, T): replication pad in batch
    mode, the carried state (zeros at first) in streaming mode, which
    returns (y, new_state)."""
    w = params["w"]
    pad = math.ceil(w.shape[-1] / stride) - 1
    if state is None:
        if pad > 0:
            x = torch.cat([x[..., :1].expand(-1, -1, pad), x], dim=-1)
        new_state = None
    else:
        x, new_state = _with_state(x, state, pad)
    # padding=stride drops `stride` outputs at each end of the full
    # transposed conv: the [s:-s] trim, with a contiguous result
    y = F.conv_transpose1d(x, w, params.get("b"), stride=stride,
                           padding=stride)
    return y if state is None else (y, new_state)


def noncausal_conv1d(x: torch.Tensor, params: dict, *, stride: int = 1,
                     dilation: int = 1) -> torch.Tensor:
    """Symmetric-pad conv of x (B, C_in, T), padding (K-1)//2 * d, as
    torch's Conv1d in the reference."""
    w = params["w"]
    return F.conv1d(x, w, params.get("b"), stride=stride,
                    padding=(w.shape[-1] - 1) // 2 * dilation,
                    dilation=dilation)


def noncausal_conv_transpose1d(x: torch.Tensor, params: dict, *,
                               stride: int) -> torch.Tensor:
    """Symmetric transposed conv of x (B, C_in, T), with the JAX package's
    padding (s+1)//2 and output_padding s % 2: the full transposed conv's
    outputs from s//2 + s % 2 up to s//2 before its end."""
    s = stride
    y = F.conv_transpose1d(x, params["w"], params.get("b"), stride=s,
                           padding=s // 2)
    return y[..., s % 2:]
