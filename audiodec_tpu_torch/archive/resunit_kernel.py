"""Per-tap fused causal residual stack in true f32 (counterpart of
audiodec_tpu/archive/resunit_kernel.py, the TPU kernel
`fused_residual_stack`, pallas_call at :118).

A stack is the units v += conv1x1(ELU(conv_k_dil_d(ELU(v)))), one per
dilation, any k and any number of units, with zero left context at t=0 and
no biases; ELU is the TPU kernel's exp(min(v, 0)) - 1 whatever the config
names (`:34-37`).  The TPU kernel works in f32 whatever it is given
(`:94`); here the input must be f32 and the output is f32.

On a CUDA tensor one wrapper call runs csrc/resunit_stack.cu through
`ops/kernels/folded_stack.py resunit_stack` (which the folded stack's
true-f32 route also takes), one CUDA launch per unit (both convs of the
unit in one block, a2 in shared memory), counted once in `launches`; on a
CPU tensor it runs `fused_residual_stack_plain`.  The TPU kernel's time
tiles and their materialized windows (`_windowed`, `:40-52`) and the
archived wrappers' tile choice (`fast_experiments.py:21-25`) are VMEM
workarounds and are not ported.

Bound on the H100: per stack 2 * (k + 1) * C^2 FLOP per sample and unit
(48 C^2 for k = 7 and three units) on the f32 FMA units (67 TFLOP/s;
TF32 is not the TPU kernel's arithmetic) against one read and one write of
the activation (8 bytes per sample and channel): bound by operations at
every width, 5.63 / 7.51 / 7.51 / 6.01 ms at the symAD stacks (16, T, C) =
(16, 480000, 32), (16, 160000, 64), (16, 40000, 128), (16, 8000, 256)
(bin/kernel_bounds.py).  See the note in the CUDA source for the design.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from audiodec_tpu_torch.ops.activations import elu_exp
from audiodec_tpu_torch.ops.kernels.folded_stack import (  # noqa: F401
    res_stack_params,
    resunit_stack,
)

DEFAULT_TILE_T = 1024

launches = 0            # wrapper calls that ran csrc/resunit_stack.cu


def fused_residual_stack_plain(x: torch.Tensor, unit_params: Sequence,
                               dilations: Sequence[int]) -> torch.Tensor:
    """The stack as F.conv1d calls with the TPU kernel's ELU, in f32.
    x: (B, C, T)."""
    v = x
    for (w1, w2), d in zip(unit_params, dilations):
        a = F.pad(elu_exp(v), ((w1.shape[-1] - 1) * d, 0))
        acc = F.conv1d(a, w1.float(), dilation=d)
        v = v + F.conv1d(elu_exp(acc), w2.float())
    return v


def fused_residual_stack_bct(x: torch.Tensor, unit_params: Sequence, *,
                             dilations: Sequence[int] = (1, 3, 9),
                             kernel_size: int = 7) -> torch.Tensor:
    """The stack in the package's (B, C, T) layout: the entry that
    `encoder_bct` / `decoder_bct` take as their residual-stack callback.
    x: (B, C, T) float32; unit_params: ((w1 (C, C, k), w2 (C, C, 1)), ...),
    torch's (O, I, K) orientation, one unit per dilation."""
    global launches
    if x.dim() != 3 or x.dtype != torch.float32:
        raise TypeError(f"x must be (B, C, T) float32, got "
                        f"{tuple(x.shape)} {x.dtype}")
    b, c, t = x.shape
    if len(unit_params) != len(dilations):
        raise ValueError("need one unit per dilation")
    for w1, w2 in unit_params:
        if (tuple(w1.shape) != (c, c, kernel_size)
                or tuple(w2.shape) != (c, c, 1)):
            raise ValueError(f"unit weights {tuple(w1.shape)}, "
                             f"{tuple(w2.shape)} do not fit C={c}, "
                             f"k={kernel_size}")
    if x.device.type == "cpu":
        return fused_residual_stack_plain(x, unit_params, dilations)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if any(w.device != x.device for u in unit_params for w in u):
        raise ValueError("weights must be on the device of x")
    if kernel_size < 1 or not dilations or min(dilations) < 1:
        raise ValueError(f"need k >= 1 and dilations >= 1, got k="
                         f"{kernel_size}, dilations={tuple(dilations)}")
    v = resunit_stack(x.contiguous(), unit_params, dilations, act="elu_exp",
                      shape=f"k={kernel_size}, dilations={tuple(dilations)}")
    launches += 1
    return v


def fused_residual_stack(x: torch.Tensor, unit_params: Sequence, *,
                         dilations: Sequence[int] = (1, 3, 9),
                         kernel_size: int = 7,
                         tile_t: int = DEFAULT_TILE_T) -> torch.Tensor:
    """Chain of causal residual units in JAX's layout.  x: (B, T, C)
    float32 -> (B, T, C) float32; unit_params: ((w1 (C, C, k),
    w2 (C, C, 1)), ...), the port's param-tree weights in torch's
    (O, I, K) orientation, one unit per dilation (`res_stack_params` of a
    block).  Any T; `tile_t` is kept for the JAX signature and changes
    nothing: the TPU kernel's time tile is a VMEM workaround."""
    del tile_t
    out = fused_residual_stack_bct(x.transpose(1, 2).contiguous(),
                                   unit_params, dilations=dilations,
                                   kernel_size=kernel_size)
    return out.transpose(1, 2)
