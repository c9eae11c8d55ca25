"""The folded stack's ablation variants: CUDA kernel wrapper and its plain
version.

Replaces the TPU kernel `tools/folded_ablate.py:34 build` (pallas_call at
`:138`) with `csrc/ablate_stack.cu`, counted in `launches`.  The function
is the autoencoder residual stack with bf16 dots (three units of ELU,
causal conv(7, d), ELU, 1x1 conv, plus the skip, no biases, zero before
t=0), in the TPU probe's five variants, which differ in how the k=7 conv's
products are summed (`VARIANTS`): "default" (in sequence), "tree"
(pairwise), "im2col" (one product over K = 7 * C), "noelu" (both ELUs
skipped) and "noshift" (every folded offset reads the window's first row,
a different function, defined on the TPU's fold of f = 128 // C samples
per row).  Rounding points: y1 = bf16(ELU(v)) with ELU computed in f32 as
exp(min(v, 0)) - 1; bf16 weights; f32 sums; a2 = bf16(ELU(acc));
v = v + a2 @ w2 in f32.

Layout (B, C, T) f32 with torch weights (C_out, C_in, k), as
`ops/kernels/folded_stack.py` takes them; T must be a multiple of f (the
TPU probe's reshape fails otherwise).  A CPU tensor runs
`ablate_stack_plain` (any C); a CUDA tensor launches the kernel (C <= 32)
or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch
import torch.nn.functional as F

from audiodec_tpu_torch.ops.activations import elu_exp
from audiodec_tpu_torch.ops.kernels import _build
from audiodec_tpu_torch.ops.kernels.fold import (
    fold_1x1_weight,
    fold_conv_weight,
    fold_factor,
    fold_offsets,
)

VARIANTS = ("default", "tree", "im2col", "noelu", "noshift")
KERNEL_SIZE = 7
UNITS = 3
MAX_CHANNELS = 32

launches = 0


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _check(x: torch.Tensor, unit_params: Sequence, dilations: Sequence[int],
           variant: str) -> int:
    """Validate the call; returns the fold f."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    if x.dim() != 3 or x.dtype != torch.float32:
        raise TypeError(f"x must be (B, C, T) float32, got "
                        f"{tuple(x.shape)} {x.dtype}")
    b, c, t = x.shape
    if len(unit_params) != len(dilations):
        raise ValueError("need one unit per dilation")
    for w1, w2 in unit_params:
        if (tuple(w1.shape) != (c, c, KERNEL_SIZE)
                or tuple(w2.shape) != (c, c, 1)):
            raise ValueError(f"unit weights {tuple(w1.shape)}, "
                             f"{tuple(w2.shape)} do not fit C={c}")
    f = fold_factor(c)
    if t % f:
        raise ValueError(f"T={t} is not a multiple of the fold f={f} "
                         f"(128 // C)")
    return f


def _pairwise(parts: list) -> torch.Tensor:
    """The TPU variant's tree: neighbours added pairwise, level by level."""
    while len(parts) > 1:
        nxt = [parts[i] + parts[i + 1] for i in range(0, len(parts) - 1, 2)]
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    return parts[0]


def ablate_stack_plain(x: torch.Tensor, unit_params: Sequence,
                       dilations: Sequence[int] = (1, 3, 9),
                       variant: str = "default") -> torch.Tensor:
    """The variant in plain torch ops in the TPU's folded layout:
    X (B, T/f, f*C) with X[b, r, p*C + c] = x[b, c, r*f + p], each unit a
    sum over its folded-row offsets of X[r + o] @ Wf_o, with the TPU
    kernel's rounding points.  On the card the caller turns TF32 off."""
    f = _check(x, unit_params, dilations, variant)
    b, c, t = x.shape
    rows, fc = t // f, f * c
    act = (lambda v: v) if variant == "noelu" else elu_exp
    v = x.permute(0, 2, 1).reshape(b, rows, fc)
    for (w1, w2), d in zip(unit_params, dilations):
        offs = fold_offsets(KERNEL_SIZE, d, f)
        span = -offs[0]
        wf = _bf16(fold_conv_weight(w1.float().permute(2, 1, 0), d, f))
        w11 = _bf16(fold_1x1_weight(w2.float().permute(2, 1, 0), f))
        y1 = F.pad(_bf16(act(v)), (0, 0, span, 0))   # zero rows before t=0
        starts = [0] * len(offs) if variant == "noshift" else \
            [o + span for o in offs]
        slices = [y1[:, s:s + rows] for s in starts]
        if variant == "im2col":
            acc = torch.cat(slices, dim=2) @ wf.reshape(len(offs) * fc, fc)
        elif variant == "tree":
            acc = _pairwise([sl @ wf[i] for i, sl in enumerate(slices)])
        else:
            acc = torch.zeros_like(v)
            for i, sl in enumerate(slices):
                acc = acc + sl @ wf[i]
        v = v + _bf16(act(acc)) @ w11
    return v.reshape(b, t, c).permute(0, 2, 1).contiguous()


def _pack(unit_params) -> tuple:
    """(3, 7, 32, 32) and (3, 32, 32) bf16 weights as [u][tap][c_out][c_in]
    and [u][c_out][c_in], zero-padded to 32 channels."""
    def pad(w):
        p = MAX_CHANNELS - w.shape[0]
        return F.pad(w.float(), (0, 0, 0, p, 0, p))

    w1 = torch.stack([pad(w).permute(2, 0, 1) for w, _ in unit_params])
    w2 = torch.stack([pad(w)[:, :, 0] for _, w in unit_params])
    return (w1.to(torch.bfloat16).contiguous(),
            w2.to(torch.bfloat16).contiguous())


@functools.cache
def _kernel():
    fn = _build.load("ablate_stack").ablate_stack_forward
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ablate_stack(x: torch.Tensor, unit_params: Sequence,
                 dilations: Sequence[int] = (1, 3, 9),
                 variant: str = "default") -> torch.Tensor:
    """x (B, C, T) f32, unit_params ((w1 (C, C, 7), w2 (C, C, 1)), ...) ->
    (B, C, T) f32 through the given variant."""
    global launches
    f = _check(x, unit_params, dilations, variant)
    if x.device.type == "cpu":
        return ablate_stack_plain(x, unit_params, dilations, variant)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    b, c, t = x.shape
    if c > MAX_CHANNELS or len(dilations) != UNITS:
        raise ValueError(f"the kernel takes C <= {MAX_CHANNELS} and "
                         f"{UNITS} units, got C={c} and {len(dilations)}")
    if any(w.device != x.device for u in unit_params for w in u):
        raise ValueError("weights must be on the device of x")
    x = x.contiguous()
    w1, w2 = _pack(unit_params)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _kernel()(x.data_ptr(), out.data_ptr(), w1.data_ptr(),
                        w2.data_ptr(), b, c, t, f, *dilations,
                        VARIANTS.index(variant),
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ablate stack kernel ({variant}): CUDA error "
                           f"{err}")
    launches += 1
    return out
