"""The folded stack's ablation variants: CUDA kernel wrapper and its plain
version.

Replaces the TPU kernel `tools/folded_ablate.py:34 build` (pallas_call at
`:138`) with `csrc/ablate_stack.cu`, counted in `launches` (one per wrapper
call).  The function is the autoencoder residual stack with bf16 dots
(three units of ELU, causal conv(7, d), ELU, 1x1 conv, plus the skip, no
biases, zero before t=0), in the TPU probe's five variants, which differ in
how the k=7 conv's products are summed (`VARIANTS`): "default" (in
sequence), "tree" (pairwise), "im2col" (one product over K = 7 * C),
"noelu" (both ELUs skipped) and "noshift" (every folded offset reads the
window's first row, a different function, defined on the TPU's fold of
f = max(1, 128 // C) samples per row).  Rounding points: y1 = bf16(ELU(s))
with ELU computed in f32 as exp(min(s, 0)) - 1; bf16 weights; f32 sums;
a2 = bf16(ELU(acc)); y2 = a2 @ w2 in f32; the residual as
`folded_stack.storage_residual`: s = v + y2 in f32 storage, and in bf16
storage s = bf16(v) + bf16(y2) in f32, of which the next unit's ELU reads
s and the stream and the output hold bf16(s).

Layout (B, C, T), f32 or bf16, with torch weights (C_out, C_in, k), as
`ops/kernels/folded_stack.py` takes them; any C; T must be a multiple of
f (the TPU probe's reshape fails otherwise).  A CPU tensor runs
`ablate_stack_plain`; a CUDA tensor launches the kernel (C <= 32: one CUDA
launch for the stack; above: one per unit, weights padded to a multiple
of 32 channels), which takes C up to what one block's shared memory holds
at one warp (`csrc/ablate_stack.cu`: 1312, im2col 576, at d <= 9), and
raises above it.
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
from audiodec_tpu_torch.ops.kernels.folded_stack import (
    cached_pack,
    storage_residual,
)

VARIANTS = ("default", "tree", "im2col", "noelu", "noshift")
KERNEL_SIZE = 7
UNITS = 3
# csrc/ablate_stack.cu: C <= NARROW_CHANNELS in one launch, padded to it;
# wider stacks padded to a multiple of WIDE_ALIGN
NARROW_CHANNELS = 32
WIDE_ALIGN = 32

launches = 0


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _check(x: torch.Tensor, unit_params: Sequence, dilations: Sequence[int],
           variant: str) -> int:
    """Validate the call; returns the fold f."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    if x.dim() != 3 or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be (B, C, T) float32 or bfloat16, got "
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
                       variant: str = "default", *,
                       exact_sums: bool = False) -> torch.Tensor:
    """The variant in plain torch ops in the TPU's folded layout:
    X (B, T/f, f*C) with X[b, r, p*C + c] = x[b, c, r*f + p], each unit a
    sum over its folded-row offsets of X[r + o] @ Wf_o, with the TPU
    kernel's rounding points.  noshift's row r reads the absolute row
    r - span at every offset (zero before t=0), so like the other variants
    it does not depend on the TPU's time tiles.  On the card the caller
    turns TF32 off.

    exact_sums: each conv's products summed in float64 and rounded to f32
    once, the rounding points kept: the function without the error of f32
    sums, which grows with C (chip_smoke.py holds the kernel to the plain
    version within that error)."""
    f = _check(x, unit_params, dilations, variant)
    b, c, t = x.shape
    rows, fc = t // f, f * c
    bf16 = x.dtype == torch.bfloat16
    sums = torch.float64 if exact_sums else torch.float32
    act = (lambda v: v) if variant == "noelu" else elu_exp
    v = x.float().permute(0, 2, 1).reshape(b, rows, fc)
    for (w1, w2), d in zip(unit_params, dilations):
        offs = fold_offsets(KERNEL_SIZE, d, f)
        span = -offs[0]
        wf = _bf16(fold_conv_weight(w1.float().permute(2, 1, 0), d, f))
        w11 = _bf16(fold_1x1_weight(w2.float().permute(2, 1, 0), f))
        wf, w11 = wf.to(sums), w11.to(sums)
        # zero rows before t=0
        y1 = F.pad(_bf16(act(v)), (0, 0, span, 0)).to(sums)
        starts = [0] * len(offs) if variant == "noshift" else \
            [o + span for o in offs]
        slices = [y1[:, s:s + rows] for s in starts]
        if variant == "im2col":
            acc = torch.cat(slices, dim=2) @ wf.reshape(len(offs) * fc, fc)
        elif variant == "tree":
            acc = _pairwise([sl @ wf[i] for i, sl in enumerate(slices)])
        else:
            acc = torch.zeros_like(slices[0])
            for i, sl in enumerate(slices):
                acc = acc + sl @ wf[i]
        y2 = _bf16(act(acc.float())).to(sums) @ w11
        v = storage_residual(v, y2.float(), bf16)
    return v.reshape(b, t, c).permute(0, 2, 1).to(x.dtype).contiguous()


def padded_channels(c: int) -> int:
    """The kernel's width for C channels: 32 at C <= 32, else C rounded up
    to a multiple of 32."""
    if c <= NARROW_CHANNELS:
        return NARROW_CHANNELS
    return -(-c // WIDE_ALIGN) * WIDE_ALIGN


def _pack(unit_params, c: int, cp: int, _rounded: bool) -> tuple:
    """(3, 7, cp, cp) and (3, cp, cp) bf16 weights as [u][tap][c_out][c_in]
    and [u][c_out][c_in], zero-padded from C to cp channels."""
    def pad(w):
        return F.pad(w.float(), (0, 0, 0, cp - c, 0, cp - c))

    w1 = torch.stack([pad(w).permute(2, 0, 1) for w, _ in unit_params])
    w2 = torch.stack([pad(w)[:, :, 0] for _, w in unit_params])
    return (w1.to(torch.bfloat16).contiguous(),
            w2.to(torch.bfloat16).contiguous())


def packed_weights(unit_params, c: int) -> tuple:
    """`_pack` at the kernel's width, cached on what the tensors hold."""
    weights = tuple(w for u in unit_params for w in u)
    return cached_pack(_pack, weights, c, padded_channels(c), True,
                       unit_params)


@functools.cache
def _kernel():
    fn = _build.load("ablate_stack").ablate_stack_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ablate_stack(x: torch.Tensor, unit_params: Sequence,
                 dilations: Sequence[int] = (1, 3, 9),
                 variant: str = "default") -> torch.Tensor:
    """x (B, C, T) f32 or bf16, unit_params ((w1 (C, C, 7), w2 (C, C, 1)),
    ...) -> (B, C, T) in x's dtype through the given variant."""
    global launches
    f = _check(x, unit_params, dilations, variant)
    if x.device.type == "cpu":
        return ablate_stack_plain(x, unit_params, dilations, variant)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    b, c, t = x.shape
    if len(dilations) != UNITS:
        raise ValueError(f"the kernel takes {UNITS} units, got "
                         f"{len(dilations)}")
    if any(w.device != x.device for u in unit_params for w in u):
        raise ValueError("weights must be on the device of x")
    x = x.contiguous()
    cp = padded_channels(c)
    w1, w2 = packed_weights(unit_params, c)
    out = torch.empty_like(x)
    # the residual carried between the wide route's per-unit launches
    scratch = (torch.empty((2, b, c, t), device=x.device,
                           dtype=torch.float32)
               if c > NARROW_CHANNELS else None)
    with torch.cuda.device(x.device):
        err = _kernel()(x.data_ptr(), out.data_ptr(), w1.data_ptr(),
                        w2.data_ptr(),
                        None if scratch is None else scratch.data_ptr(),
                        b, c, t, cp, f, *dilations, VARIANTS.index(variant),
                        int(x.dtype == torch.bfloat16),
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ablate stack kernel ({variant}, C={c}): CUDA "
                           f"error {err}")
    launches += 1
    return out
