"""Fused causal residual stack: CUDA kernel wrapper and its plain version.

Replaces the TPU kernel `audiodec_tpu/ops/pallas/folded_stack.py:112
folded_residual_stack` in its autoencoder mode (ELU, k=7, 1x1 second conv,
no biases).  The kernel is `csrc/folded_stack.cu`.

Bound on the H100, at the main path's (16, 480000, 32): one read and one
write of the activation (1.97 GB in f32, 0.98 GB in bf16) against
3.8e11 FLOP.  With bf16 operands on the tensor cores the f32 stack would be
bound by its bytes; the first kernel multiplies on the f32 FMA units, so it
is bound by operations.  Its design keeps the three units of a time tile
and their 78-sample left halo in shared memory, so device memory sees only
that one read and one write.

Numerics follow the TPU kernel: with `bf16_dots` (or bf16 storage) the dot
operands are rounded to bf16 and the products summed in f32; the residual
is rounded to the storage dtype after every unit.  `bf16_dots=False` with
f32 storage is true f32.

Layout (B, C, T).  A CPU tensor runs `folded_residual_stack_plain`; a CUDA
tensor launches the kernel or raises.  `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from audiodec_tpu_torch.ops.kernels import _build

KERNEL_SIZE = 7
MAX_UNITS = 3
PADDED_CHANNELS = (4, 8, 16, 32)

launches = 0


def res_stack_params(block_params: dict) -> Tuple:
    """((w1, w2), ...) from an encoder/decoder block's 'res' list."""
    return tuple((u["conv1"]["w"], u["conv2"]["w"])
                 for u in block_params["res"])


def folded_residual_stack_plain(x: torch.Tensor, unit_params: Sequence,
                                dilations: Sequence[int],
                                bf16_dots: bool = True) -> torch.Tensor:
    """The stack as an F.conv1d chain with the kernel's rounding points."""
    rounded = bf16_dots or x.dtype == torch.bfloat16

    def operand(t):
        t = t.float()
        return t.to(torch.bfloat16).float() if rounded else t

    v = x
    for (w1, w2), d in zip(unit_params, dilations):
        a = operand(F.elu(v.float()))
        pad = (w1.shape[-1] - 1) * d
        acc = F.conv1d(F.pad(a, (pad, 0)), operand(w1), dilation=d)
        y2 = F.conv1d(operand(F.elu(acc)), operand(w2))
        v = v + y2.to(v.dtype)
    return v


@functools.cache
def _kernel():
    fn = _build.load("folded_stack").folded_stack_forward
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _pack_weights(unit_params, c: int, cp: int, rounded: bool):
    """(n, K, cp, cp) [u][k][i][o] and (n, cp, cp) [u][i][o], f32."""
    w1 = torch.stack([F.pad(w.float().permute(2, 1, 0), (0, cp - c, 0, cp - c))
                      for w, _ in unit_params])
    w2 = torch.stack([F.pad(w[:, :, 0].float().t(), (0, cp - c, 0, cp - c))
                      for _, w in unit_params])
    if rounded:
        w1 = w1.to(torch.bfloat16).float()
        w2 = w2.to(torch.bfloat16).float()
    return w1.contiguous(), w2.contiguous()


# packed weights by (ids and versions of the weight tensors, rounding); an
# entry holds its weight tensors, so their ids cannot be reused while it
# lives, and an in-place update bumps a version and misses
_packed = {}
_PACKED_MAX = 16


def _packed_weights(unit_params, c: int, cp: int, rounded: bool):
    weights = tuple(w for u in unit_params for w in u)
    key = (tuple(id(w) for w in weights),
           tuple(w._version for w in weights), rounded)
    hit = _packed.get(key)
    if hit is None:
        if len(_packed) >= _PACKED_MAX:
            del _packed[next(iter(_packed))]
        hit = _packed[key] = (weights,
                              *_pack_weights(unit_params, c, cp, rounded))
    return hit[1], hit[2]


def folded_residual_stack(x: torch.Tensor, unit_params: Sequence, *,
                          dilations: Sequence[int] = (1, 3, 9),
                          kernel_size: int = KERNEL_SIZE,
                          kernel_size2: int = 1,
                          act: str = "elu",
                          act_param: float = 0.0,
                          biases=None,
                          bf16_dots: bool = True,
                          int8_dots: bool = False) -> torch.Tensor:
    """Chain of causal residual units, batch mode.  x: (B, C, T) f32 or bf16;
    unit_params: ((w1 (C, C, 7), w2 (C, C, 1)), ...), one per dilation."""
    global launches
    if (act != "elu" or act_param or biases is not None or kernel_size2 != 1
            or int8_dots or kernel_size != KERNEL_SIZE):
        raise NotImplementedError(
            "folded_residual_stack is ported for the autoencoder units only "
            "(ELU, k=7, k2=1, no biases, no int8 dots)")
    if x.dim() != 3 or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be (B, C, T) float32 or bfloat16, got "
                        f"{tuple(x.shape)} {x.dtype}")
    b, c, t = x.shape
    n = len(dilations)
    if len(unit_params) != n or not 1 <= n <= MAX_UNITS:
        raise ValueError(f"need 1..{MAX_UNITS} units, one per dilation")
    for w1, w2 in unit_params:
        if (tuple(w1.shape) != (c, c, kernel_size)
                or tuple(w2.shape) != (c, c, 1)):
            raise ValueError(f"unit weights {tuple(w1.shape)}, "
                             f"{tuple(w2.shape)} do not fit C={c}")
    if x.device.type == "cpu":
        return folded_residual_stack_plain(x, unit_params, dilations,
                                           bf16_dots)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if c > PADDED_CHANNELS[-1]:
        raise ValueError(f"the kernel takes C <= {PADDED_CHANNELS[-1]}, "
                         f"got {c}")
    if any(w.device != x.device for u in unit_params for w in u):
        raise ValueError("weights must be on the device of x")
    cp = next(p for p in PADDED_CHANNELS if c <= p)
    rounded = bf16_dots or x.dtype == torch.bfloat16
    w1, w2 = _packed_weights(unit_params, c, cp, rounded)
    dil = list(dilations) + [0] * (MAX_UNITS - n)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _kernel()(
            x.data_ptr(), out.data_ptr(), w1.data_ptr(), w2.data_ptr(),
            b, c, t, cp, n, *dil, int(rounded),
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"folded_stack_forward: CUDA error {err}")
    launches += 1
    return out
