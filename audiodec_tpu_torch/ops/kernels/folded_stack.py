"""Fused causal residual stack: CUDA kernel wrappers and their plain version.

Replaces the TPU kernel `audiodec_tpu/ops/pallas/folded_stack.py:112
folded_residual_stack` in two of its modes, each with its own CUDA kernel:

  - autoencoder mode (ELU, k=7, 1x1 second conv, no biases):
    `csrc/folded_stack.cu`, counted in `launches`;
  - vocoder mode (the HiFiGAN resblock units: LeakyReLU with slope
    `act_param`, second conv with k2 = k taps, optional biases, k in
    {3, 7, 11}): `csrc/resblock_stack.cu`, counted in `resblock_launches`.

The int8 mode is not ported and raises NotImplementedError.

Bound on the H100 (one read and one write of the activation against the
dots' FLOP on the bf16 tensor cores at 989 TFLOP/s):
  - autoencoder mode at (16, 480000, 32): 1.97 GB in f32, 0.98 GB in bf16,
    against 3 * (7 + 1) * 32 * 32 * 2 FLOP per sample (3.8e11);
  - vocoder mode at AD v1's (16, 480000, 32) bf16: 0.98 GB (0.29 ms)
    against 3 * (11 + 11) * 32 * 32 * 2 FLOP per sample (1.04e12, 1.05 ms),
    so it is bound by operations.
Both kernels multiply on the f32 FMA units (67 TFLOP/s), so both are bound
by operations.  Their design keeps the units of a time tile and the tile's
left halo in shared memory, so device memory sees the activation read once
(plus the halo) and written once; see the notes in the CUDA sources.

Numerics follow the TPU kernel (`folded_stack.py:344-371`): the activation
is computed in f32; with `bf16_dots` (or bf16 storage) the dot operands are
rounded to bf16; products are summed in f32; a bias is added in f32 to the
f32 sum before the next activation, and each conv's output is exactly zero
before t=0; the residual is rounded to the storage dtype after every unit.
`bf16_dots=False` with f32 storage is true f32.  The plain version zero-pads
each conv's input, which gives the t < 0 semantics by construction.

Layout (B, C, T).  A CPU tensor runs `folded_residual_stack_plain`; a CUDA
tensor launches the mode's kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from audiodec_tpu_torch.ops.kernels import _build

KERNEL_SIZE = 7
RESBLOCK_KERNEL_SIZES = (3, 7, 11)
MAX_UNITS = 3
PADDED_CHANNELS = (4, 8, 16, 32)

launches = 0            # autoencoder mode, csrc/folded_stack.cu
resblock_launches = 0   # vocoder mode, csrc/resblock_stack.cu


def res_stack_params(block_params: dict) -> Tuple:
    """((w1, w2), ...) from an encoder/decoder block's 'res' list."""
    return tuple((u["conv1"]["w"], u["conv2"]["w"])
                 for u in block_params["res"])


def _activation(act: str, act_param: float):
    if act == "elu":
        return F.elu
    if act == "leaky_relu":
        return lambda v: F.leaky_relu(v, act_param)
    raise NotImplementedError(f"folded stack activation {act!r}")


def folded_residual_stack_plain(x: torch.Tensor, unit_params: Sequence,
                                dilations: Sequence[int],
                                bf16_dots: bool = True, *, act: str = "elu",
                                act_param: float = 0.0,
                                biases=None) -> torch.Tensor:
    """The stack as an F.conv1d chain with the kernels' rounding points."""
    rounded = bf16_dots or x.dtype == torch.bfloat16
    fn = _activation(act, act_param)

    def operand(t):
        t = t.float()
        return t.to(torch.bfloat16).float() if rounded else t

    v = x
    for j, ((w1, w2), d) in enumerate(zip(unit_params, dilations)):
        a = operand(fn(v.float()))
        acc = F.conv1d(F.pad(a, ((w1.shape[-1] - 1) * d, 0)), operand(w1),
                       dilation=d)
        if biases is not None:
            acc = acc + biases[j][0].float()[:, None]
        m = operand(fn(acc))
        y2 = F.conv1d(F.pad(m, (w2.shape[-1] - 1, 0)), operand(w2))
        if biases is not None:
            y2 = y2 + biases[j][1].float()[:, None]
        v = v + y2.to(v.dtype)
    return v


@functools.cache
def _kernel():
    fn = _build.load("folded_stack").folded_stack_forward
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _resblock_kernel():
    fn = _build.load("resblock_stack").resblock_stack_forward
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                   + [ctypes.c_float] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _pack_convs(ws, c: int, cp: int, rounded: bool) -> torch.Tensor:
    """Torch (C, C, K) conv weights -> (n, K, cp, cp) [u][k][i][o], f32,
    zero-padded from C to cp channels."""
    w = torch.stack([F.pad(w.float().permute(2, 1, 0), (0, cp - c, 0, cp - c))
                     for w in ws])
    if rounded:
        w = w.to(torch.bfloat16).float()
    return w.contiguous()


def _pack_weights(unit_params, c: int, cp: int, rounded: bool):
    """Autoencoder mode: (n, K, cp, cp) [u][k][i][o] and (n, cp, cp)
    [u][i][o] (the 1x1 conv's single tap), f32."""
    w1 = _pack_convs([w for w, _ in unit_params], c, cp, rounded)
    w2 = _pack_convs([w for _, w in unit_params], c, cp, rounded)
    return w1, w2[:, 0].contiguous()


def _pack_resblock(unit_params, biases, c: int, cp: int, rounded: bool):
    """Vocoder mode: (n, K, cp, cp) twice and the biases as (n, 2, cp) f32
    (never rounded: the TPU kernel adds them in f32), or None."""
    w1 = _pack_convs([w for w, _ in unit_params], c, cp, rounded)
    w2 = _pack_convs([w for _, w in unit_params], c, cp, rounded)
    if biases is None:
        return w1, w2, None
    b = torch.stack([torch.stack([F.pad(b1.float(), (0, cp - c)),
                                  F.pad(b2.float(), (0, cp - c))])
                     for b1, b2 in biases])
    return w1, w2, b.contiguous()


# packed weights by what the weight tensors hold (device, dtype, address,
# shape, strides, version) and the rounding: two views of one storage at
# one offset hold the same values, so the per-group weight slices of a
# grouped resblock, made anew on every call, hit the cache.  An entry holds
# its tensors, so their storage cannot be freed and its address reused
# while it lives, and an in-place update bumps the version and misses.
_packed = {}
_PACKED_MAX = 16


def _cached_pack(pack, tensors, c: int, cp: int, rounded: bool, *args):
    key = (pack.__name__, rounded,
           tuple((w.device, w.dtype, w.data_ptr(), tuple(w.shape), w.stride(),
                  w._version) for w in tensors))
    hit = _packed.get(key)
    if hit is None:
        if len(_packed) >= _PACKED_MAX:
            del _packed[next(iter(_packed))]
        hit = _packed[key] = (tensors, pack(*args, c, cp, rounded))
    return hit[1]


def _packed_weights(unit_params, c: int, cp: int, rounded: bool):
    weights = tuple(w for u in unit_params for w in u)
    return _cached_pack(_pack_weights, weights, c, cp, rounded, unit_params)


def _packed_resblock(unit_params, biases, c: int, cp: int, rounded: bool):
    tensors = tuple(w for u in unit_params for w in u)
    if biases is not None:
        tensors += tuple(b for u in biases for b in u)
    return _cached_pack(_pack_resblock, tensors, c, cp, rounded,
                        unit_params, biases)


def _mode(kernel_size, kernel_size2, act, act_param, biases,
          int8_dots) -> str:
    """'autoencoder' or 'vocoder', the two ported modes; raises on the rest."""
    if not int8_dots:
        if (act == "elu" and not act_param and biases is None
                and kernel_size == KERNEL_SIZE and kernel_size2 == 1):
            return "autoencoder"
        if (act == "leaky_relu" and kernel_size in RESBLOCK_KERNEL_SIZES
                and kernel_size2 == kernel_size):
            return "vocoder"
    raise NotImplementedError(
        "folded_residual_stack is ported for the autoencoder units (ELU, "
        "k=7, k2=1, no biases) and the vocoder units (LeakyReLU, k=k2 in "
        f"{RESBLOCK_KERNEL_SIZES}, optional biases), not int8 dots; got "
        f"act={act!r}, k={kernel_size}, k2={kernel_size2}, "
        f"biases={biases is not None}, int8_dots={int8_dots}")


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
    unit_params: ((w1 (C, C, k), w2 (C, C, k2)), ...), one per dilation;
    biases: None or ((b1 (C,), b2 (C,)), ...)."""
    global launches, resblock_launches
    mode = _mode(kernel_size, kernel_size2, act, act_param, biases, int8_dots)
    if x.dim() != 3 or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be (B, C, T) float32 or bfloat16, got "
                        f"{tuple(x.shape)} {x.dtype}")
    b, c, t = x.shape
    n = len(dilations)
    if len(unit_params) != n or not 1 <= n <= MAX_UNITS:
        raise ValueError(f"need 1..{MAX_UNITS} units, one per dilation")
    for w1, w2 in unit_params:
        if (tuple(w1.shape) != (c, c, kernel_size)
                or tuple(w2.shape) != (c, c, kernel_size2)):
            raise ValueError(f"unit weights {tuple(w1.shape)}, "
                             f"{tuple(w2.shape)} do not fit C={c}")
    if biases is not None and (
            len(biases) != n
            or any(tuple(bb.shape) != (c,) for u in biases for bb in u)):
        raise ValueError(f"need one (b1 ({c},), b2 ({c},)) per unit")
    if x.device.type == "cpu":
        return folded_residual_stack_plain(
            x, unit_params, dilations, bf16_dots, act=act,
            act_param=act_param, biases=biases)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if c > PADDED_CHANNELS[-1]:
        raise ValueError(f"the kernels take C <= {PADDED_CHANNELS[-1]}, "
                         f"got {c}")
    tensors = [w for u in unit_params for w in u]
    tensors += [bb for u in biases for bb in u] if biases is not None else []
    if any(w.device != x.device for w in tensors):
        raise ValueError("weights must be on the device of x")
    cp = next(p for p in PADDED_CHANNELS if c <= p)
    rounded = bf16_dots or x.dtype == torch.bfloat16
    storage_bf16 = int(x.dtype == torch.bfloat16)
    dil = list(dilations) + [0] * (MAX_UNITS - n)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if mode == "autoencoder":
            w1, w2 = _packed_weights(unit_params, c, cp, rounded)
            err = _kernel()(
                x.data_ptr(), out.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                b, c, t, cp, n, *dil, int(rounded), storage_bf16, stream)
        else:
            w1, w2, bias = _packed_resblock(unit_params, biases, c, cp,
                                            rounded)
            err = _resblock_kernel()(
                x.data_ptr(), out.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                None if bias is None else bias.data_ptr(),
                b, c, t, cp, kernel_size, n, *dil, float(act_param),
                int(rounded), storage_bf16, stream)
    if err != 0:
        raise RuntimeError(f"{mode}-mode residual stack kernel: CUDA error "
                           f"{err}")
    if mode == "autoencoder":
        launches += 1
    else:
        resblock_launches += 1
    return out
