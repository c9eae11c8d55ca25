"""Fused causal residual stack: CUDA kernel wrappers and their plain version.

Replaces the TPU kernel `audiodec_tpu/ops/pallas/folded_stack.py:112
folded_residual_stack` in three of its modes, each with its own CUDA kernel:

  - autoencoder mode (ELU, k=7, 1x1 second conv, no biases):
    `csrc/folded_stack.cu`, counted in `launches`;
  - vocoder mode (the HiFiGAN resblock units: LeakyReLU with slope
    `act_param`, second conv with k2 = k taps, optional biases, k in
    {3, 7, 11}): `csrc/resblock_stack.cu`, counted in `resblock_launches`;
  - int8 mode (`int8_dots`, "row" activation scales; the autoencoder units
    at any C from 4 to 256, f32 storage): `csrc/int8_stack.cu`, counted in
    `int8_launches`.  Its arithmetic is set out at
    `folded_residual_stack_int8_plain`.

The TPU kernel's "tile" activation scales (`int8_scale="tile"`) are not
ported.

Bound on the H100 (one read and one write of the activation against the
dots' FLOP on the bf16 tensor cores at 989 TFLOP/s):
  - autoencoder mode at (16, 480000, 32): 1.97 GB in f32, 0.98 GB in bf16,
    against 3 * (7 + 1) * 32 * 32 * 2 FLOP per sample (3.8e11);
  - vocoder mode at AD v1's (16, 480000, 32) bf16: 0.98 GB (0.29 ms)
    against 3 * (11 + 11) * 32 * 32 * 2 FLOP per sample (1.04e12, 1.05 ms),
    so it is bound by operations;
  - int8 mode at the symAD decoder's stacks: see csrc/int8_stack.cu
    (0.203-0.587 ms against the int8 tensor cores' 1979 TOP/s).
The first two kernels multiply on the f32 FMA units (67 TFLOP/s), the int8
kernel with __dp4a on the CUDA cores, so all three are bound by their
products' rate.  The first two keep all units of a time tile and the tile's
left halo in shared memory, so device memory sees the activation read once
(plus the halo) and written once; the int8 kernel makes one pass per unit.
See the notes in the CUDA sources.

Numerics follow the TPU kernel (`folded_stack.py:344-371`): the activation
is computed in f32; with `bf16_dots` (or bf16 storage) the dot operands are
rounded to bf16; products are summed in f32; a bias is added in f32 to the
f32 sum before the next activation, and each conv's output is exactly zero
before t=0; the residual is rounded to the storage dtype after every unit.
`bf16_dots=False` with f32 storage is true f32.  The plain version zero-pads
each conv's input, which gives the t < 0 semantics by construction.

Layout (B, C, T).  A CPU tensor runs `folded_residual_stack_plain` (in the
int8 mode `folded_residual_stack_int8_plain`); a CUDA tensor launches the
mode's kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from audiodec_tpu_torch.ops.activations import elu_exp
from audiodec_tpu_torch.ops.kernels import _build
from audiodec_tpu_torch.ops.kernels.fold import fold_factor, fold_offsets

KERNEL_SIZE = 7
RESBLOCK_KERNEL_SIZES = (3, 7, 11)
MAX_UNITS = 3
PADDED_CHANNELS = (4, 8, 16, 32)

INT8_CHANNELS = (4, 256)
INT8_QMAX = 127.0

launches = 0            # autoencoder mode, csrc/folded_stack.cu
resblock_launches = 0   # vocoder mode, csrc/resblock_stack.cu
int8_launches = 0       # int8 mode, csrc/int8_stack.cu


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


# ---------------------------------------------------------------------------
# int8 mode, plain version
# ---------------------------------------------------------------------------

# samples per folded row: the TPU kernel folds F = 128 // C samples into
# its 128 lanes, and its activation scales are per folded row
int8_fold = fold_factor


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    # a true f32 division: with a Python divisor PyTorch may multiply by
    # the divisor's reciprocal, which rounds differently from JAX's division
    return a / torch.full_like(a, b)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c in f32 with one rounding, as the CUDA kernel's fmaf and
    XLA's compilation of the TPU kernel's multiply-adds compute it: the f64
    product of two f32 values is exact."""
    return (a.double() * b.double() + c.double()).float()


def int8_weight_scales(w: torch.Tensor):
    """(C_out, C_in, k) weights -> (integer-valued f32 weights in
    [-127, 127], per-output-channel f32 scales).  The TPU kernel takes the
    absmax of an output lane over all folded offset planes; every lane
    (p, c) sees all k taps of output channel c, so this is per channel."""
    w = w.float()
    s = _div(torch.clamp(w.abs().amax(dim=(1, 2)), min=1e-12), INT8_QMAX)
    return torch.round(w / s[:, None, None]), s


def _quantize_rows(y: torch.Tensor, f: int):
    """(B, C, Tp) f32 -> (integer-valued q, dequant scale per folded row
    (B, Tp // f)): s = max|y| over the row's f samples x C channels,
    q = round(y * (127 / s)), dequant s * (1 / 127)."""
    b, c, tp = y.shape
    s = y.reshape(b, c, tp // f, f).abs().amax(dim=(1, 3))
    r = torch.full_like(s, INT8_QMAX) / torch.clamp(s, min=1e-12)
    q = torch.round(y * r.repeat_interleave(f, dim=1)[:, None, :])
    return q, s * (1.0 / INT8_QMAX)


# the folded-row offsets of a causal conv(k, dilation d) under fold f,
# ascending (the TPU kernel's `_fold_offsets`, `folded_stack.py:57-62`)
_int8_offsets = fold_offsets


def _int8_conv(q: torch.Tensor, sd: torch.Tensor, wq: torch.Tensor, d: int,
               f: int) -> torch.Tensor:
    """Causal conv of quantized rows, dequantized as the TPU kernel does:
    for each folded-row offset o, ascending, the integer partial of the
    taps that read row u + o (below 2^24, so exact in f32) is scaled by
    that row's scale and added to the f32 sum with one rounding,
    acc = fma(part, scale, acc) from acc = 0."""
    tp = q.shape[-1]
    k = wq.shape[-1]
    span = (k - 1) * d
    hrow = -(-span // f)               # rows of left context
    qp = F.pad(q, (hrow * f, 0))
    sdp = F.pad(sd, (hrow, 0))         # zero rows before t=0 scale by 0
    t = torch.arange(tp, device=q.device)
    phase = t % f
    taps = [F.conv1d(qp[:, :, hrow * f - span + j * d:][:, :, :tp],
                     wq[:, :, j:j + 1]) for j in range(k)]
    acc = torch.zeros_like(taps[0])
    for o in _int8_offsets(k, d, f):
        part = sum(torch.where((phase + j * d - span) // f == o, taps[j], 0.0)
                   for j in range(k))
        acc = _fma(part, sdp[:, t // f + hrow + o][:, None, :], acc)
    return acc


def folded_residual_stack_int8_plain(x: torch.Tensor, unit_params: Sequence,
                                     dilations: Sequence[int]
                                     ) -> torch.Tensor:
    """The int8 mode ("row" scales) in plain PyTorch, f32 storage.

    Per unit: y = ELU(v); y is quantized per folded row of F = 128 // C
    samples x C channels (rows aligned to t=0, zero before it); conv1's
    row-grouped integer partials are dequantized and summed as in
    `_int8_conv`, then multiplied by the weight scale; ELU; the same
    quantization; the 1x1 conv likewise, giving y2, and v = fma(y2, s2, v)
    with s2 the 1x1 conv's weight scale.  T is padded to a whole row with
    zeros, which evolve like the TPU kernel's tail padding and enter the
    last row's scale."""
    b, c, t = x.shape
    f = int8_fold(c)
    tp = -(-t // f) * f
    v = F.pad(x.float(), (0, tp - t))
    for (w1, w2), d in zip(unit_params, dilations):
        q1w, s1 = int8_weight_scales(w1)
        q2w, s2 = int8_weight_scales(w2)
        # the TPU kernel's ELU (`folded_stack.py:49-54`), not expm1: near a
        # rounding boundary one ulp moves a quantized value
        q, sd = _quantize_rows(elu_exp(v), f)
        acc = _int8_conv(q, sd, q1w, d, f) * s1[:, None]
        q, sd = _quantize_rows(elu_exp(acc), f)
        v = _fma(_int8_conv(q, sd, q2w, 1, f), s2[:, None], v)
    return v[:, :, :t].contiguous()


@functools.cache
def _kernel():
    fn = _build.load("folded_stack").folded_stack_forward
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _int8_kernel():
    fn = _build.load("int8_stack").int8_stack_forward
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 \
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


def _pack_int8(unit_params, c: int, cp: int, _rounded: bool):
    """int8 mode: conv1 (n, K, cp/16, C, 16) and the 1x1 conv
    (n, cp/16, C, 16) int8, input channels zero-padded from C to cp (a
    multiple of 16) and grouped by 16 for the kernel's 16-byte loads; the
    weight scales (n, 2, C) f32."""
    def pack(w):
        q, s = int8_weight_scales(w)
        k = q.shape[-1]
        q = F.pad(q.permute(2, 0, 1), (0, cp - c))      # (k, C_out, cp)
        q = q.reshape(k, c, cp // 16, 16).permute(0, 2, 1, 3)
        return q.to(torch.int8).contiguous(), s

    w1, s1 = zip(*(pack(w) for w, _ in unit_params))
    w2, s2 = zip(*(pack(w) for _, w in unit_params))
    return (torch.stack(w1), torch.stack(w2)[:, 0].contiguous(),
            torch.stack([torch.stack(s1), torch.stack(s2)], 1).contiguous())


# packed weights by what the weight tensors hold (device, dtype, address,
# shape, strides, version) and the rounding: two views of one storage at
# one offset hold the same values, so the per-group weight slices of a
# grouped resblock, made anew on every call, hit the cache.  An entry holds
# its tensors, so their storage cannot be freed and its address reused
# while it lives, and an in-place update bumps the version and misses.
_packed = {}
_PACKED_MAX = 16


def cached_pack(pack, tensors, c: int, cp: int, rounded: bool, *args):
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
    return cached_pack(_pack_weights, weights, c, cp, rounded, unit_params)


def _packed_int8(unit_params, c: int, cp: int):
    weights = tuple(w for u in unit_params for w in u)
    return cached_pack(_pack_int8, weights, c, cp, False, unit_params)


def _packed_resblock(unit_params, biases, c: int, cp: int, rounded: bool):
    tensors = tuple(w for u in unit_params for w in u)
    if biases is not None:
        tensors += tuple(b for u in biases for b in u)
    return cached_pack(_pack_resblock, tensors, c, cp, rounded,
                        unit_params, biases)


def _mode(kernel_size, kernel_size2, act, act_param, biases,
          int8_dots) -> str:
    """'autoencoder', 'vocoder' or 'int8', the ported modes; raises on the
    rest."""
    ae_units = (act == "elu" and not act_param and biases is None
                and kernel_size == KERNEL_SIZE and kernel_size2 == 1)
    if int8_dots and ae_units:
        return "int8"
    if not int8_dots:
        if ae_units:
            return "autoencoder"
        if (act == "leaky_relu" and kernel_size in RESBLOCK_KERNEL_SIZES
                and kernel_size2 == kernel_size):
            return "vocoder"
    raise NotImplementedError(
        "folded_residual_stack is ported for the autoencoder units (ELU, "
        "k=7, k2=1, no biases), with or without int8 dots, and the vocoder "
        f"units (LeakyReLU, k=k2 in {RESBLOCK_KERNEL_SIZES}, optional "
        f"biases) without; got act={act!r}, k={kernel_size}, "
        f"k2={kernel_size2}, biases={biases is not None}, "
        f"int8_dots={int8_dots}")


def folded_residual_stack(x: torch.Tensor, unit_params: Sequence, *,
                          dilations: Sequence[int] = (1, 3, 9),
                          kernel_size: int = KERNEL_SIZE,
                          kernel_size2: int = 1,
                          act: str = "elu",
                          act_param: float = 0.0,
                          biases=None,
                          bf16_dots: bool = True,
                          int8_dots: bool = False) -> torch.Tensor:
    """Chain of causal residual units, batch mode.  x: (B, C, T) f32 or bf16
    (f32 only with int8_dots, which overrides bf16_dots); unit_params:
    ((w1 (C, C, k), w2 (C, C, k2)), ...), one per dilation; biases: None
    or ((b1 (C,), b2 (C,)), ...)."""
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
    if mode == "int8":
        return _int8_stack(x, unit_params, dilations)
    if x.device.type == "cpu":
        return folded_residual_stack_plain(
            x, unit_params, dilations, bf16_dots, act=act,
            act_param=act_param, biases=biases)
    _check_cuda(x, unit_params, biases)
    if c > PADDED_CHANNELS[-1]:
        raise ValueError(f"the kernels take C <= {PADDED_CHANNELS[-1]}, "
                         f"got {c}")
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


def _check_cuda(x, unit_params, biases):
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    tensors = [w for u in unit_params for w in u]
    tensors += [bb for u in biases for bb in u] if biases is not None else []
    if any(w.device != x.device for w in tensors):
        raise ValueError("weights must be on the device of x")


def _int8_stack(x, unit_params, dilations):
    """The int8 mode: the plain version on the CPU, else one wrapper call of
    csrc/int8_stack.cu (one CUDA launch per unit)."""
    global int8_launches
    b, c, t = x.shape
    if x.dtype != torch.float32:
        raise TypeError(f"the int8 mode stores f32, got {x.dtype}")
    if not INT8_CHANNELS[0] <= c <= INT8_CHANNELS[1]:
        raise ValueError(f"the int8 mode takes C in {INT8_CHANNELS}, "
                         f"got {c}")
    if x.device.type == "cpu":
        return folded_residual_stack_int8_plain(x, unit_params, dilations)
    _check_cuda(x, unit_params, None)
    f = int8_fold(c)
    tp = -(-t // f) * f
    cp = -(-c // 16) * 16
    n = len(dilations)
    dil = list(dilations) + [0] * (MAX_UNITS - n)
    w1, w2, scales = _packed_int8(unit_params, c, cp)
    # the kernel works on whole folded rows: the tail pad's zeros evolve
    # like the TPU kernel's and enter the last row's scale
    xp = F.pad(x, (0, tp - t)) if tp != t else x
    out = torch.empty_like(xp)
    tmp = torch.empty_like(xp) if n > 1 else out
    with torch.cuda.device(x.device):
        err = _int8_kernel()(
            xp.data_ptr(), out.data_ptr(), tmp.data_ptr(), w1.data_ptr(),
            w2.data_ptr(), scales.data_ptr(), b, c, tp, cp, n, *dil,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8-mode residual stack kernel: CUDA error "
                           f"{err}")
    int8_launches += 1
    return out if tp == t else out[:, :, :t].contiguous()
