"""Dot chain of the matrix-unit rate probe: CUDA kernel wrapper, its plain
version and the library chain.

Replaces the TPU kernel `tools/mxu_rate_probe.py:33 make_pallas_chain`
(pallas_call at `:64`) with `csrc/dot_chain.cu`, counted in `launches`.
Every row of x (M, 128) runs through n_dots products with w (n_dots, 128,
128), summed in f32 (int32 for int8):

  - chained: y = x; for each i, d = y @ w[i] and y = narrow(d), where
    narrow is bf16(d) (round to nearest even), int8(floor(d / 4096)) (the
    low byte, so large values wrap, as XLA's s32 -> s8 convert) or d (f32);
  - independent: acc = sum_i x @ w[i] in order, out = acc in x's dtype
    (the low byte for int8).

The TPU's tiles of `rows` rows are a layout only: rows are independent.
bf16 and int8 run on the tensor cores through `wgmma`, with w packed once
(`wgmma_pack`, cached on what the tensor holds) in the order its
shared-memory descriptor reads; f32 runs in true f32 on the FMA units.  A
CPU tensor runs `dot_chain_plain`; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from audiodec_tpu_torch.ops.kernels import _build
from audiodec_tpu_torch.ops.kernels.folded_stack import cached_pack

WIDTH = 128
DTYPES = {torch.bfloat16: 0, torch.int8: 1, torch.float32: 2}
INT8_SHIFT = 4096   # the chained int8 step's divisor
# wgmma's 128-byte swizzle: rows of 128-byte atoms, 16-byte chunks, the
# chunk index XORed with the row's phase in its group of 8 rows
SWIZZLE_ATOM, SWIZZLE_CHUNK, SWIZZLE_ROWS = 128, 16, 8

launches = 0


def _narrow_int8(d: torch.Tensor) -> torch.Tensor:
    """The low byte of an integer tensor, as XLA's s32 -> s8 convert."""
    return d.to(torch.int64).bitwise_and(0xFF).to(torch.uint8).view(
        torch.int8)


def _check(x: torch.Tensor, w: torch.Tensor):
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise TypeError(f"x and w must share one of {list(DTYPES)}, got "
                        f"{x.dtype} and {w.dtype}")
    if (x.dim() != 2 or x.shape[1] != WIDTH or w.dim() != 3
            or tuple(w.shape[1:]) != (WIDTH, WIDTH) or w.shape[0] < 1):
        raise ValueError(f"need x (M, {WIDTH}) and w (n_dots, {WIDTH}, "
                         f"{WIDTH}), got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")


def dot_chain_plain(x: torch.Tensor, w: torch.Tensor,
                    independent: bool = False) -> torch.Tensor:
    """The chain in plain torch: bf16 and f32 as f32 products of the
    (upcast) operands, int8 in float64, which is exact here
    (|d| <= 127^2 * 128 * n_dots < 2^53), then integer arithmetic."""
    _check(x, w)
    if x.dtype == torch.int8:
        wd = w.double()
        if independent:
            acc = sum(x.double() @ wd[i] for i in range(w.shape[0]))
            return _narrow_int8(acc.to(torch.int64))
        y = x
        for i in range(w.shape[0]):
            d = (y.double() @ wd[i]).to(torch.int64)
            y = _narrow_int8(torch.div(d, INT8_SHIFT, rounding_mode="floor"))
        return y
    wf = w.float()
    if independent:
        xf = x.float()
        acc = xf @ wf[0]
        for i in range(1, w.shape[0]):
            acc = acc + xf @ wf[i]
        return acc.to(x.dtype)
    y = x
    for i in range(w.shape[0]):
        y = (y.float() @ wf[i]).to(x.dtype)
    return y


def dot_chain_library(x: torch.Tensor, w: torch.Tensor,
                      independent: bool = False) -> torch.Tensor:
    """The same chain with one PyTorch product per dot (the counterpart of
    the tool's `make_xla_chain`): `torch.matmul` in bf16 (f32 sums, bf16
    result) or f32 (TF32 as the caller set it), `torch._int_mm` for int8
    (int32 result), then the narrowing.  The independent bf16 chain adds
    each bf16 product into an f32 sum.  A yardstick of speed only: the port
    never calls it."""
    _check(x, w)
    if x.dtype == torch.int8:
        if independent:
            acc = torch._int_mm(x, w[0])
            for i in range(1, w.shape[0]):
                acc += torch._int_mm(x, w[i])
            return acc.to(torch.int8)
        y = x
        for i in range(w.shape[0]):
            y = (torch._int_mm(y, w[i]) >> 12).to(torch.int8)
        return y
    if independent:
        acc = torch.matmul(x, w[0]).float()
        for i in range(1, w.shape[0]):
            acc += torch.matmul(x, w[i])
        return acc.to(x.dtype)
    y = x
    for i in range(w.shape[0]):
        y = torch.matmul(y, w[i])
    return y


def _swizzle_index(device) -> torch.Tensor:
    """(128, 8): chunk p of row r of a swizzled atom holds chunk
    p ^ (r % 8) of the row (an involution)."""
    rows = torch.arange(WIDTH, device=device) % SWIZZLE_ROWS
    return torch.arange(SWIZZLE_ATOM // SWIZZLE_CHUNK,
                        device=device)[None, :] ^ rows[:, None]


def _swizzle(b: torch.Tensor) -> torch.Tensor:
    """(n, atoms, 128 rows, 8 chunks, 16) bytes -> the same with each row's
    chunks permuted by the swizzle."""
    idx = _swizzle_index(b.device)[None, None, :, :, None].expand(b.shape)
    return torch.gather(b, 3, idx)


def wgmma_pack(w: torch.Tensor) -> torch.Tensor:
    """w (n_dots, 128, 128) bf16 or int8, [i][k][n] -> (n_dots, 128 * 128
    * itemsize) bytes in the order csrc/dot_chain.cu's wgmma reads B: w[i]
    transposed to [n][k] (K-major, the only B layout of s8 wgmma), cut into
    128-byte atoms along k, atom-major (all 128 rows of an atom, then the
    next), each row's 16-byte chunks swizzled.  A permutation of w's bytes;
    one 1-D copy lands it in shared memory as the descriptor expects."""
    n = w.shape[0]
    b = w.transpose(1, 2).contiguous().view(torch.uint8)
    b = b.reshape(n, WIDTH, -1, SWIZZLE_ATOM // SWIZZLE_CHUNK, SWIZZLE_CHUNK)
    return _swizzle(b.permute(0, 2, 1, 3, 4)).reshape(n, -1)


def wgmma_unpack(packed: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The inverse of `wgmma_pack`: (n_dots, bytes) -> (n_dots, 128, 128)
    of `dtype` as [i][k][n]."""
    n = packed.shape[0]
    b = _swizzle(packed.reshape(n, -1, WIDTH, SWIZZLE_ATOM // SWIZZLE_CHUNK,
                                SWIZZLE_CHUNK))
    b = b.permute(0, 2, 1, 3, 4).reshape(n, WIDTH, -1).contiguous()
    return b.view(dtype).transpose(1, 2)


def _pack_wgmma(w, _c, _cp, _rounded):
    return wgmma_pack(w)


def packed_weights(w: torch.Tensor) -> torch.Tensor:
    """`wgmma_pack(w)`, cached on what the tensor holds (an in-place update
    repacks)."""
    return cached_pack(_pack_wgmma, (w,), 0, 0, False, w)


@functools.cache
def _kernel():
    fn = _build.load("dot_chain").dot_chain_forward
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def dot_chain(x: torch.Tensor, w: torch.Tensor,
              independent: bool = False) -> torch.Tensor:
    """x (M, 128), w (n_dots, 128, 128), both bf16, int8 or f32 ->
    (M, 128) in x's dtype."""
    global launches
    _check(x, w)
    if x.device.type == "cpu":
        return dot_chain_plain(x, w, independent)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if w.device != x.device:
        raise ValueError("w must be on the device of x")
    x = x.contiguous()
    wk = w.contiguous() if x.dtype == torch.float32 else packed_weights(w)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _kernel()(x.data_ptr(), wk.data_ptr(), out.data_ptr(),
                        x.shape[0], w.shape[0], DTYPES[x.dtype],
                        int(independent),
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dot chain kernel: CUDA error {err}")
    launches += 1
    return out
