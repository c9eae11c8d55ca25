"""Fused causal residual stack: CUDA kernel wrappers and their plain version.

Replaces the TPU kernel `audiodec_tpu/ops/pallas/folded_stack.py:112
folded_residual_stack`, which takes any chain of units act -> conv(k, d) ->
act -> conv(k2) -> + skip, act ELU or LeakyReLU, with or without biases,
at any width C.  On the card (`route` picks):

  - C <= 32 with the dot operands rounded to bf16 (`bf16_dots`, or bf16
    storage): `csrc/folded_stack_mma.cu` (bf16 `mma.sync`) at every unit
    shape, counted by shape: `mma_launches` (the autoencoder units: ELU,
    k=7, 1x1 second conv, no biases), `mma_voc_launches` (the vocoder
    units: LeakyReLU with slope `act_param`, k = k2 in {3, 7, 11},
    optional biases; by k in `mma_voc_launches_by_k`) and
    `mma_other_launches` (any other shape);
  - C > 32 with bf16 operands (`bf16_dots`, or bf16 storage):
    `csrc/wide_stack_mma.cu` (bf16 `wgmma`, streamed tiles, one CUDA launch
    per unit) at every unit shape, C up to 512, counted in
    `wide_launches`;
  - true f32 (f32 storage, `bf16_dots=False`), any C and any unit shape
    and count: `csrc/resunit_stack.cu` (f32 FMA, one CUDA launch per unit,
    the archived stack's kernel), counted in `resunit_launches`;
  - int8 mode (`int8_dots`) with "row" activation scales, every unit shape
    (ELU or LeakyReLU, any k and k2, biases or none, any number of units),
    C up to 512, any fold, f32 or bf16 storage: `csrc/int8_mma_stack.cu`
    (int8 `mma.sync`), counted in `int8_launches`; arithmetic at
    `folded_residual_stack_int8_plain`;
  - int8 mode with "tile" scales (`int8_scale="tile"`), every unit shape,
    any C, fold and tile_rows: `csrc/int8_tile_mma.cu` (int8 `mma.sync`,
    2 n_units + 1 CUDA launches), counted in `int8_tile_launches`;
    arithmetic at `folded_residual_stack_int8_tile_plain`.
Each kernel holds every channel of a time tile and its halo in one block's
shared memory (csrc/folded_stack_mma.cu streams a row's tiles in time order
and holds each unit's look-back instead); the geometry functions raise a
ValueError naming the shape where nothing fits (a halo of thousands of
samples, or widths past those above), which no shipped config reaches
(ROADMAP §C).

`fold` and `tile_rows` are the TPU kernel's (0 means f = max(1, 128 // C)).
They define the int8 modes' functions: a "row" scale covers one folded row
of f samples, and a "tile" scale one tile of `_pick_tile` rows with its
halo.  In the other modes they change only the order of the TPU kernel's
f32 sums, so there they are accepted and do not reach the kernels, which
tile time as suits the card.

Bound on the H100 (bin/kernel_bounds.py: one read and one write of the
activation and the weights against the dots' operations at their type's
peak, 989 TFLOP/s bf16, 1979 TOP/s int8):
  - autoencoder units at (16, 480000, 32): 1.97 GB in f32, 0.98 GB in bf16,
    against 3 * (7 + 1) * 32 * 32 * 2 FLOP per sample (3.8e11); at the
    wider symAD stacks see bin/kernel_bounds.py;
  - vocoder units at AD v1's (16, 480000, 32) bf16: 0.98 GB (0.29 ms)
    against 3 * (11 + 11) * 32 * 32 * 2 FLOP per sample (1.04e12, 1.05 ms),
    so it is bound by operations;
  - int8 modes at the symAD decoder's stacks: see csrc/int8_mma_stack.cu
    and csrc/int8_tile_mma.cu (0.203-0.587 ms against the int8 tensor
    cores' 1979 TOP/s);
  - true f32 on the FMA units (67 TFLOP/s): see csrc/resunit_stack.cu.
See the notes in the CUDA sources for each design.

Numerics follow the TPU kernel (`folded_stack.py:344-371`): the activation
is computed in f32; with `bf16_dots` (or bf16 storage) the dot operands are
rounded to bf16; products are summed in f32; a bias is added in f32 to the
f32 sum before the next activation, and each conv's output is exactly zero
before t=0.  In bf16 storage the residual is `storage_residual`'s: the next
unit's activation reads the f32 sum of the bf16 residual and the bf16
conv output, which the stream holds rounded to bf16, and ELU is
exp(min(v, 0)) - 1, as in the TPU kernel and its int8 modes; in f32
storage ELU is expm1 (F.elu), as it has been.  `bf16_dots=False` with f32
storage is true f32.  The plain version zero-pads each conv's input, which
gives the t < 0 semantics by construction.

Layout (B, C, T).  A CPU tensor runs `folded_residual_stack_plain` (in the
int8 modes `folded_residual_stack_int8_plain` or
`folded_residual_stack_int8_tile_plain`); a CUDA tensor launches the
kernel that `route` names or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from audiodec_tpu_torch.ops.activations import elu_exp
from audiodec_tpu_torch.ops.kernels import _build
from audiodec_tpu_torch.ops.kernels.fold import (
    fold_factor,
    fold_offsets,
    halo_rows,
    padded_rows,
    pick_tile,
)

ACTIVATIONS = ("elu", "leaky_relu")
# the shipped unit shapes: the autoencoder units' first conv, and the
# vocoder units' k = k2
KERNEL_SIZE = 7
RESBLOCK_KERNEL_SIZES = (3, 7, 11)
DEFAULT_TILE_ROWS = 1024
# csrc/folded_stack_mma.cu: its padded widths, units, the samples a warp
# owns, the warps of each of two blocks that share an SM and the most of
# one block (of a wgmma block with k2 > 1: its register budget), the unit
# shapes (k, k2) whose taps it unrolls and runs on wgmma at cp = 32, and
# the shared memory one block may use on an H100 (227 KB), or each of two
# blocks of an SM (half the SM's 228 KiB less the 1 KiB each reserves).
# (Chosen on the card, PERF.md §6: 16 warps an SM ran the autoencoder units
# 1.5x faster than 8 warps with the next tile's input loaded into registers
# during this one; wgmma ran them 5% and the vocoder units 14% faster than
# mma.sync.)
MMA_CHANNELS = (16, 32)
MMA_MAX_UNITS = 256
MMA_WARP_ROWS = 32
MMA_PAIR_WARPS = 8
MMA_MAX_WARPS = 16
MMA_WG_WARPS = 12
MMA_WG_SHAPES = ((7, 1), (11, 11))
BLOCK_SMEM = 232448
MMA_PAIR_SMEM = 233472 // 2 - 1024
MMA_ACT = {"elu": 0, "leaky_relu": 1}
# csrc/resunit_stack.cu: a thread's output channels and samples, the most
# threads a block has, the input channels a stage may hold (powers of two,
# largest first), and its activations: the archived stack's
# exp(min(v, 0)) - 1, F.elu's expm1 and LeakyReLU
UNIT_TM, UNIT_TN = 16, 8
UNIT_THREADS = 256
UNIT_KC = (16, 8, 4, 2, 1)
UNIT_ACT = {"elu_exp": 0, "elu": 1, "leaky_relu": 2}
# csrc/wide_stack_mma.cu: the output channels of one wgmma (its M, the
# multiple the channels are padded to), the samples a consumer warpgroup
# takes (in wgmmas of 64, the larger preferred), the most consumer
# warpgroups of a block, the input channels of a weight stage, and the
# fewest and most ring stages
WIDE_M = 64
WIDE_CHANNELS = (32, 512)   # it takes 32 < C <= 512
WIDE_N = (128, 64)
WIDE_MAX_WG = 2
WIDE_KC = 64
WIDE_MIN_STAGES, WIDE_MAX_STAGES = 2, 8
# bytes of a warpgroup's epilogue staging (32 channels x 72 f32), and the
# rows the first conv's operand holds beyond the tile and its look-back
# (its rows start at a multiple of 4 samples, for 16-byte loads along time)
WIDE_EPILOGUE = 32 * 72 * 4
WIDE_ALIGN = 4

INT8_QMAX = 127.0
# csrc/int8_mma_stack.cu: each warp owns INT8_MMA_MT M tiles of 16 folded
# rows x INT8_MMA_NW output channels, in blocks of 8 warps at cp <= 64 (two
# blocks per SM, each in half the SM's 228 KiB less the 1 KiB it reserves:
# INT8_MMA_PAIR_SMEM) and 16 above (one block); channels are padded to the
# next of INT8_MMA_CHANNELS (multiples of the mma's k = 32 int8); a weight
# stage holds at most INT8_MMA_KC input channels; an int32 partial below
# INT8_MMA_SMALL converts to f32 by an add
INT8_MMA_MT, INT8_MMA_NW = 2, 32
INT8_MMA_CHANNELS = (32, 64, 128, 256, 512)
INT8_MMA_PAIR_SMEM = 233472 // 2 - 1024
INT8_MMA_KC = (128, 64, 32)
INT8_MMA_SMALL = 1 << 22
# csrc/int8_tile_mma.cu: its widest tile, and the channel-samples a tile
# takes at most (TS x CP) by M tiles per warp item: 2 below cp = 128 (three
# blocks per SM), else 4 (two).  (Chosen on the card, PERF.md §6: at
# C = 64 a tile of 128 samples ran faster than 256, and from C = 128 two
# blocks per SM faster than one.)
INT8_TILE_MAX_TS = 256
INT8_TILE_WORK = {2: 8192, 4: 16384}

mma_launches = 0        # csrc/folded_stack_mma.cu, autoencoder units
mma_voc_launches = 0    # csrc/folded_stack_mma.cu, vocoder units
mma_voc_launches_by_k: Dict[int, int] = {}  # the same, by kernel size k
mma_other_launches = 0  # csrc/folded_stack_mma.cu, any other unit shape
wide_launches = 0       # C > 32, bf16 operands, csrc/wide_stack_mma.cu
resunit_launches = 0    # true f32, FMA, csrc/resunit_stack.cu
int8_launches = 0       # int8 mode, "row" scales, csrc/int8_mma_stack.cu
int8_tile_launches = 0  # int8 mode, "tile" scales, csrc/int8_tile_mma.cu


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
                                act_param: float = 0.0, biases=None,
                                exact_sums: bool = False) -> torch.Tensor:
    """The stack as an F.conv1d chain with the kernels' rounding points, at
    any unit shape: each unit's k and k2 are its weights' widths, the first
    conv dilated by its unit's dilation.  In bf16 storage the residual
    follows `storage_residual`, and ELU is the TPU kernel's
    exp(min(v, 0)) - 1.  Each conv reads its zero-padded input, so with
    biases its output before t=0 is zero, as the TPU kernel's mask makes
    it.

    exact_sums=True sums each conv's products exactly (in f64) and rounds
    the sum to f32 once: the same function with every other rounding point
    kept, a reference for kernels that sum in another order than the
    convolution library (bf16 operand flips, ROADMAP §C)."""
    bf16 = x.dtype == torch.bfloat16
    rounded = bf16_dots or bf16
    fn = elu_exp if bf16 and act == "elu" else _activation(act, act_param)

    def operand(t):
        t = t.float()
        return t.to(torch.bfloat16).float() if rounded else t

    def conv(a, w, pad, d=1):
        a = F.pad(a, (pad, 0))
        if exact_sums:
            return F.conv1d(a.double(), w.double(), dilation=d).float()
        return F.conv1d(a, w, dilation=d)

    v = x.float()
    for j, ((w1, w2), d) in enumerate(zip(unit_params, dilations)):
        a = operand(fn(v))
        acc = conv(a, operand(w1), (w1.shape[-1] - 1) * d, d)
        if biases is not None:
            acc = acc + biases[j][0].float()[:, None]
        m = operand(fn(acc))
        y2 = conv(m, operand(w2), w2.shape[-1] - 1)
        if biases is not None:
            y2 = y2 + biases[j][1].float()[:, None]
        v = storage_residual(v, y2, bf16)
    return v.to(x.dtype)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def storage_residual(v: torch.Tensor, y2: torch.Tensor, bf16: bool,
                     scale: torch.Tensor | None = None) -> torch.Tensor:
    """A unit's residual `v + (y2 [* scale]).astype(v.dtype)` as XLA
    computes the TPU kernels' statement (`folded_stack.py:367`,
    `tools/folded_ablate.py:129`), in every mode of the stack.

    f32 storage: `v + y2`, or with the int8 modes' weight scale one fma.
    bf16 storage: y2 (times the scale) is rounded to bf16 and added to the
    bf16 residual in f32; the next unit's activation (`folded_stack.py
    :344`) reads that f32 sum, since XLA keeps the excess precision, while
    the residual stream and the output hold it rounded to bf16.  So `v`
    here is the f32 sum carried from the previous unit (or the input), the
    residual is `v` rounded, and the caller rounds the last sum once."""
    if not bf16:
        return v + y2 if scale is None else _fma(y2, scale, v)
    return _bf16(v) + _bf16(y2 if scale is None else y2 * scale)


# ---------------------------------------------------------------------------
# int8 modes, plain versions
# ---------------------------------------------------------------------------

# default samples per folded row: the TPU kernel folds f = 128 // C samples
# into its 128 lanes, and its activation scales are per folded row or tile
int8_fold = fold_factor


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c in f32 with one rounding, as the CUDA kernel's fmaf and
    XLA's compilation of the TPU kernel's multiply-adds compute it: the f64
    product of two f32 values is exact."""
    return (a.double() * b.double() + c.double()).float()


def int8_weight_scales(w: torch.Tensor):
    """(C_out, C_in, k) weights -> (integer-valued f32 weights in
    [-127, 127], per-output-channel f32 scales).  The TPU kernel takes the
    absmax of an output lane over all folded offset planes; every lane
    (p, c) sees all k taps of output channel c, so this is per channel, and
    the same at every fold.  Its `max(absmax, 1e-12) / 127.` is a division
    by a constant, which XLA compiles to a product with the f32 reciprocal
    (it differs from a true division by an ulp on part of the channels)."""
    w = w.float()
    s = torch.clamp(w.abs().amax(dim=(1, 2)), min=1e-12) * (1.0 / INT8_QMAX)
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


def _int8_conv(q: torch.Tensor, sd: torch.Tensor, wq: torch.Tensor, d: int,
               f: int) -> torch.Tensor:
    """Causal conv of quantized rows, dequantized as the TPU kernel does:
    for each folded-row offset o, ascending, the integer partial of the
    taps that read row u + o (summed exactly in f64, rounded once to f32
    as XLA's s32 -> f32 convert) is scaled by that row's scale and added to
    the f32 sum with one rounding, acc = fma(part, scale, acc) from acc = 0."""
    tp = q.shape[-1]
    k = wq.shape[-1]
    span = (k - 1) * d
    hrow = -(-span // f)               # rows of left context
    qp = F.pad(q, (hrow * f, 0)).double()
    sdp = F.pad(sd, (hrow, 0))         # zero rows before t=0 scale by 0
    t = torch.arange(tp, device=q.device)
    phase = t % f
    taps = [F.conv1d(qp[:, :, hrow * f - span + j * d:][:, :, :tp],
                     wq[:, :, j:j + 1].double()) for j in range(k)]
    acc = torch.zeros_like(q)
    for o in fold_offsets(k, d, f):
        part = sum(torch.where((phase + j * d - span) // f == o, taps[j], 0.0)
                   for j in range(k))
        acc = _fma(part.float(), sdp[:, t // f + hrow + o][:, None, :], acc)
    return acc


def _int8_activation(act: str, act_param: float):
    """The TPU kernel's activations in f32 (`folded_stack.py:49-54`,
    `:258-265`): ELU as exp(min(v, 0)) - 1, not expm1 (near a rounding
    boundary of the quantizer one ulp moves a code), and LeakyReLU as
    v > 0 ? v : slope * v with the slope rounded to f32."""
    if act == "elu":
        return lambda v: elu_exp(v)
    if act == "leaky_relu":
        slope = torch.tensor(act_param, dtype=torch.float32)
        return lambda v: torch.where(v > 0, v, v * slope.to(v.device))
    raise NotImplementedError(f"folded stack activation {act!r}")


def _scaled_bias(y: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """A conv's output with the TPU kernel's weight scale and bias
    (`folded_stack.py:346-364`): `y * scale + bias`, which XLA fuses into
    one f32 fma."""
    return _fma(y, scale[:, None], bias.float()[:, None])


def folded_residual_stack_int8_plain(x: torch.Tensor, unit_params: Sequence,
                                     dilations: Sequence[int], fold: int = 0,
                                     *, act: str = "elu",
                                     act_param: float = 0.0, biases=None
                                     ) -> torch.Tensor:
    """The int8 mode with "row" scales in plain PyTorch, f32 or bf16
    storage, at every unit shape the TPU kernel takes (act ELU or LeakyReLU
    with slope act_param; each conv's width its weights'; biases or none).

    Per unit: y = act(v); y is quantized per folded row of f = fold (0: 128
    // C) samples x C channels (rows aligned to t=0, zero before it);
    conv1's row-grouped integer partials are dequantized and summed as in
    `_int8_conv`, then multiplied by the weight scale (and the bias added);
    act; the same quantization; the second conv likewise (its own rows'
    scales over `fold_offsets(k2, 1, f)`), giving y2, and the residual as
    `storage_residual`.  Each conv reads zeros before t=0, which is the TPU
    kernel's mask of the biased outputs there.  T is padded to a whole row
    with zeros, which evolve like the TPU kernel's tail padding and enter
    the last row's scale; rows wholly in the padding never reach a real
    sample (the units are causal), and with per-row scales a tile's halo
    rows equal the rows they repeat, so the TPU kernel's time tiling does
    not change this function."""
    b, c, t = x.shape
    f = fold or int8_fold(c)
    bf16 = x.dtype == torch.bfloat16
    fn = _int8_activation(act, act_param)
    tp = -(-t // f) * f
    v = F.pad(x.float(), (0, tp - t))
    for j, ((w1, w2), d) in enumerate(zip(unit_params, dilations)):
        q1w, s1 = int8_weight_scales(w1)
        q2w, s2 = int8_weight_scales(w2)
        q, sd = _quantize_rows(fn(v), f)
        acc = _int8_conv(q, sd, q1w, d, f)
        acc = (acc * s1[:, None] if biases is None
               else _scaled_bias(acc, s1, biases[j][0]))
        q, sd = _quantize_rows(fn(acc), f)
        y2 = _int8_conv(q, sd, q2w, 1, f)
        if biases is None:
            v = storage_residual(v, y2, bf16, s2[:, None])
        else:
            v = storage_residual(v, _scaled_bias(y2, s2, biases[j][1]),
                                 bf16)
    return v[:, :, :t].to(x.dtype).contiguous()


class TileGeometry(NamedTuple):
    """The TPU kernel's tiling of the int8 "tile" mode
    (`folded_stack.py:177-199`): f samples per folded row, T zero-padded to
    n_rows rows, tiles of rows_tile rows, each tile's window its rows and
    the `halo` rows before it (zeros before t=0)."""
    f: int
    n_rows: int
    rows_tile: int
    n_tiles: int
    halo: int

    @property
    def window(self) -> int:
        """Samples per window."""
        return (self.rows_tile + self.halo) * self.f


def tile_geometry(c: int, t: int, dilations: Sequence[int], fold: int = 0,
                  tile_rows: int = DEFAULT_TILE_ROWS,
                  kernel_size: int = KERNEL_SIZE,
                  kernel_size2: int = 1) -> TileGeometry:
    """The tiling the TPU kernel gives (C, T) at this fold and tile_rows
    for units of widths kernel_size and kernel_size2."""
    f = fold or int8_fold(c)
    n_rows = padded_rows(t, f)
    rows_tile = pick_tile(n_rows, tile_rows)
    return TileGeometry(f, n_rows, rows_tile, n_rows // rows_tile,
                        halo_rows(kernel_size, dilations, f, kernel_size2))


def _quantize_windows(y: torch.Tensor):
    """(W, C, S) f32 -> (integer-valued q, dequant scale (W, 1, 1)): one
    s = max|y| per window, q = round(y * (127 / s)), dequant s * (1/127)."""
    s = y.abs().amax(dim=(1, 2), keepdim=True)
    r = torch.full_like(s, INT8_QMAX) / torch.clamp(s, min=1e-12)
    return torch.round(y * r), s * (1.0 / INT8_QMAX)


def _exact_conv(q: torch.Tensor, wq: torch.Tensor, d: int) -> torch.Tensor:
    """Valid conv of integer-valued q and weights as one exact sum over all
    taps and channels, rounded once to f32 as XLA's s32 -> f32 convert:
    |sum| <= 127^2 * k * C < 2^53, so f64 holds every partial, and
    torch.round removes any error of the convolution's algorithm."""
    return torch.round(F.conv1d(q.double(), wq.double(), dilation=d)).float()


def folded_residual_stack_int8_tile_plain(
        x: torch.Tensor, unit_params: Sequence, dilations: Sequence[int],
        fold: int = 0, tile_rows: int = DEFAULT_TILE_ROWS, *,
        act: str = "elu", act_param: float = 0.0,
        biases=None) -> torch.Tensor:
    """The int8 mode with "tile" scales in plain PyTorch, f32 or bf16
    storage (`folded_stack.py:183-213`, `:275-370`), at every unit shape
    the TPU kernel takes (as `folded_residual_stack_int8_plain`).

    T is padded and tiled as `tile_geometry`, and each tile's window is run
    on its own, its halo rows recomputed with the window's own scales (so
    the output depends on `tile_rows`).  Per unit, over the window's L
    current rows: y = act(v); one scale s = max|y| over the whole window
    (the tail padding included); q = round(y * (127 / s)); the first conv
    over the window as one exact integer sum over all taps, rounded to f32
    once, times s * (1/127), times the weight scale (plus the bias, masked
    to zero before t=0); act and a second scale over the L - span1 rows
    left; the second conv the same way over its own span2 rows, giving y2;
    the residual as `storage_residual`; the window loses its first span1 +
    span2 rows.  k and k2 are the convs' widths, the same in every unit."""
    b, c, t = x.shape
    k = unit_params[0][0].shape[-1]
    k2 = unit_params[0][1].shape[-1]
    g = tile_geometry(c, t, dilations, fold, tile_rows, k, k2)
    bf16 = x.dtype == torch.bfloat16
    fn = _int8_activation(act, act_param)
    step = g.rows_tile * g.f
    # each tile's window: its samples and the halo's before them, zero
    # before t=0 and in the tail padding
    xp = F.pad(x.float(), (g.halo * g.f, g.n_rows * g.f - t))
    v = xp.unfold(2, g.window, step).transpose(1, 2) \
        .reshape(b * g.n_tiles, c, g.window)
    # the absolute time of each window's first current sample
    start = (torch.arange(g.n_tiles, device=x.device) * step
             - g.halo * g.f).repeat(b)[:, None, None]
    cut2 = -fold_offsets(k2, 1, g.f)[0] * g.f if k2 > 1 else 0

    def masked(y, first):
        # the TPU kernel's `masked`: zero before t=0
        tpos = first + torch.arange(y.shape[-1], device=y.device)
        return torch.where(tpos >= 0, y, 0.0)

    for j, ((w1, w2), d) in enumerate(zip(unit_params, dilations)):
        q1w, s1 = int8_weight_scales(w1)
        q2w, s2 = int8_weight_scales(w2)
        cut = -fold_offsets(k, d, g.f)[0] * g.f
        q, sd = _quantize_windows(fn(v))
        acc = _exact_conv(q, q1w, d)[..., cut - (k - 1) * d:] * sd
        start = start + cut
        acc = (acc * s1[:, None] if biases is None
               else masked(_scaled_bias(acc, s1, biases[j][0]), start))
        q, sd = _quantize_windows(fn(acc))
        y2 = _exact_conv(q, q2w, 1)[..., cut2 - (k2 - 1):] * sd
        start = start + cut2
        if biases is None:
            v = storage_residual(v[..., cut + cut2:], y2, bf16, s2[:, None])
        else:
            v = storage_residual(
                v[..., cut + cut2:],
                masked(_scaled_bias(y2, s2, biases[j][1]), start), bf16)
    # the windows are down to their tiles' own samples
    out = v.reshape(b, g.n_tiles, c, step).transpose(1, 2) \
        .reshape(b, c, g.n_tiles * step)[:, :, :t]
    return out.to(x.dtype).contiguous()


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

@functools.cache
def _mma_kernel():
    fn = _build.load("folded_stack_mma").folded_stack_mma_forward
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 3
                   + [ctypes.c_float] + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _int8_kernel():
    fn = _build.load("int8_mma_stack").int8_mma_stack_forward
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                   + [ctypes.POINTER(ctypes.c_int)] * 2 + [ctypes.c_int]
                   + [ctypes.c_float] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _int8_tile_kernel():
    fn = _build.load("int8_tile_mma").int8_tile_mma_forward
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                   + [ctypes.POINTER(ctypes.c_int)] * 2 + [ctypes.c_int] * 4
                   + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _resunit_kernel():
    fn = _build.load("resunit_stack").resunit_stack_forward
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 3
                   + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _wide_kernel():
    fn = _build.load("wide_stack_mma").wide_stack_forward
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 3
                   + [ctypes.c_float] + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


_CUDA_LAUNCHES = {"resunit_stack": "resunit_stack_cuda_launches",
                  "wide_stack_mma": "wide_stack_cuda_launches"}


def cuda_launches(source: str) -> int:
    """The CUDA launches that csrc/resunit_stack.cu or
    csrc/wide_stack_mma.cu (`source`, the file's name) has made in this
    process, counted by the library itself: one per unit of each wrapper
    call."""
    fn = getattr(_build.load(source), _CUDA_LAUNCHES[source])
    fn.restype = ctypes.c_longlong
    return fn()


def _pack_biases(biases, c: int, cp: int):
    """The biases as (n, 2, cp) f32 (never rounded: the TPU kernel adds them
    in f32), zero-padded from C to cp channels, or None."""
    if biases is None:
        return None
    return torch.stack([torch.stack([F.pad(b1.float(), (0, cp - c)),
                                     F.pad(b2.float(), (0, cp - c))])
                        for b1, b2 in biases]).contiguous()


def _pack_mma(unit_params, biases, c: int, cp: int, _rounded: bool):
    """csrc/folded_stack_mma.cu's operands before their fragment orders
    (and the replaced wide kernel's, which chip_smoke.py times against):
    each conv's taps as (n, k, cp, cp) bf16 [u][tap][c_out][c_in],
    zero-padded from C to cp channels, and the biases (`_pack_biases`)."""
    def taps(ws):
        return torch.stack([F.pad(w.float().permute(2, 0, 1),
                                  (0, cp - c, 0, cp - c)) for w in ws]
                           ).to(torch.bfloat16).contiguous()

    return (taps([w for w, _ in unit_params]),
            taps([w for _, w in unit_params]), _pack_biases(biases, c, cp))


def _pack_mma_frag(unit_params, biases, c: int, cp: int, _rounded: bool):
    """csrc/folded_stack_mma.cu's operands: each unit's taps, its first
    conv's k then its second's k2, as (n, k + k2, cp / 8, 32, cp / 4) bf16,
    the B fragments of mma.m16n8k16 in lane order: for n8 tile nt and lane
    4 g + t, the pairs of input channels 16 kk + 8 h + 2 t (+1) of output
    channel 8 nt + g, by kk then h, so that a lane's fragments of one n8
    tile are one 16-byte load (8 bytes at cp = 16); and the biases
    (`_pack_biases`)."""
    w1, w2, bias = _pack_mma(unit_params, biases, c, cp, _rounded)
    w = torch.cat([w1, w2], 1)
    n, taps = w.shape[:2]
    # [u, tap, nt, g, kk, h, t, e] -> [u, tap, nt, g, t, kk, h, e]
    w = w.reshape(n, taps, cp // 8, 8, cp // 16, 2, 4, 2)
    return (w.permute(0, 1, 2, 3, 6, 4, 5, 7).reshape(n, taps, cp // 8, 32,
                                                       cp // 4).contiguous(),
            bias)


def _pack_mma_wg(unit_params, biases, c: int, cp: int, _rounded: bool):
    """csrc/folded_stack_mma.cu's operands for its wgmma form: each unit's
    taps, the first conv's k then the second's k2, as (n, k + k2, cp / 8,
    cp / 8, 8, 8) bf16, each tap's B (output channel n, input channel k)
    in K-major core matrices of 8 n x 8 k, those of k block kb and n block
    nb at kb * cp / 8 + nb; and the biases (`_pack_biases`)."""
    w1, w2, bias = _pack_mma(unit_params, biases, c, cp, _rounded)
    w = torch.cat([w1, w2], 1)
    n, taps = w.shape[:2]
    # [u, tap, nb, i, kb, e] -> [u, tap, kb, nb, i, e]
    w = w.reshape(n, taps, cp // 8, 8, cp // 8, 8).permute(0, 1, 4, 2, 3, 5)
    return w.contiguous(), bias


def _pack_wide(unit_params, biases, c: int, cp: int, _rounded: bool):
    """csrc/wide_stack_mma.cu's operands: each conv as (n, cp / 64, k,
    cp / 8, 8, 8, 8) bf16, zero-padded from C to cp channels: for each 64
    output channels (its wgmma's M) and tap, the 8 x 8 core matrices of 8
    output x 8 input channels, input channels outer, so that a weight stage
    (WIDE_KC input channels of one tap) is one contiguous run whose core
    matrices lie 128 bytes apart in M and 1024 in K; and the biases
    (`_pack_biases`)."""
    w1, w2, bias = _pack_mma(unit_params, biases, c, cp, _rounded)

    def blocks(w):
        n, taps = w.shape[:2]
        # [u, tap, ob, mb, o, kb, i] -> [u, ob, tap, kb, mb, o, i]
        w = w.reshape(n, taps, cp // WIDE_M, WIDE_M // 8, 8, cp // 8, 8)
        return w.permute(0, 2, 1, 5, 3, 4, 6).contiguous()

    return blocks(w1), blocks(w2), bias


def _pack_unit(unit_params, biases, c: int, cp: int, _rounded: bool):
    """csrc/resunit_stack.cu's operands: each conv as (n, cp, k, cp) f32
    [u][c_in][tap][c_out], so that a stage of input channels is one run
    and a thread's 16 output channels four float4s, zero-padded from C to
    cp channels, and the biases (`_pack_biases`)."""
    def convs(ws):
        return torch.stack([F.pad(w.float().permute(1, 2, 0),
                                  (0, cp - c, 0, 0, 0, cp - c)) for w in ws]
                           ).contiguous()

    return (convs([w for w, _ in unit_params]),
            convs([w for _, w in unit_params]), _pack_biases(biases, c, cp))


def _int8_scaled(unit_params, biases, c: int, cp: int, layout):
    """Both convs of each unit quantized (`int8_weight_scales`), the
    integers as `layout` packs a (k, cp_out, cp_in) tensor zero-padded from
    C to cp, as int8; the weight scales (n, 2, cp) f32, zero on the
    padding; and the biases (`_pack_biases`)."""
    def pack(w):
        q, s = int8_weight_scales(w)
        q = F.pad(q.permute(2, 0, 1), (0, cp - c, 0, cp - c))
        return layout(q).to(torch.int8).contiguous(), F.pad(s, (0, cp - c))

    w1, s1 = zip(*(pack(w) for w, _ in unit_params))
    w2, s2 = zip(*(pack(w) for _, w in unit_params))
    return (torch.stack(w1), torch.stack(w2),
            torch.stack([torch.stack(s1), torch.stack(s2)], 1).contiguous(),
            _pack_biases(biases, c, cp))


def _pack_int8_mma(unit_params, biases, c: int, cp: int, _rounded: bool):
    """csrc/int8_mma_stack.cu's operands: conv1 (n, k, cp, cp) and conv2
    (n, k2, cp, cp) int8 as [u][tap][c_out][c_in], channels zero-padded
    from C to cp; the weight scales (n, 2, cp) f32, zero on the padding;
    the biases."""
    return _int8_scaled(unit_params, biases, c, cp, lambda q: q)


def int8_fragment_order(q: torch.Tensor) -> torch.Tensor:
    """(k, cp, cp) [tap][c_out][c_in], cp a multiple of 32 -> the B
    fragments of mma.m16n8k32 s8 as csrc/int8_tile_mma.cu reads them:
    (k, cp/32, cp/8, 32, 8) [tap][32 input channels][8 output channels]
    [lane][byte], lane = 4 g + t4 holding output channel 8 ot + g and input
    channels 32 kc + 4 t4 + (0..3) (its first register) and 16 more (its
    second)."""
    k, cp, _ = q.shape
    q = q.reshape(k, cp // 8, 8, cp // 32, 2, 4, 4)  # tap ot g kc half t4 b
    return q.permute(0, 3, 1, 2, 5, 4, 6).reshape(k, cp // 32, cp // 8,
                                                  32, 8)


def _pack_int8_tile(unit_params, biases, c: int, cp: int, _rounded: bool):
    """csrc/int8_tile_mma.cu's operands: conv1 (n, k, cp/32, cp/8, 32, 8)
    and conv2 (n, k2, ...) int8 in B-fragment order
    (`int8_fragment_order`), channels zero-padded from C to cp; the weight
    scales (n, 2, cp) f32, zero on the padding; the biases."""
    return _int8_scaled(unit_params, biases, c, cp, int8_fragment_order)


# packed weights by what the weight tensors hold (device, dtype, address,
# shape, strides, version), the widths and the rounding: two views of one
# storage at one offset hold the same values, so the per-group weight
# slices of a grouped resblock, made anew on every call, hit the cache.  An
# entry holds its tensors, so their storage cannot be freed and its address
# reused while it lives, and an in-place update bumps the version and
# misses.
_packed = {}
_PACKED_MAX = 16


def cached_pack(pack, tensors, c: int, cp: int, rounded: bool, *args):
    key = (pack.__name__, c, cp, rounded,
           tuple((w.device, w.dtype, w.data_ptr(), tuple(w.shape), w.stride(),
                  w._version) for w in tensors))
    hit = _packed.get(key)
    if hit is None:
        if len(_packed) >= _PACKED_MAX:
            del _packed[next(iter(_packed))]
        hit = _packed[key] = (tensors, pack(*args, c, cp, rounded))
    return hit[1]




def _unit_tensors(unit_params, biases):
    tensors = tuple(w for u in unit_params for w in u)
    if biases is not None:
        tensors += tuple(b for u in biases for b in u)
    return tensors


def _packed_mma(unit_params, biases, c: int, cp: int):
    return cached_pack(_pack_mma, _unit_tensors(unit_params, biases), c, cp,
                       True, unit_params, biases)


def _packed_mma_taps(unit_params, biases, c: int, cp: int, wgmma: bool):
    return cached_pack(_pack_mma_wg if wgmma else _pack_mma_frag,
                       _unit_tensors(unit_params, biases), c, cp, True,
                       unit_params, biases)


def _packed_wide(unit_params, biases, c: int, cp: int):
    return cached_pack(_pack_wide, _unit_tensors(unit_params, biases), c, cp,
                       True, unit_params, biases)


def _packed_unit(unit_params, biases, c: int, cp: int):
    return cached_pack(_pack_unit, _unit_tensors(unit_params, biases), c, cp,
                       False, unit_params, biases)


def _packed_int8(pack, unit_params, biases, c: int, cp: int):
    """`pack` (_pack_int8_mma or _pack_int8_tile) through the pack cache."""
    return cached_pack(pack, _unit_tensors(unit_params, biases), c, cp,
                       False, unit_params, biases)


def _mode(kernel_size, kernel_size2, act, biases, int8_dots) -> str:
    """The units' shape: 'int8' (int8 dots, any units), 'autoencoder' (ELU,
    k=7, k2=1, no biases), 'vocoder' (LeakyReLU, k = k2 in
    RESBLOCK_KERNEL_SIZES, biases or none) or 'other' (any other k, k2 and
    biases with either activation).  ELU ignores act_param, as the TPU
    kernel's `_elu` does.  Raises on an activation the TPU kernel
    rejects."""
    if act not in ACTIVATIONS:
        raise NotImplementedError(f"folded stack activation {act!r}")
    if int8_dots:
        return "int8"
    elu_1x1 = act == "elu" and kernel_size2 == 1 and biases is None
    if elu_1x1 and kernel_size == KERNEL_SIZE:
        return "autoencoder"
    if (act == "leaky_relu" and kernel_size == kernel_size2
            and kernel_size in RESBLOCK_KERNEL_SIZES):
        return "vocoder"
    return "other"


def _shape(kernel_size, kernel_size2, act, biases, dilations) -> str:
    return (f"act={act}, k={kernel_size}, k2={kernel_size2}, "
            f"biases={biases is not None}, dilations={tuple(dilations)}")


def route(mode: str, c: int, bf16_storage: bool, bf16_dots: bool) -> str:
    """The kernel a CUDA tensor of C channels takes in `mode` (`_mode`):
    'int8' (the int8 modes' kernels); with the dot operands rounded to
    bf16, 'mma' at C <= 32 (csrc/folded_stack_mma.cu) and 'wide' above
    (csrc/wide_stack_mma.cu); in true f32 'resunit'
    (csrc/resunit_stack.cu), at every width and unit shape."""
    if mode == "int8":
        return "int8"
    if bf16_dots or bf16_storage:
        return "mma" if c <= MMA_CHANNELS[-1] else "wide"
    return "resunit"


class MmaGeometry(NamedTuple):
    """A launch of csrc/folded_stack_mma.cu: channels padded to cp, blocks
    of `warps` warps that step through time by `tile` samples carrying a
    look-back of the stack's `halo`, every unit's weights in shared memory
    at once (`resident`) or one unit's at a time, `blocks` blocks per SM,
    the block's shared memory in bytes, whether the products run on wgmma
    (else mma.sync), and with a 1x1 second conv the first conv's operand
    buffers (2: one barrier a unit, 1: two)."""
    cp: int
    warps: int
    tile: int
    halo: int
    resident: bool
    blocks: int
    smem: int
    wgmma: bool = False
    ybufs: int = 2


class MmaSplit(NamedTuple):
    """The work of one launch of csrc/folded_stack_mma.cu: each batch row
    cut into `nseg` segments of `seg` samples, each segment's stream
    started `warm` samples early, walked by `grid` blocks."""
    seg: int
    nseg: int
    warm: int
    grid: int


def mma_width(c: int) -> int:
    """The padded width csrc/folded_stack_mma.cu runs C <= 32 channels at."""
    return next(p for p in MMA_CHANNELS if c <= p)


def mma_smem(cp: int, k: int, k2: int, dilations: Sequence[int],
             resident: bool, tile: int, ybufs: int = 2) -> int:
    """Shared memory of a block (csrc/folded_stack_mma.cu `smem_bytes`):
    the weights (k + k2 taps of cp x cp bf16) and biases of every unit or
    of one; tile buffers of rows of cp + 8 bf16 (the first conv's operand
    `ybufs` times with the 1x1 second conv, else once and the second
    conv's), each behind the rows of its conv's longest look-back; and the
    look-backs kept from tile to tile, (k - 1) d rows per unit, and k2 - 1
    with k2 > 1."""
    rb = (cp + 8) * 2
    units = len(dilations) if resident else 1
    h1 = sum((k - 1) * d for d in dilations)
    hy = max((k - 1) * d for d in dilations)
    bufs = ybufs * (tile + hy) if k2 == 1 else 2 * tile + hy + k2 - 1
    return (units * ((k + k2) * cp * cp * 2 + 2 * cp * 4) + bufs * rb
            + h1 * rb + len(dilations) * (k2 - 1) * rb)


def mma_geometry(c: int, kernel_size: int, kernel_size2: int,
                 dilations: Sequence[int]) -> MmaGeometry:
    """How csrc/folded_stack_mma.cu runs these units: on wgmma for the
    MMA_WG_SHAPES at cp = 32 (whole warpgroups), else mma.sync; two blocks
    per SM of MMA_PAIR_WARPS warps (tiles of 256 samples) with every unit's
    weights resident where both fit MMA_PAIR_SMEM; else one block of the
    most warps (up to MMA_MAX_WARPS; on wgmma, k2 > 1 only, whole
    warpgroups up to MMA_WG_WARPS) that fit beside every unit's weights, or
    beside one unit's where all of them do not fit, with the 1x1 second
    conv in one operand buffer where two do not fit.  Raises ValueError
    where even one warp's tile does not fit beside the look-back."""
    cp = mma_width(c)
    k, k2 = kernel_size, kernel_size2
    halo = sum((k - 1) * d + k2 - 1 for d in dilations)
    wg = cp == 32 and (k, k2) in MMA_WG_SHAPES

    def geometry(wgmma, warps, resident, blocks, ybufs=2):
        tile = warps * MMA_WARP_ROWS
        return MmaGeometry(cp, warps, tile, halo, resident, blocks,
                           mma_smem(cp, k, k2, dilations, resident, tile,
                                    ybufs), wgmma, ybufs)

    for wgmma in (True, False) if wg else (False,):
        g = geometry(wgmma, MMA_PAIR_WARPS, True, 2)
        if g.smem <= MMA_PAIR_SMEM:
            return g
        if wgmma and k2 == 1:  # its launch bounds keep two blocks' registers
            continue
        most, step = (MMA_WG_WARPS, 4) if wgmma else (MMA_MAX_WARPS, 1)
        for resident in (True, False):
            for ybufs in (2, 1) if k2 == 1 else (2,):
                for warps in range(most, 0, -step):
                    g = geometry(wgmma, warps, resident, 1, ybufs)
                    if g.smem <= BLOCK_SMEM:
                        return g
    raise ValueError(
        f"csrc/folded_stack_mma.cu: a halo of {halo} samples (k={k}, "
        f"k2={k2}, dilations={tuple(dilations)}) leaves no tile of "
        f"{MMA_WARP_ROWS} samples in a block's {BLOCK_SMEM} bytes of shared "
        f"memory at C={c}")


def mma_split(g: MmaGeometry, b: int, t: int, sms: int) -> MmaSplit:
    """How one launch cuts (b, t): each row into as many segments as the
    SMs' blocks (g.blocks per SM) hold rows of, at most one per tile, each
    a whole number of tiles; a segment's stream starts its halo, rounded up
    to tiles, early.  One block per work item while they fit the card, each
    then walking its segment's tiles."""
    def tiles(n):  # whole tiles covering n samples
        return -(-n // g.tile)

    slots = g.blocks * sms
    nseg = max(1, min(slots // b, tiles(t)))
    seg = tiles(-(-t // nseg)) * g.tile
    nseg = -(-t // seg)
    return MmaSplit(seg, nseg, tiles(g.halo) * g.tile, min(b * nseg, slots))


class UnitGeometry(NamedTuple):
    """A launch of csrc/resunit_stack.cu: channels padded to cp, blocks of
    `threads` threads that run the first conv over `rows` samples and
    write `tile` output samples behind a halo of look-back, kc1 and kc2
    input channels per stage of the two convs, the block's shared memory
    in bytes, and the CUDA launches per wrapper call (one per unit)."""
    cp: int
    threads: int
    rows: int
    tile: int
    halo: int
    kc1: int
    kc2: int
    smem: int
    launches: int

    @property
    def warps(self) -> int:
        return -(-self.threads // 32)


def unit_smem(cp: int, k: int, k2: int, rows: int, width: int, kc1: int,
              kc2: int) -> int:
    """Shared memory of a block (csrc/resunit_stack.cu `layout`): two ring
    buffers, each the larger conv stage's weights ([i][tap][cp] f32) and
    kc1 rows of `width` staged input samples, 16-byte aligned; and a2, cp
    rows of rows + k2 - 1 samples, the stride made odd."""
    stage = -(-(max(kc1 * k, kc2 * k2) * cp + kc1 * width) // 4) * 4
    return 4 * (2 * stage + cp * ((rows + k2 - 1) | 1))


def unit_geometry(c: int, kernel_size: int, kernel_size2: int,
                  dilations: Sequence[int]) -> UnitGeometry:
    """How csrc/resunit_stack.cu runs these units: channels padded to a
    multiple of 16, cp / 16 threads along them and as many along time as
    make up to UNIT_THREADS, each thread 16 channels x 8 samples, so
    8 * threads / (cp / 16) conv1 samples per block; the stages as wide as
    fit (kc1 input channels of the first conv, kc2 of the second within
    the same weight buffer), halving the threads along time where none
    fits.  Raises ValueError where nothing fits a block's shared memory."""
    k, k2, d = kernel_size, kernel_size2, max(dilations)
    cp = -(-c // UNIT_TM) * UNIT_TM
    ny = cp // UNIT_TM
    halo = (k - 1) * d + k2 - 1
    nx = UNIT_THREADS // ny
    while nx >= 1 and UNIT_TN * nx > k2 - 1:
        rows = UNIT_TN * nx
        for kc1 in UNIT_KC:
            kc2 = next(v for v in UNIT_KC if v * k2 <= max(kc1 * k, k2))
            smem = unit_smem(cp, k, k2, rows, rows + (k - 1) * d, kc1, kc2)
            if smem <= BLOCK_SMEM:
                return UnitGeometry(cp, nx * ny, rows, rows - (k2 - 1),
                                    halo, kc1, kc2, smem, len(dilations))
        nx //= 2
    raise ValueError(
        f"csrc/resunit_stack.cu: a halo of {halo} samples (k={k}, k2={k2}, "
        f"dilations={tuple(dilations)}) leaves no tile in a block's "
        f"{BLOCK_SMEM} bytes of shared memory at C={c}")


class WideGeometry(NamedTuple):
    """A launch of csrc/wide_stack_mma.cu: channels padded to cp, blocks of
    `warpgroups` consumer warpgroups of `n` samples each (a tile of `tile`
    samples) and one producer warpgroup, stepping through time with the
    look-back of a unit's first conv restaged and its second conv's
    carried, weight stages of WIDE_KC input channels in `stages` ring
    stages, the block's shared memory in bytes, and the CUDA launches per
    wrapper call (one per unit)."""
    cp: int
    n: int
    warpgroups: int
    tile: int
    halo: int
    stages: int
    smem: int
    launches: int


class WideSplit(NamedTuple):
    """The work of one launch of csrc/wide_stack_mma.cu: each batch row cut
    into `nseg` segments of `seg` samples (whole tiles), walked by `grid`
    blocks; a segment after a row's first starts with one tile of the first
    conv alone, for the second conv's look-back."""
    seg: int
    nseg: int
    grid: int


def wide_smem(cp: int, yrows: int, arows: int, warpgroups: int,
              stages: int) -> int:
    """Shared memory of a block (csrc/wide_stack_mma.cu `smem_bytes`): the
    ring of weight stages (64 output x WIDE_KC input channels of bf16, and
    two mbarriers each), the first conv's operand act(v) over `yrows` rows
    and a2 over `arows`, both cp bf16 a row, and each warpgroup's epilogue
    staging."""
    return (stages * (WIDE_M * WIDE_KC * 2 + 16) + 2 * cp * (yrows + arows)
            + warpgroups * WIDE_EPILOGUE)


def wide_geometry(c: int, kernel_size: int, kernel_size2: int,
                  dilations: Sequence[int]) -> WideGeometry:
    """How csrc/wide_stack_mma.cu runs these units: channels padded to a
    multiple of WIDE_M; the most warpgroups (up to WIDE_MAX_WG), then the
    first of WIDE_N samples a warpgroup, whose tile, with its rows of
    look-back (the first conv's at the largest dilation and WIDE_ALIGN,
    k2 - 1 of a2), leaves room for WIDE_MIN_STAGES weight stages; then as
    many stages as fit, up to WIDE_MAX_STAGES.  (Two warpgroups of 64
    samples ran C = 256 1.2-1.3x faster than one of 128: each one's f32
    adds run under the other's products.)  Raises ValueError where nothing
    fits a block's shared memory."""
    k, k2, d = kernel_size, kernel_size2, max(dilations)
    cp = -(-c // WIDE_M) * WIDE_M
    halo = (k - 1) * d + k2 - 1
    for wgs in range(WIDE_MAX_WG, 0, -1):
        for n in WIDE_N:
            tile = n * wgs
            if tile < k2 - 1:
                continue
            rows = (tile + (k - 1) * d + WIDE_ALIGN, tile + k2 - 1)
            fixed = wide_smem(cp, *rows, wgs, 0)
            stages = min(WIDE_MAX_STAGES,
                         (BLOCK_SMEM - fixed) // (WIDE_M * WIDE_KC * 2 + 16))
            if stages >= WIDE_MIN_STAGES and rows[0] < 1 << 14:
                return WideGeometry(cp, n, wgs, tile, halo, stages,
                                    wide_smem(cp, *rows, wgs, stages),
                                    len(dilations))
    raise ValueError(
        f"csrc/wide_stack_mma.cu: a halo of {halo} samples (k={k}, k2={k2}, "
        f"dilations={tuple(dilations)}) leaves no tile in a block's "
        f"{BLOCK_SMEM} bytes of shared memory at C={c}")


def wide_split(g: WideGeometry, b: int, t: int, sms: int) -> WideSplit:
    """How one launch cuts (b, t): each row into as many segments as the
    SMs (one block each) hold rows of, at most one per tile, each a whole
    number of tiles; one block per work item while they fit the card."""
    def tiles(n):  # whole tiles covering n samples
        return -(-n // g.tile)

    nseg = max(1, min(sms // b, tiles(t)))
    seg = tiles(-(-t // nseg)) * g.tile
    nseg = -(-t // seg)
    return WideSplit(seg, nseg, min(b * nseg, sms))


def folded_residual_stack(x: torch.Tensor, unit_params: Sequence, *,
                          dilations: Sequence[int] = (1, 3, 9),
                          kernel_size: int = KERNEL_SIZE,
                          kernel_size2: int = 1,
                          act: str = "elu",
                          act_param: float = 0.0,
                          biases=None,
                          tile_rows: int = DEFAULT_TILE_ROWS,
                          bf16_dots: bool = True,
                          int8_dots: bool = False,
                          int8_scale: str = "row",
                          fold: int = 0) -> torch.Tensor:
    """Chain of causal residual units, batch mode.  x: (B, C, T) f32 or bf16;
    unit_params: ((w1 (C, C, k), w2 (C, C, k2)), ...), one per dilation;
    biases: None or ((b1 (C,), b2 (C,)), ...); act 'elu' or 'leaky_relu'
    (slope act_param).  int8_dots overrides bf16_dots; int8_scale "tile"
    selects one activation scale per tile window, any other value per-row
    scales, as the TPU kernel reads it.  fold (0: max(1, 128 // C)) and
    tile_rows define the int8 modes' scales and are accepted, unused, by
    the others (module docstring)."""
    global wide_launches, resunit_launches
    mode = _mode(kernel_size, kernel_size2, act, biases, int8_dots)
    _check_args(x, unit_params, dilations, kernel_size, kernel_size2, biases)
    if fold < 0 or tile_rows < 1:
        raise ValueError(f"need fold >= 0 and tile_rows >= 1, got fold="
                         f"{fold}, tile_rows={tile_rows}")
    if mode == "int8":
        shape = _shape(kernel_size, kernel_size2, act, biases, dilations)
        units = {"act": act, "act_param": act_param, "biases": biases}
        if int8_scale == "tile":
            return _int8_tile_stack(x, unit_params, dilations, fold,
                                    tile_rows, units, shape)
        return _int8_stack(x, unit_params, dilations, fold, units, shape)
    if x.device.type == "cpu":
        return folded_residual_stack_plain(
            x, unit_params, dilations, bf16_dots, act=act,
            act_param=act_param, biases=biases)
    _check_cuda(x, unit_params, biases)
    c = x.shape[1]
    bf16 = x.dtype == torch.bfloat16
    shape = _shape(kernel_size, kernel_size2, act, biases, dilations)
    kernel = route(mode, c, bf16, bf16_dots)
    if kernel == "mma":
        return _mma_stack(x, unit_params, dilations, kernel_size,
                          kernel_size2, act, act_param, biases, mode)
    if kernel == "wide":
        out = _wide_stack(x, unit_params, dilations, act, act_param, biases,
                          shape)
        wide_launches += 1
        return out
    out = resunit_stack(x, unit_params, dilations, act=act,
                        act_param=act_param, biases=biases, shape=shape)
    resunit_launches += 1
    return out


def resunit_stack(x: torch.Tensor, unit_params: Sequence,
                  dilations: Sequence[int], *, act: str = "elu_exp",
                  act_param: float = 0.0, biases=None,
                  shape: str = "") -> torch.Tensor:
    """One wrapper call of csrc/resunit_stack.cu, true f32 on the FMA units,
    one CUDA launch per unit: x contiguous (B, C, T) f32 on the card; act 'elu_exp' (the archived stack's exp(min(v, 0)) - 1),
    'elu' (expm1) or 'leaky_relu' (slope act_param); each conv's width its
    weights'.  The caller counts the call."""
    b, c, t = x.shape
    n = len(dilations)
    k, k2 = unit_params[0][0].shape[-1], unit_params[0][1].shape[-1]
    g = unit_geometry(c, k, k2, dilations)
    w1, w2, bias = _packed_unit(unit_params, biases, c, g.cp)
    dil = (ctypes.c_int * n)(*(int(d) for d in dilations))
    out = torch.empty_like(x)
    scratch = (torch.empty((min(n - 1, 2),) + tuple(x.shape),
                           device=x.device, dtype=torch.float32)
               if n > 1 else None)
    with torch.cuda.device(x.device):
        err = _resunit_kernel()(
            x.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), w1.data_ptr(),
            w2.data_ptr(), None if bias is None else bias.data_ptr(), b, c,
            t, g.cp, n, dil, k, k2, UNIT_ACT[act], float(act_param),
            g.threads, g.kc1, g.kc2, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"true-f32 residual stack kernel ({shape}): CUDA "
                           f"error {err}")
    return out


def _wide_stack(x, unit_params, dilations, act, act_param, biases, shape):
    """One wrapper call of csrc/wide_stack_mma.cu: the stack above C = 32
    with bf16 operands, in x's storage dtype, one CUDA launch per unit."""
    b, c, t = x.shape
    n = len(dilations)
    k, k2 = unit_params[0][0].shape[-1], unit_params[0][1].shape[-1]
    g = wide_geometry(c, k, k2, dilations)
    sp = wide_split(g, b, t, _sm_count(x.device.index))
    w1, w2, bias = _packed_wide(unit_params, biases, c, g.cp)
    dil = (ctypes.c_int * n)(*(int(d) for d in dilations))
    out = torch.empty_like(x)
    # the f32 sum s crosses the launches (storage_residual)
    scratch = (torch.empty((min(n - 1, 2),) + tuple(x.shape),
                           device=x.device, dtype=torch.float32)
               if n > 1 else None)
    with torch.cuda.device(x.device):
        err = _wide_kernel()(
            x.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), w1.data_ptr(),
            w2.data_ptr(), None if bias is None else bias.data_ptr(), b, c,
            t, g.cp, n, dil, k, k2, MMA_ACT[act], float(act_param), g.n,
            g.warpgroups, g.stages, int(x.dtype == torch.bfloat16),
            sp.seg, sp.nseg, sp.grid, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"wide tensor-core residual stack kernel "
                           f"({shape}): CUDA error {err}")
    return out


def _check_args(x, unit_params, dilations, kernel_size, kernel_size2,
                biases):
    if x.dim() != 3 or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be (B, C, T) float32 or bfloat16, got "
                        f"{tuple(x.shape)} {x.dtype}")
    c = x.shape[1]
    n = len(dilations)
    if n < 1 or len(unit_params) != n:
        raise ValueError(f"need one unit per dilation, at least one; got "
                         f"{len(unit_params)} units, {n} dilations")
    if kernel_size < 1 or kernel_size2 < 1 or min(dilations) < 1:
        raise ValueError(f"need k, k2 and dilations >= 1, got k="
                         f"{kernel_size}, k2={kernel_size2}, dilations="
                         f"{tuple(dilations)}")
    for w1, w2 in unit_params:
        if (tuple(w1.shape) != (c, c, kernel_size)
                or tuple(w2.shape) != (c, c, kernel_size2)):
            raise ValueError(f"unit weights {tuple(w1.shape)}, "
                             f"{tuple(w2.shape)} do not fit C={c}")
    if biases is not None and (
            len(biases) != n
            or any(tuple(bb.shape) != (c,) for u in biases for bb in u)):
        raise ValueError(f"need one (b1 ({c},), b2 ({c},)) per unit")


def _mma_stack(x, unit_params, dilations, kernel_size, kernel_size2, act,
               act_param, biases, mode):
    """One launch of csrc/folded_stack_mma.cu: the whole stack at C <= 32
    with bf16 operands, in x's storage dtype, counted by unit shape."""
    global mma_launches, mma_voc_launches, mma_other_launches
    b, c, t = x.shape
    n = len(dilations)
    shape = _shape(kernel_size, kernel_size2, act, biases, dilations)
    if n > MMA_MAX_UNITS:
        raise ValueError(f"csrc/folded_stack_mma.cu takes up to "
                         f"{MMA_MAX_UNITS} units, got {n} ({shape})")
    g = mma_geometry(c, kernel_size, kernel_size2, dilations)
    sp = mma_split(g, b, t, _sm_count(x.device.index))
    w, bias = _packed_mma_taps(unit_params, biases, c, g.cp, g.wgmma)
    dil = (ctypes.c_int * n)(*(int(d) for d in dilations))
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _mma_kernel()(
            x.data_ptr(), out.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(), b, c, t, g.cp, n, dil,
            kernel_size, kernel_size2, MMA_ACT[act], float(act_param),
            int(x.dtype == torch.bfloat16), g.warps, int(g.wgmma),
            int(g.resident), g.ybufs,
            sp.seg, sp.nseg, sp.warm, sp.grid,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"tensor-core residual stack kernel ({shape}): "
                           f"CUDA error {err}")
    if mode == "autoencoder":
        mma_launches += 1
    elif mode == "vocoder":
        mma_voc_launches += 1
        mma_voc_launches_by_k[kernel_size] = (
            mma_voc_launches_by_k.get(kernel_size, 0) + 1)
    else:
        mma_other_launches += 1
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


def int8_offset_schedule(k: int, d: int, f: int) -> list:
    """How a causal conv(k, dilation d) under fold f reads folded rows, per
    phase p = t mod f: the taps j grouped by the row offset
    o = (p + j d - span) // f they read, ascending (the order in which
    `_int8_conv` and csrc/int8_mma_stack.cu dequantize them):
    [[(o, (j, ...)), ...] for p in range(f)]."""
    span = (k - 1) * d
    phases = []
    for p in range(f):
        groups = {}
        for j in range(k):
            groups.setdefault((p + j * d - span) // f, []).append(j)
        phases.append(sorted((o, tuple(js)) for o, js in groups.items()))
    return phases


def int8_exact_small(c: int, k: int, d: int, f: int) -> bool:
    """Whether every int32 partial of a conv(k, d) (the taps of one offset
    times C channels of codes and weights within +-127) stays below 2^22,
    where csrc/int8_mma_stack.cu converts it to f32 with an add of
    1.5 x 2^23 instead of cvt.rn.f32.s32 (the same value)."""
    taps = max(len(js) for ph in int8_offset_schedule(k, d, f)
               for _, js in ph)
    return int(INT8_QMAX) ** 2 * c * taps < INT8_MMA_SMALL


class Int8MmaGeometry(NamedTuple):
    """A launch of csrc/int8_mma_stack.cu: channels padded to cp, f samples
    per folded row, tile output samples per block in `rounds` rounds of the
    warps' M tiles, the largest halo (samples), the rows per phase of
    conv1's output (r1: the tile's and the rows before it that conv2
    reads), the weight pipeline's stage (taps_per_stage taps of kc input
    channels) and its buffers, whether the f32 buffer of conv1's output is
    in device memory (s_global) rather than shared memory, the block's
    shared memory in bytes and the CUDA launches per wrapper call (one per
    unit)."""
    cp: int
    f: int
    tile: int
    rounds: int
    halo: int
    r1: int
    taps_per_stage: int
    kc: int
    buffers: int
    s_global: bool
    smem: int
    launches: int


def int8_mma_warps(cp: int) -> int:
    """Warps per block of csrc/int8_mma_stack.cu (its `warps_for`)."""
    return 8 if cp <= 64 else 16


def int8_mma_smem(cp: int, c: int, buffers: int, taps_per_stage: int,
                  kc: int, r1: int, f: int, rows: int,
                  s_global: bool = False) -> int:
    """Shared memory of a block (csrc/int8_mma_stack.cu `layout`): the
    weight stages' buffers (rows of kc + 16 bytes), the int8 activation
    rows of `rows` folded rows per phase (cp + 16 bytes), the f32 buffer of
    the C channels [c][r1 f + 1] unless it is in device memory, the rows'
    scales and conv1's rows' absmax."""
    return (buffers * taps_per_stage * cp * (kc + 16) + f * rows * (cp + 16)
            + (0 if s_global else 4 * c * (r1 * f + 1)) + 4 * rows + 4 * r1)


def int8_mma_geometry(c: int, f: int, kernel_size: int,
                      dilations: Sequence[int],
                      kernel_size2: int = 1) -> Int8MmaGeometry:
    """How csrc/int8_mma_stack.cu runs these units: warps of 2 M tiles
    (16 folded rows of one phase) x 32 channels each, 8 per block at
    cp <= 64 and 16 above (`int8_mma_warps`), so a round covers 4096 (8
    warps) or 16384 (16) / cp samples; the tile is that, rounded up to 16
    rows of every phase, in as many rounds as it takes; conv1 runs over
    r1 rows per phase, the tile's and the ceil((k2 - 1) / f) before it
    that conv2 reads, rounded up to whole M tiles.  The weights: two
    buffers of as many whole taps as fit beside the rest (kc = cp <= 128:
    all k at cp = 32, 6 at 64, 3 at 128, k = 7, dilations (1, 3, 9)); at
    cp = 256 one tap's 128 channels per stage, three buffers where they
    fit; at cp = 512 the widest stage of INT8_MMA_KC that fits two.  An
    8-warp block keeps to half an SM's shared memory where three taps fit
    in it.  Where nothing fits, the f32 buffer of conv1's output moves to
    device memory (s_global; C = 512 at f = 4).  Raises ValueError above
    C = 512 or where the halo leaves no room even so.  (Chosen on the card,
    PERF.md §6: fewer, larger stages and two blocks per SM ran fastest.)"""
    k, k2 = kernel_size, kernel_size2
    shape = (f"k={k}, k2={k2}, dilations={tuple(dilations)}, fold {f}, "
             f"C={c}")
    if c > INT8_MMA_CHANNELS[-1]:
        raise ValueError(f"csrc/int8_mma_stack.cu takes C up to "
                         f"{INT8_MMA_CHANNELS[-1]} ({shape})")
    cp = next(p for p in INT8_MMA_CHANNELS if c <= p)
    mpr = int8_mma_warps(cp) // (cp // INT8_MMA_NW) * INT8_MMA_MT
    tile = -(-16 * mpr // (16 * f)) * 16 * f
    rounds = -(-(tile // 16) // mpr)
    r = tile // f
    r1 = -(-(r - fold_offsets(k2, 1, f)[0]) // 16) * 16
    hrow = max(-(-(k - 1) * d // f) for d in dilations)
    rows = r1 + hrow
    for s_global in (False, True):
        for kc in (v for v in INT8_MMA_KC if v <= cp):
            fixed = int8_mma_smem(cp, c, 0, 0, kc, r1, f, rows, s_global)
            per_tap = int8_mma_smem(cp, c, 1, 1, kc, r1, f, rows,
                                    s_global) - fixed
            budget = BLOCK_SMEM
            if (int8_mma_warps(cp) == 8
                    and fixed + 3 * per_tap <= INT8_MMA_PAIR_SMEM):
                budget = INT8_MMA_PAIR_SMEM
            room = (budget - fixed) // per_tap   # tap buffers that fit
            if kc == cp:
                buffers, tps = 2, max(1, min(max(k, k2), room // 2))
            else:
                buffers, tps = (3 if room >= 3 else 2), 1
            smem = int8_mma_smem(cp, c, buffers, tps, kc, r1, f, rows,
                                 s_global)
            if smem <= BLOCK_SMEM:
                return Int8MmaGeometry(cp, f, tile, rounds, hrow * f, r1,
                                       tps, kc, buffers, s_global, smem,
                                       len(dilations))
    raise ValueError(
        f"csrc/int8_mma_stack.cu: a halo of {hrow * f} samples ({shape}) "
        f"leaves no room for a tile of {tile} samples in a block's "
        f"{BLOCK_SMEM} bytes of shared memory")


def _int8_stack(x, unit_params, dilations, fold, units, shape):
    """The int8 mode with "row" scales: the plain version on the CPU, else
    one wrapper call of csrc/int8_mma_stack.cu (one CUDA launch per
    unit)."""
    global int8_launches
    b, c, t = x.shape
    if x.device.type == "cpu":
        return folded_residual_stack_int8_plain(x, unit_params, dilations,
                                                fold, **units)
    _check_cuda(x, unit_params, units["biases"])
    n = len(dilations)
    k, k2 = unit_params[0][0].shape[-1], unit_params[0][1].shape[-1]
    f = fold or int8_fold(c)
    g = int8_mma_geometry(c, f, k, dilations, k2)
    tp = -(-t // f) * f
    w1, w2, scales, bias = _packed_int8(_pack_int8_mma, unit_params,
                                        units["biases"], c, g.cp)
    dil = (ctypes.c_int * n)(*(int(d) for d in dilations))
    exact = (ctypes.c_int * (2 * n))(*(
        e for d in dilations for e in (int8_exact_small(c, k, int(d), f),
                                       int8_exact_small(c, k2, 1, f))))
    # the kernel works on whole folded rows of f32 values: the tail pad's
    # zeros evolve like the TPU kernel's and enter the last row's scale
    xp = F.pad(x.float(), (0, tp - t)) if tp != t else x.float()
    out = torch.empty_like(xp)
    tmp = torch.empty_like(xp) if n > 1 else out
    sg = (torch.empty(b * -(-tp // g.tile) * c * (g.r1 * f + 1),
                      device=x.device, dtype=torch.float32)
          if g.s_global else None)
    with torch.cuda.device(x.device):
        err = _int8_kernel()(
            xp.data_ptr(), out.data_ptr(), tmp.data_ptr(), w1.data_ptr(),
            w2.data_ptr(), scales.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if sg is None else sg.data_ptr(), b, c, tp, g.cp, f, k,
            k2, n, dil, exact, MMA_ACT[units["act"]],
            float(units["act_param"]), g.tile, g.taps_per_stage, g.kc,
            g.buffers, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8-mode residual stack kernel ({shape}): "
                           f"CUDA error {err}")
    int8_launches += 1
    return out[:, :, :t].to(x.dtype).contiguous()


class Int8TileGeometry(NamedTuple):
    """A launch of csrc/int8_tile_mma.cu: channels padded to cp (a
    multiple of 32), ts output samples per block, mt M tiles per warp item,
    the unit pass's shared memory in bytes at the widest span, and the
    CUDA launches per wrapper call (two per unit and the windows'
    build)."""
    cp: int
    ts: int
    mt: int
    smem: int
    launches: int


def int8_tile_smem(cp: int, c: int, ts: int, k2: int, span: int) -> int:
    """Shared memory of the unit pass (csrc/int8_tile_mma.cu `layout`):
    q(act(v)) over conv1's m1 = ceil((ts + k2 - 1) / 16) M tiles and its
    span, q(act(conv1)) over the M tiles, rows of cp + 16 bytes, and y2 as
    f32 [ts][C | 1]."""
    m1 = -(-(ts + k2 - 1) // 16)
    return (16 * m1 + span) * (cp + 16) + 16 * m1 * (cp + 16) + 4 * ts * (c | 1)


def int8_tile_mma_geometry(c: int, kernel_size: int, kernel_size2: int,
                           dilations: Sequence[int]) -> Int8TileGeometry:
    """How csrc/int8_tile_mma.cu runs these units: channels padded to a
    multiple of 32; 4 M tiles per warp item from cp = 128 (each weight
    fragment read once for 64 samples), else 2; the tile the largest power
    of two from 16 to INT8_TILE_MAX_TS samples with ts x cp within
    INT8_TILE_WORK[mt] whose unit pass fits a block's shared memory at the
    widest span.  Raises ValueError where not even 16 samples fit beside
    the span."""
    k, k2 = kernel_size, kernel_size2
    cp = -(-c // 32) * 32
    mt = 4 if cp >= 128 else 2
    span = (k - 1) * max(dilations)
    ts = INT8_TILE_MAX_TS
    while ts > 16 and (ts * cp > INT8_TILE_WORK[mt]
                       or int8_tile_smem(cp, c, ts, k2, span) > BLOCK_SMEM):
        ts //= 2
    smem = int8_tile_smem(cp, c, ts, k2, span)
    if smem > BLOCK_SMEM:
        raise ValueError(
            f"csrc/int8_tile_mma.cu: a span of {span} samples (k={k}, "
            f"k2={k2}, dilations={tuple(dilations)}) leaves no tile of 16 "
            f"samples in a block's {BLOCK_SMEM} bytes of shared memory at "
            f"C={c}")
    return Int8TileGeometry(cp, ts, mt, smem, 2 * len(dilations) + 1)


def _int8_tile_stack(x, unit_params, dilations, fold, tile_rows, units,
                     shape):
    """The int8 mode with "tile" scales: the plain version on the CPU, else
    one wrapper call of csrc/int8_tile_mma.cu (2 n_units + 1 CUDA
    launches) on the tiles' windows, which it builds in `win`, with the
    quantized act(v) a unit's scale pass hands its unit pass in `codes`."""
    global int8_tile_launches
    b, c, t = x.shape
    if x.device.type == "cpu":
        return folded_residual_stack_int8_tile_plain(
            x, unit_params, dilations, fold, tile_rows, **units)
    _check_cuda(x, unit_params, units["biases"])
    n = len(dilations)
    k, k2 = unit_params[0][0].shape[-1], unit_params[0][1].shape[-1]
    g = tile_geometry(c, t, dilations, fold, tile_rows, k, k2)
    tg = int8_tile_mma_geometry(c, k, k2, dilations)
    w1, w2, scales, bias = _packed_int8(_pack_int8_tile, unit_params,
                                        units["biases"], c, tg.cp)
    dil = (ctypes.c_int * n)(*(int(d) for d in dilations))
    cuts = (ctypes.c_int * n)(*(-fold_offsets(k, int(d), g.f)[0] * g.f
                                for d in dilations))
    cut2 = -fold_offsets(k2, 1, g.f)[0] * g.f if k2 > 1 else 0
    windows = b * g.n_tiles
    win = torch.empty((min(n, 2), windows, g.window, c), device=x.device,
                      dtype=torch.float32)
    codes = torch.empty((windows, g.window, tg.cp), device=x.device,
                        dtype=torch.int8)
    scal = torch.empty((2, n, windows), device=x.device, dtype=torch.int32)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _int8_tile_kernel()(
            x.data_ptr(), out.data_ptr(), win.data_ptr(), codes.data_ptr(),
            scal.data_ptr(),
            w1.data_ptr(), w2.data_ptr(), scales.data_ptr(),
            None if bias is None else bias.data_ptr(), b, c, t, tg.cp,
            g.n_tiles, g.rows_tile * g.f, g.halo * g.f, g.window, n, dil,
            cuts, k, k2, cut2, MMA_ACT[units["act"]],
            float(units["act_param"]), tg.ts, tg.mt,
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8 tile-mode residual stack kernel ({shape}): "
                           f"CUDA error {err}")
    int8_tile_launches += 1
    return out
