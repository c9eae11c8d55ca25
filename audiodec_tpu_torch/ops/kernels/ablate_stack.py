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
of 32 channels, in the geometry of `ablate_wide_geometry`), which takes C
up to what one block's shared memory holds at one warp of one m16 tile
(`csrc/ablate_stack.cu`: 1312 in every variant at d <= 9), and raises
above it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

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
# the wide route's blocks: 32 output channels per warp, at most
# WIDE_MAX_WARPS warps (half as many where a thread holds more than 64
# sums: its register sets of 16 sums per m16 tile, WIDE_SETS) and
# WIDE_MAX_ROWS output samples, weight stages of one of WIDE_KC input
# channels.  WIDE_MTW caps the m16 tiles per warp by variant: the fastest
# at the symAD widths on the card (PERF.md §6)
WIDE_WARP_N = 32
WIDE_MAX_WARPS = 16
WIDE_MAX_ROWS = 256
WIDE_KC = (128, 64, 32, 16)
WIDE_SETS = {"im2col": 1, "tree": 3}
WIDE_SETS_DEFAULT = 2
WIDE_MTW = {"im2col": 4, "noshift": 4, "tree": 1}
WIDE_MTW_DEFAULT = 2
BLOCK_SMEM = 232448   # bytes of shared memory a block may use on sm_90

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


class AblateWideGeometry(NamedTuple):
    """A unit launch of the wide route (C > 32): channels padded to cp;
    blocks of warps_m x warps_n warps, each warp mtw m16 tiles (16 mtw
    samples) x 32 output channels, so `rows` = 16 mtw warps_m output
    samples a block; the channels walked in `passes` of 32 warps_n; the
    look-back `look` (the largest unit's); weight stages of kc input
    channels in `buffers` ring buffers; `smem` bytes of shared memory."""
    cp: int
    mtw: int
    warps_m: int
    warps_n: int
    passes: int
    rows: int
    look: int
    kc: int
    buffers: int
    smem: int


def ablate_wide_smem(cp: int, yrows: int, a2rows: int, warps_n: int,
                     kc: int, buffers: int) -> int:
    """Shared memory of a wide block (csrc/ablate_stack.cu `wide_smem`):
    the staged ELU(v) as `yrows` bf16 rows of cp + 8, a2's own `a2rows`
    rows where the channels take more than one pass (else a2 replaces the
    staged rows), and the ring of weight stages, 32 warps_n bf16 rows of
    kc + 8 each."""
    return 2 * ((yrows + a2rows) * (cp + 8)
                + buffers * WIDE_WARP_N * warps_n * (kc + 8))


def unit_look(d: int, f: int, variant: str) -> int:
    """The samples a unit at dilation d reads before its output: 6d, or
    noshift's f * span + f - 1 (span = ceil(6d / f) folded rows)."""
    if variant == "noshift":
        return f * -(-(KERNEL_SIZE - 1) * d // f) + f - 1
    return (KERNEL_SIZE - 1) * d


def wide_max_warps(variant: str, mtw: int) -> int:
    """The most warps a wide block of the variant holds at mtw m16 tiles a
    warp (csrc/ablate_stack.cu `wide_max_warps`)."""
    sets = WIDE_SETS.get(variant, WIDE_SETS_DEFAULT)
    return WIDE_MAX_WARPS // 2 if sets * mtw > 4 else WIDE_MAX_WARPS


def ablate_wide_geometry(c: int, variant: str = "default",
                         dilations: Sequence[int] = (1, 3, 9)
                         ) -> AblateWideGeometry:
    """How csrc/ablate_stack.cu runs a unit above C = 32: the fewest passes
    over the channels (warps_n = ceil(groups / passes) of the cp / 32
    groups, at most WIDE_MAX_WARPS), then the most m16 tiles per warp (up
    to the variant's WIDE_MTW), the most warp rows (up to wide_max_warps
    warps and WIDE_MAX_ROWS samples), the widest weight stage (WIDE_KC,
    dividing cp) and the most buffers (3, then 2) that fit a block's
    shared memory.  Raises ValueError where nothing fits."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    if c <= NARROW_CHANNELS:
        raise ValueError(f"C={c}: the wide route takes C > "
                         f"{NARROW_CHANNELS}")
    cp = padded_channels(c)
    f = fold_factor(c)
    look = max(unit_look(d, f, variant) for d in dilations)
    groups = cp // WIDE_WARP_N
    cap = WIDE_MTW.get(variant, WIDE_MTW_DEFAULT)
    for passes in range(1, groups + 1):
        wn = -(-groups // passes)
        if wn > WIDE_MAX_WARPS or -(-groups // wn) != passes:
            continue
        mtw = cap
        while mtw >= 1:
            for wm in range(min(wide_max_warps(variant, mtw) // wn,
                                WIDE_MAX_ROWS // (16 * mtw)), 0, -1):
                rows = 16 * mtw * wm
                a2rows = rows if passes > 1 else 0
                for kc in (v for v in WIDE_KC if cp % v == 0):
                    for buffers in (3, 2):
                        smem = ablate_wide_smem(cp, rows + look, a2rows, wn,
                                                kc, buffers)
                        if smem <= BLOCK_SMEM:
                            return AblateWideGeometry(
                                cp, mtw, wm, wn, passes, rows, look, kc,
                                buffers, smem)
            mtw //= 2
    raise ValueError(
        f"csrc/ablate_stack.cu ({variant}): a look-back of {look} samples "
        f"(dilations={tuple(dilations)}) leaves no tile in a block's "
        f"{BLOCK_SMEM} bytes of shared memory at C={c}")


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
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 15 \
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
    geo = (0,) * 5  # the wide route's geometry, unused at C <= 32
    if c > NARROW_CHANNELS:
        g = ablate_wide_geometry(c, variant, dilations)
        geo = (g.mtw, g.warps_m, g.warps_n, g.kc, g.buffers)
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
                        int(x.dtype == torch.bfloat16), *geo,
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ablate stack kernel ({variant}, C={c}): CUDA "
                           f"error {err}")
    launches += 1
    return out
