"""Least time an H100 could take for each TPU kernel of the repo, at the
shapes its caller gives it: `python -m audiodec_tpu_torch.bin.kernel_bounds`.

The bound is the larger of the bytes the function must move (each input
read once, each output written once) over the memory rate, and its
operations over the card's peak for their type.  Peaks are the H100 SXM
data sheet's, dense, at its 700 W power limit.  Needs no card: it reckons
from shapes only, and prints one JSON line per kernel (or mode) and launch
shape.
"""

from __future__ import annotations

import json

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}

BATCH, SAMPLES = 16, 480000          # B=16 x 10 s at 48 kHz
HOP, CODE_DIM, CODEBOOKS, CODES = 300, 64, 8, 1024
F32, BF16, INT8, INT32 = 4, 2, 1, 4
# (C, T) of the symAD residual stacks at B=16 x 10 s: encoder block i, and
# decoder block 3 - i
SYMAD_STACKS = ((32, SAMPLES), (64, 160000), (128, 40000), (256, 8000))
# (C, T) of the 48 kHz HiFiGAN vocoders' stages above C = 32 at B=16 x
# 10 s, whose resblocks (k = k2 = 11 in AD v1; 3, 7 and 11 in AD v0) take
# csrc/wide_stack_mma.cu in bf16
VOC_WIDE_STAGES = ((256, 8000), (128, 40000), (64, 160000))


def bound_ms(nbytes: float, ops: float, peak: str) -> dict:
    row = {"bytes_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
           "operations_ms": 1e3 * ops / PEAK_OPS_PER_S[peak]}
    row["bound_ms"] = max(row["bytes_ms"], row["operations_ms"])
    row["bound_by"] = ("bytes" if row["bytes_ms"] >= row["operations_ms"]
                       else "operations")
    return row


def residual_stack(b, t, c, *, k, k2, storage, weight, peak,
                   units=3, bias=False) -> dict:
    """One chain of `units` causal residual units at (b, c, t)."""
    act = b * c * t * storage
    weights = units * (k + k2) * c * c * weight
    biases = units * 2 * c * weight if bias else 0
    ops = units * (k + k2) * c * c * 2 * b * t
    return bound_ms(2 * act + weights + biases, ops, peak)


def autoencoder_stack(b, t, c, storage=F32) -> dict:
    """The folded stack's autoencoder mode with bf16 dots at (b, c, t):
    three k=7 units, the activation and weights in the storage dtype, the
    dots at the bf16 peak."""
    return residual_stack(b, t, c, k=7, k2=1, storage=storage,
                          weight=storage, peak="bf16")


def mma_stack(b, t, c, *, k=7, k2=1, storage=F32, bias=False,
              units=3) -> dict:
    """csrc/folded_stack_mma.cu at (b, c, t): `units` units of the given
    shape, the activation in the storage dtype, bf16 weights and biases
    (the biases are f32 on the card, a few hundred bytes), the dots at the
    bf16 peak."""
    return residual_stack(b, t, c, k=k, k2=k2, storage=storage, weight=BF16,
                          peak="bf16", units=units, bias=bias)


def int8_stack(b, t, c, storage=F32) -> dict:
    """The folded stack's int8 modes ("row" or "tile" scales) at (b, c, t):
    three k=7 units, the activation in the storage dtype, int8 weights,
    the dots at the int8 peak.  The tile mode's windows are its design's
    cost, not the work's."""
    return residual_stack(b, t, c, k=7, k2=1, storage=storage,
                          weight=INT8, peak="int8")


def resunit_stack(b, t, c, *, k=7, k2=1, units=3, bias=False) -> dict:
    """csrc/resunit_stack.cu at (b, c, t): `units` units of any shape in
    true f32 (f32 activation, weights and biases, the FMA units' peak); by
    default the archived fused stack's three k=7 units."""
    return residual_stack(b, t, c, k=k, k2=k2, storage=F32, weight=F32,
                          peak="f32", units=units, bias=bias)


def rvq_encode(n, d=CODE_DIM, q=CODEBOOKS, codes=CODES) -> dict:
    """The fused RVQ encode of n frames: z read, the codebooks and their
    norms read, idx and zq written; the cross terms' FLOP in f32."""
    nbytes = (n * d * F32 + q * codes * (d + 1) * F32 + n * q * INT32
              + n * d * F32)
    return bound_ms(nbytes, q * 2 * n * codes * d, "f32")


def dot_chain(m, dots, peak) -> dict:
    """The rate probe's chain: x (m, 128) read, w (dots, 128, 128) read and
    the output written in the dtype of `peak`; 2 * m * dots * 128^2
    operations."""
    size = {"bf16": BF16, "int8": INT8, "f32": F32}[peak]
    return bound_ms((2 * m * 128 + dots * 128 * 128) * size,
                    2 * m * dots * 128 * 128, peak)


def ablate_stack(b, t, c, storage=F32) -> dict:
    """The ablation probe's stack at (b, c, t): three k=7 units, the
    activation in the storage dtype, bf16 weights and dots."""
    return residual_stack(b, t, c, k=7, k2=1, storage=storage, weight=BF16,
                          peak="bf16")


def rows():
    """(function, mode, shape note, bound) for every pallas_call function."""
    stack = "audiodec_tpu/ops/pallas/folded_stack.py:112"
    out = [
        (stack, "autoencoder, f32 storage, bf16 dots (encoder block 0)",
         [BATCH, SAMPLES, 32],
         residual_stack(BATCH, SAMPLES, 32, k=7, k2=1, storage=F32,
                        weight=F32, peak="bf16")),
        (stack, "autoencoder, bf16 (decoder block 3)", [BATCH, SAMPLES, 32],
         residual_stack(BATCH, SAMPLES, 32, k=7, k2=1, storage=BF16,
                        weight=BF16, peak="bf16")),
        (stack, "vocoder, bf16, k=11 (AD v1, per group; 3 per decode)",
         [BATCH, SAMPLES, 32],
         residual_stack(BATCH, SAMPLES, 32, k=11, k2=11, storage=BF16,
                        weight=BF16, peak="bf16", bias=True)),
    ]
    # the tensor-core kernel (csrc/folded_stack_mma.cu) at the same shapes
    for name, size in (("f32", F32), ("bf16", BF16)):
        out.append((stack, f"tensor cores, autoencoder units, {name} "
                           f"storage", [BATCH, SAMPLES, 32],
                    mma_stack(BATCH, SAMPLES, 32, storage=size)))
    out.append((stack, "tensor cores, vocoder units, k=11, bf16 storage "
                       "(AD v1, per group)", [BATCH, SAMPLES, 32],
                mma_stack(BATCH, SAMPLES, 32, k=11, k2=11, storage=BF16,
                          bias=True)))
    # the vocoders' resblocks above C = 32 (csrc/wide_stack_mma.cu)
    for c, t in VOC_WIDE_STAGES:
        for k in (11, 7, 3):
            out.append((stack, f"tensor cores, vocoder units above C = 32, "
                               f"k={k}, bf16 storage (one resblock)",
                        [BATCH, t, c],
                        mma_stack(BATCH, t, c, k=k, k2=k, storage=BF16,
                                  bias=True)))
    # int8 mode: every symAD decoder stack, f32 storage, int8 dots
    for c, t in reversed(SYMAD_STACKS):
        out.append((stack, f"int8, decoder stack at C={c}", [BATCH, t, c],
                    int8_stack(BATCH, t, c)))
    # tools/folded_probe.py's shapes (the symAD stacks), f32 storage: the
    # autoencoder mode with bf16 dots and the int8 mode with "tile" scales
    for c, t in SYMAD_STACKS:
        out.append((stack, f"autoencoder, bf16 dots, probe shape at C={c}",
                    [BATCH, t, c], autoencoder_stack(BATCH, t, c)))
    for c, t in SYMAD_STACKS:
        out.append((stack, f"int8, tile scales, probe shape at C={c}",
                    [BATCH, t, c], int8_stack(BATCH, t, c)))
    # rvq_encode_pallas: strict-f32 distances, argmin, gather, update
    out.append(("audiodec_tpu/archive/vq_kernel.py:62", "f32",
                [BATCH, SAMPLES // HOP, CODE_DIM, CODEBOOKS, CODES],
                rvq_encode(BATCH * SAMPLES // HOP)))
    # fused_residual_stack: every stack of the fused transcode, true f32
    for where, blocks in (("encoder", range(4)), ("decoder", range(3, -1, -1))):
        for i in blocks:
            c, t = SYMAD_STACKS[i]
            out.append(("audiodec_tpu/archive/resunit_kernel.py:57",
                        f"f32 stack, {where} block "
                        f"{i if where == 'encoder' else 3 - i}",
                        [BATCH, t, c], resunit_stack(BATCH, t, c)))
    # tools/folded_ablate.py's build: its C = 32 shape and the symAD
    # stacks', in both storage dtypes
    for c, t in SYMAD_STACKS:
        for name, size in (("f32", F32), ("bf16", BF16)):
            out.append(("tools/folded_ablate.py:34",
                        f"folded stack variants, {name} storage, bf16 dots",
                        [BATCH, t, c], ablate_stack(BATCH, t, c, size)))
    # mxu_rate_probe defaults: 120 tiles of (1024, 128) @ 64 x (128, 128)
    m, dots = 120 * 1024, 64
    for name in ("bf16", "int8", "f32"):
        out.append(("tools/mxu_rate_probe.py:33", f"dot chain, {name}",
                    [m, 128, dots], dot_chain(m, dots, name)))
    return out


def main():
    for fn, mode, shape, b in rows():
        print(json.dumps({"function": fn, "mode": mode, "shape": shape,
                          "peaks": "H100 SXM data sheet, 700 W", **b}))


if __name__ == "__main__":
    main()
