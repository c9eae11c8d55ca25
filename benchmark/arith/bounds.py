"""The least time an H100 could take, a frozen copy of the arithmetic of
audiodec_tpu_torch/bin/kernel_bounds.py (`bound_ms`, `residual_stack`,
`mma_stack`) and its peaks.

Peaks: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the
card's full 700 W power limit.  A bound is the larger of the bytes over the
memory rate (each input read once, each output written once) and the
operations over the peak of their type.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12,
              "f32": 67e12}
F32, BF16 = 4, 2
SIZES = {"f32": F32, "bf16": BF16}


def bound_s(nbytes: float, ops: float, peak: str) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[peak])


def residual_stack(b, t, c, *, k, k2, storage, weight, peak, units=3,
                   bias=False) -> float:
    """One chain of `units` causal residual units at (b, c, t), seconds."""
    act = b * c * t * storage
    weights = units * (k + k2) * c * c * weight
    biases = units * 2 * c * weight if bias else 0
    ops = units * (k + k2) * c * c * 2 * b * t
    return bound_s(2 * act + weights + biases, ops, peak)


def mma_stack(b, t, c, *, k=7, k2=1, storage=F32, bias=False,
              units=3) -> float:
    """csrc/folded_stack_mma.cu at (b, c, t): bf16 weights, the activation
    in the storage dtype, the dots at the bf16 peak."""
    return residual_stack(b, t, c, k=k, k2=k2, storage=storage, weight=BF16,
                          peak="bf16", units=units, bias=bias)
