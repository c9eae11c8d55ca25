"""Archived paths (counterpart of audiodec_tpu/archive/): code that lost its
A/B on the TPU and is kept there for the measurement record, not for
production.

- resunit_kernel.py: the per-tap fused residual stack, at every width, as
  the CUDA kernel csrc/resunit_stack.cu;
- vq_kernel.py: the fused RVQ encode, as the CUDA kernel
  csrc/rvq_encode.cu;
- fast_experiments.py: the encoder and decoder over the residual-stack
  kernel (the fused transcode of bin/fused_probe.py).

In the port these kernels are held to the same bar as any other: each has
a plain PyTorch version beside it, the CPU tests hold that to the JAX
function, and chip_smoke.py holds the kernel to it on the card.
"""
