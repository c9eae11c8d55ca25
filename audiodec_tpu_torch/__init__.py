"""AudioDec in PyTorch for one NVIDIA H100, beside the JAX package.

The JAX package `audiodec_tpu` is the reference; this package imports
nothing of it (not even its numpy-only modules), nor JAX, nor PyYAML.  It
needs torch, numpy and the standard library, plus `nvcc` on the machine with
the card to build its CUDA kernels at first use.

Layout: inside the package every activation is (B, C, T), the layout cuDNN
and the hand-written kernels take.  Model entry points (`encoder_apply*`,
`decoder_apply*`, `BatchTranscoder`) take and return JAX's (B, T, C), and
the RVQ functions work on (..., D) rows as JAX's do, so that a test feeds
both packages the same arrays.  Convolution weights are stored in torch's
orientation: conv (O, I, K), transposed conv (I, O, K).

Devices: entry points run on CUDA unless the caller passes device="cpu";
without a card they raise.  On a CPU tensor a kernel wrapper runs its plain
PyTorch version; on a CUDA tensor it launches the kernel or raises.
"""

__version__ = "0.1.0"
