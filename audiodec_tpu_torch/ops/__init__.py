"""Tensor ops: convolutions, activations, RVQ, and the CUDA kernels."""
