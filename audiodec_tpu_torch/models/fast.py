"""Batch inference through the fused residual-stack kernel (counterpart of
audiodec_tpu/models/fast.py: `_use_folded`, `res_stack_auto`,
`encoder_apply_folded`, `decoder_apply_folded`).

The stacks that the JAX package sends to its folded kernel go to the CUDA
kernel; the rest stay plain cuDNN convs.  The batch-fold and int8 paths
wait for later slices.
"""

from __future__ import annotations

from functools import partial

from audiodec_tpu_torch.models.autoencoder import (
    GeneratorConfig,
    decoder_bct,
    encoder_bct,
    res_stack_plain,
)
from audiodec_tpu_torch.ops.kernels.folded_stack import (
    folded_residual_stack,
    res_stack_params,
)


def _use_folded(c: int, t: int, cfg: GeneratorConfig) -> bool:
    # verbatim from the JAX package: it decides which stacks take bf16
    # operands, so a looser rule would change the numbers against JAX
    f = max(1, 128 // max(c, 1))
    return (cfg.nonlinear_activation == "ELU"
            and not cfg.nonlinear_activation_params
            and f >= 4 and t % f == 0)


def res_stack_auto(x, block_params, cfg: GeneratorConfig,
                   bf16_dots: bool = True):
    """Residual stack of a block: the kernel where the JAX package uses its
    folded kernel, plain convs otherwise.  x: (B, C, T)."""
    _, c, t = x.shape
    if _use_folded(c, t, cfg):
        return folded_residual_stack(
            x, res_stack_params(block_params),
            dilations=tuple(cfg.res_dilations),
            kernel_size=cfg.res_kernel_size, bf16_dots=bf16_dots)
    return res_stack_plain(x, block_params, cfg)


def encoder_apply_folded(p, x, cfg: GeneratorConfig, bf16_dots: bool = True):
    """Batch causal encoder.  x: (B, T, C_in) -> (B, T', C_enc)."""
    stack = partial(res_stack_auto, bf16_dots=bf16_dots)
    return encoder_bct(p, x.transpose(1, 2), cfg, stack).transpose(1, 2)


def decoder_apply_folded(p, z, cfg: GeneratorConfig, bf16_dots: bool = True):
    """Batch causal decoder.  z: (B, T', D) -> (B, T, C_out)."""
    stack = partial(res_stack_auto, bf16_dots=bf16_dots)
    return decoder_bct(p, z.transpose(1, 2), cfg, stack).transpose(1, 2)
