"""Encoder and decoder over the archived residual stacks (counterpart of
audiodec_tpu/archive/fast_experiments.py).

`*_fused`: every residual stack, at every width (C = 32/64/128/256 for
symAD), goes to archive/resunit_kernel.py's (B, C, T) entry; the other
convs are plain.  Equal to models/autoencoder.py `encoder_apply` /
`decoder_apply` within f32 rounding, with the TPU kernel's ELU
(exp(min(v, 0)) - 1) in the stacks.

`*_blocked`: every residual stack in archive/blocked.py's block-packed
layout (plain convs; JAX's runs no Pallas kernel either), equal to the
flat encoder and decoder within f32 rounding.
"""

from __future__ import annotations

from audiodec_tpu_torch.archive.blocked import blocked_res_stack
from audiodec_tpu_torch.archive.resunit_kernel import (
    fused_residual_stack_bct,
    res_stack_params,
)
from audiodec_tpu_torch.models.autoencoder import (
    GeneratorConfig,
    decoder_bct,
    encoder_bct,
)


def _stack(x, block_params, cfg: GeneratorConfig):
    """A block's residual stack in the kernel.  x: (B, C, T) float32."""
    return fused_residual_stack_bct(
        x, res_stack_params(block_params),
        dilations=tuple(cfg.res_dilations),
        kernel_size=cfg.res_kernel_size)


def encoder_apply_fused(p, x, cfg: GeneratorConfig):
    """Batch causal encoder with fused residual stacks.  x: (B, T, C_in)
    float32 -> (B, T', C_enc).  JAX's `tile_t` and `interpret` have no
    counterpart: the kernel needs no time tile from its caller."""
    assert cfg.mode == "causal" and cfg.codec == "audiodec"
    return encoder_bct(p, x.transpose(1, 2), cfg, _stack).transpose(1, 2)


def decoder_apply_fused(p, z, cfg: GeneratorConfig):
    """Batch causal decoder with fused residual stacks.  z: (B, T', D)
    float32 -> (B, T, C_out)."""
    assert cfg.mode == "causal" and cfg.codec == "audiodec"
    return decoder_bct(p, z.transpose(1, 2), cfg, _stack).transpose(1, 2)


def _blocked_stack(x, block_params, cfg: GeneratorConfig):
    return blocked_res_stack(x, block_params["res"],
                             dilations=tuple(cfg.res_dilations), act=cfg.act)


def encoder_apply_blocked(p, x, cfg: GeneratorConfig):
    """Batch causal encoder with block-packed residual stacks.
    x: (B, T, C_in) -> (B, T', C_enc)."""
    assert cfg.mode == "causal" and cfg.codec == "audiodec"
    return encoder_bct(p, x.transpose(1, 2), cfg,
                       _blocked_stack).transpose(1, 2)


def decoder_apply_blocked(p, z, cfg: GeneratorConfig):
    """Batch causal decoder with block-packed residual stacks.
    z: (B, T', D) -> (B, T, C_out)."""
    assert cfg.mode == "causal" and cfg.codec == "audiodec"
    return decoder_bct(p, z.transpose(1, 2), cfg,
                       _blocked_stack).transpose(1, 2)
