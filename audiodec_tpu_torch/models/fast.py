"""Batch inference through the fused residual-stack kernels (counterpart of
audiodec_tpu/models/fast.py: `_use_folded`, `res_stack_auto` with its int8
branch, `encoder_apply_folded`, `decoder_apply_folded`, and the vocoder fast
path
`_voc_resblock_params`, `_voc_use_folded`, `_voc_resblock_folded`,
`_voc_fusion_auto`, `vocoder_apply_folded`).

The stacks and resblocks that the JAX package sends to its folded kernel go
to the CUDA kernels; the rest stay plain cuDNN convs.  With int8=True every
decoder stack, of any width, goes to the kernel's int8 mode.  The batch-fold
paths wait for a later slice.
"""

from __future__ import annotations

import warnings
from functools import partial

from audiodec_tpu_torch.models.autoencoder import (
    GeneratorConfig,
    decoder_bct,
    encoder_bct,
    res_stack_plain,
)
from audiodec_tpu_torch.models.vocoder import (
    VocoderConfig,
    _fusion_apply,
    fusion_bct,
    vocoder_bct,
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
                   bf16_dots: bool = True, int8: bool = False):
    """Residual stack of a block: the kernel where the JAX package uses its
    folded kernel, plain convs otherwise.  x: (B, C, T).

    int8=True (the int8 decode): every stack, of any width, goes to the
    kernel's int8 mode, which needs param-free ELU units; with any other
    activation it warns, as JAX does, and takes the normal route."""
    _, c, t = x.shape
    if int8:
        if (cfg.nonlinear_activation == "ELU"
                and not cfg.nonlinear_activation_params):
            return folded_residual_stack(
                x, res_stack_params(block_params),
                dilations=tuple(cfg.res_dilations),
                kernel_size=cfg.res_kernel_size, int8_dots=True)
        warnings.warn(
            f"int8 residual stacks require param-free ELU activation "
            f"(got {cfg.nonlinear_activation}"
            f"{dict(cfg.nonlinear_activation_params) or ''}); "
            f"falling back to the non-int8 path")
    if _use_folded(c, t, cfg):
        return folded_residual_stack(
            x, res_stack_params(block_params),
            dilations=tuple(cfg.res_dilations),
            kernel_size=cfg.res_kernel_size, bf16_dots=bf16_dots)
    return res_stack_plain(x, block_params, cfg)


def _require_folded(cfg: GeneratorConfig):
    # JAX asserts the same (models/fast.py:82, :97)
    if cfg.mode != "causal" or cfg.codec != "audiodec":
        raise ValueError(f"the folded path takes the causal audiodec codec, "
                         f"not mode={cfg.mode}, codec={cfg.codec}")


def encoder_apply_folded(p, x, cfg: GeneratorConfig, bf16_dots: bool = True):
    """Batch causal encoder.  x: (B, T, C_in) -> (B, T', C_enc)."""
    _require_folded(cfg)
    stack = partial(res_stack_auto, bf16_dots=bf16_dots)
    return encoder_bct(p, x.transpose(1, 2), cfg, stack).transpose(1, 2)


def decoder_apply_folded(p, z, cfg: GeneratorConfig, bf16_dots: bool = True,
                         int8: bool = False):
    """Batch causal decoder.  z: (B, T', D) -> (B, T, C_out).  int8=True:
    every residual stack in the kernel's int8 mode; the transposed and the
    plain convs keep their input dtype."""
    _require_folded(cfg)
    stack = partial(res_stack_auto, bf16_dots=bf16_dots, int8=int8)
    return decoder_bct(p, z.transpose(1, 2), cfg, stack).transpose(1, 2)


# ---------------------------------------------------------------------------
# vocoder fast path (HiFiGAN resblocks in the kernel's vocoder mode)
# ---------------------------------------------------------------------------

def _voc_resblock_params(p_block):
    """((w1, w2), ...) and the biases (or None) from a vocoder resblock's
    convs1/convs2 lists."""
    units = tuple((c1["w"], c2["w"])
                  for c1, c2 in zip(p_block["convs1"], p_block["convs2"]))
    if "b" in p_block["convs1"][0]:
        biases = tuple((c1["b"], c2["b"])
                       for c1, c2 in zip(p_block["convs1"],
                                         p_block["convs2"]))
    else:
        biases = None
    return units, biases


def _voc_use_folded(cfg: VocoderConfig, c: int, t: int) -> bool:
    # verbatim from the JAX package: it decides which stages take bf16
    # operands, so a looser rule would change the numbers against JAX
    f = max(1, 128 // max(c, 1))
    return (cfg.use_additional_convs
            and cfg.nonlinear_activation == "LeakyReLU"
            and f >= 4 and t % f == 0)


def _voc_resblock_folded(p_block, x, *, kernel_size, dilations, slope,
                         bf16_dots):
    units, biases = _voc_resblock_params(p_block)
    return folded_residual_stack(
        x, units, dilations=tuple(dilations), kernel_size=kernel_size,
        kernel_size2=kernel_size, act="leaky_relu", act_param=slope,
        biases=biases, bf16_dots=bf16_dots)


def _voc_fusion_auto(p, x, cfg: VocoderConfig, bf16_dots: bool = True):
    """Fusion block (MultiGroupConv1d: the groups' dense resblocks on weight
    slices; MultiReceptiveField: the mean of its resblocks) with the
    resblocks in the kernel where the JAX package uses its folded kernel,
    plain convs otherwise.  x: (B, C, T)."""
    _, c, t = x.shape
    if not _voc_use_folded(cfg, c, t):
        return _fusion_apply(p, x, cfg)
    slope = dict(cfg.nonlinear_activation_params).get("negative_slope", 0.01)

    def resblock(p_block, x, kernel_size, dilations, _groups):
        return _voc_resblock_folded(p_block, x, kernel_size=kernel_size,
                                    dilations=dilations, slope=slope,
                                    bf16_dots=bf16_dots)

    return fusion_bct(p, x, cfg, resblock)


def vocoder_apply_folded(p, c, cfg: VocoderConfig, bf16_dots: bool = True):
    """Batch vocoder decode with its low-channel, high-rate resblocks in
    the kernel.  c: (B, T, D) codes -> (B, T * hop, out_channels)."""
    fusion = partial(_voc_fusion_auto, bf16_dots=bf16_dots)
    return vocoder_bct(p, c.transpose(1, 2), cfg, fusion).transpose(1, 2)
