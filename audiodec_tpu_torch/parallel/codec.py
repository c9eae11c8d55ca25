"""Receptive-field halos of the chunked codec (counterpart of
audiodec_tpu/parallel/codec.py: `encoder_halo_samples`,
`decoder_halo_frames`, `vocoder_halo_frames`).

Every op of the codec is a causal FIR conv, so a chunk of a signal that
carries this much real left context computes the same outputs as the whole
signal.  The batch folds of models/fast.py cut one utterance into chunks
with these halos.  The sharded codec (`make_sharded_codec`) is not ported
yet; these are pure functions of a config.
"""

from __future__ import annotations

import math
from typing import Optional

from audiodec_tpu_torch.models.autoencoder import GeneratorConfig
from audiodec_tpu_torch.models.vocoder import VocoderConfig


def encoder_halo_samples(cfg: GeneratorConfig,
                         through_blocks: Optional[int] = None) -> int:
    """Left-context halo in samples, rounded up to a hop multiple so that
    every frame keeps its stride phase across chunk seams.

    through_blocks: the halo of conv0 and the first `through_blocks`
    encoder blocks only (not the projector), aligned to the rate after
    them: what a partial encoder fold needs (models/fast.py
    `unfold_after`).  None: the whole encoder and the projector."""
    hop = cfg.hop_length
    if through_blocks is None:
        rf = cfg.receptive_field
        return math.ceil((rf - 1) / hop) * hop
    strides = tuple(cfg.enc_strides)
    u = min(through_blocks, len(strides))
    rf = 1 + (cfg.kernel_size - 1)
    rate = 1
    for i in range(u):
        for d in tuple(cfg.res_dilations):
            rf += (cfg.res_kernel_size - 1) * d * rate
        rf += (2 * strides[i] - 1) * rate
        rate *= strides[i]
    align = hop if u == len(strides) else rate
    return math.ceil((rf - 1) / align) * align


def decoder_halo_frames(cfg: GeneratorConfig, from_stage: int = 0) -> int:
    """Decoder receptive field in input code frames (a conservative ceil
    walk through conv1, the blocks' transposed conv and units, and conv2).

    from_stage > 0: the blocks from `from_stage` on and conv2 only, in
    frames at that block's input rate (the late fold's halo)."""
    rf = 1 + (cfg.kernel_size - 1)  # conv2 at the output rate
    for stride in reversed(tuple(cfg.dec_strides)[from_stage:]):
        for d in tuple(cfg.res_dilations):
            rf += (cfg.res_kernel_size - 1) * d
        rf = math.ceil(rf / stride) + (math.ceil(2 * stride / stride) - 1)
    if from_stage == 0:
        rf += cfg.kernel_size - 1  # conv1 at the frame rate
    return rf


def vocoder_halo_frames(cfg: VocoderConfig, from_stage: int = 0) -> int:
    """HiFiGAN vocoder receptive field in input code frames; from_stage > 0:
    the upsample stages from `from_stage` on and the output conv only, in
    frames at that stage's input rate."""
    rf = 1 + (cfg.kernel_size - 1)  # output conv
    for i in reversed(range(from_stage, len(cfg.upsample_scales))):
        s = cfg.upsample_scales[i]
        for b, k in enumerate(cfg.resblock_kernel_sizes):
            for d in cfg.resblock_dilations[b]:
                rf += (k - 1) * d
                if cfg.use_additional_convs:
                    rf += (k - 1)
        rf = math.ceil(rf / s) + (math.ceil(cfg.upsample_kernel_sizes[i] / s)
                                  - 1)
    if from_stage == 0:
        rf += cfg.kernel_size - 1  # input conv
    return rf
