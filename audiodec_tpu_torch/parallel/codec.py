"""The chunk-halo sequence-parallel codec and its receptive-field halos
(counterpart of audiodec_tpu/parallel/codec.py: `encoder_halo_samples`,
`decoder_halo_frames`, `vocoder_halo_frames`, `_left_halo`,
`make_sharded_codec`).

Every op of the codec is a causal FIR conv, so a chunk of a signal that
carries this much real left context computes the same outputs as the whole
signal.  The batch folds of models/fast.py cut one utterance into chunks
with these halos; the sharded codec cuts it over the ranks of a mesh's
'seq' axis:

  encode: each rank takes H = ceil((rf - 1) / hop) * hop samples of left
          context from its left neighbours, runs the batch encoder on
          [context | chunk] and drops the context's frames: every kept
          frame has its whole receptive field, so the indices are the
          unsharded encode's.  The context is the real samples only: the
          first shard takes none and a shard nearer the start than H
          takes what lies before it, so that the encoder pads each layer
          at the utterance's start as the batch path does.
  decode: the same at frame granularity (F halo frames, F * hop samples
          dropped), and the utterance's first F * hop samples decoded
          again from its first 2F frames (`make_sharded_codec`'s head
          patch).

One exchange per stack, at the waveform or code level; the batch rows are
split over the 'data' axis with no exchange.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from audiodec_tpu_torch.models.autoencoder import (
    GeneratorConfig,
    decoder_apply,
    encoder_apply,
    projector_apply,
)
from audiodec_tpu_torch.models.vocoder import VocoderConfig, vocoder_apply
from audiodec_tpu_torch.ops.vq import rvq_forward_index, rvq_lookup
from audiodec_tpu_torch.utils.bridge import tree_map


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


def _left_halo(x: torch.Tensor, halo: int, axis) -> torch.Tensor:
    """The last `halo` steps of left-neighbour context of x (B, L, C) over
    `axis` (a mesh Axis) -> (B, halo, C); zeros reach index 0, the batch
    path's zero padding.

    When the halo is longer than one shard, the context spans several
    left neighbours, so the shift is chained: hop h delivers the shard h
    steps to the left."""
    shard_len = x.shape[1]
    if halo <= shard_len:
        return axis.shift(x[:, shard_len - halo:])
    parts, cur = [], x
    for _ in range(math.ceil(halo / shard_len)):
        cur = axis.shift(cur)
        parts.insert(0, cur)
    ctx = torch.cat(parts, dim=1)
    return ctx[:, ctx.shape[1] - halo:]


def _cast(tree, dtype, device):
    return tree_map(lambda a: a.to(device, dtype)
                    if a.dtype == torch.float32 else a.to(device), tree)


def make_sharded_codec(mesh, params: dict, cfg: GeneratorConfig,
                       vocoder: Optional[Tuple[dict, VocoderConfig]] = None,
                       dtype=torch.float32, dec_dtype=None,
                       encode_fold=False, decode_fold=False):
    """Encode and decode of this rank's block over a ('data', 'seq') mesh
    (parallel/mesh.py) -> (encode, decode):

      encode(x (b, L, C), this rank's rows and time shard) -> idx
          (b, L / hop, Q)
      decode(idx (b, n, Q)) -> y (b, n * hop, C) float32

    Every rank of a seq line calls both with blocks of one shape (the
    utterance's length divisible by seq * hop).  With the folds off (the
    default), the indices equal the unsharded batch encode's; the waveform
    matches to f32 rounding (the convs run at other padded shapes).

    dtype: the encoder's and projector's compute dtype (the RVQ distances
    in f32); dec_dtype (default dtype): the decoder's or vocoder's;
    float32 with bfloat16 is the mixed mode, whose indices are float32's.
    vocoder: (its params, VocoderConfig) decodes instead of the
    generator's decoder (the AD v1/v2 receiver).
    encode_fold / decode_fold: the batch folds of models/fast.py run inside
    each shard on its halo'd chunk: False = the direct convs, None or True
    = the auto fold of the local length, an int = that fold.  The fold's
    chunk 0 sees the exchanged halo as real context; its own head patch is
    skipped, since this function's covers it."""
    from audiodec_tpu_torch.models import fast  # fast imports this module

    dec_dtype = dtype if dec_dtype is None else dec_dtype
    enc_fold = None if encode_fold is True else encode_fold
    dec_fold = None if decode_fold is True else decode_fold
    seq = mesh.axis("seq")
    device = mesh.device
    hop = cfg.hop_length
    h_samples = encoder_halo_samples(cfg)
    enc = _cast({"encoder": params["encoder"],
                 "projector": params["projector"]}, dtype, device)
    quantizer = _cast(params["quantizer"], torch.float32, device)
    if vocoder is None:
        h_dec = decoder_halo_frames(cfg)
        dec = _cast(params["decoder"], dec_dtype, device)
    else:
        voc_cfg = vocoder[1]
        h_dec = vocoder_halo_frames(voc_cfg)
        dec = _cast(vocoder[0], dec_dtype, device)

    def dec_direct(zq):
        if vocoder is None:
            return decoder_apply(dec, zq, cfg)
        return vocoder_apply(dec, zq, voc_cfg)

    def dec_local(zq):
        # head_patch=False: the fold's own head lies in the halo that is
        # dropped, and dec_head decodes the utterance's head again
        if decode_fold is False:
            return dec_direct(zq)
        if vocoder is None:
            return fast.decoder_apply_batchfold(dec, zq, cfg, fold=dec_fold,
                                                head_patch=False)
        return fast.vocoder_apply_batchfold(dec, zq, voc_cfg, fold=dec_fold,
                                            head_patch=False)

    @torch.no_grad()
    def encode(x: torch.Tensor) -> torch.Tensor:
        x = x.to(device)
        # the halo's real samples only: zeros prepended where the
        # utterance has none would not be the batch path's padding once
        # a conv has a bias (conv(0) = b feeds the next layer), which the
        # JAX package's zero halo (its codec.py:187-189) gets wrong
        real = min(h_samples, seq.index * x.shape[1])
        halo = _left_halo(x, h_samples, seq)[:, h_samples - real:]
        xp = torch.cat([halo, x], dim=1).to(dtype)
        if encode_fold is False:
            h = encoder_apply(enc["encoder"], xp, cfg)
        else:
            h = fast.encoder_apply_batchfold(enc["encoder"], xp, cfg,
                                             fold=enc_fold)
        z = projector_apply(enc["projector"], h, cfg)
        _, idx = rvq_forward_index(z.float(), quantizer)
        return idx[:, real // hop:]

    def dec_head(idx: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """y with the utterance's first h_dec * hop samples (where they
        fall in this shard) decoded without shards.  The first shard's
        halo is wrong for two reasons: (a) the zero halo is index 0, which
        looks up codebook entry 0 rather than the zero activations of the
        batch path's padding, for every conv type; (b) the batch
        transposed conv pads by replicating its first input frame
        (ref: layers/conv_layer.py:184-197).  Causality makes the patch
        exact: the first 2 * h_dec frames decode the first h_dec * hop
        samples as the unsharded decode does."""
        n = idx.shape[1]
        total = n * seq.size
        n_head = min(2 * h_dec, total)
        head_len = min(h_dec * hop, total * hop)
        # the condition is the same on every rank of the line, so either
        # all of them gather or none does
        head_idx = (seq.all_gather(idx, 1)[:, :n_head] if n < n_head
                    else idx[:, :n_head])
        start = seq.index * n * hop
        if start >= head_len:
            return y
        zq = rvq_lookup(head_idx, quantizer).to(dec_dtype)
        head = dec_direct(zq)[:, start:min(head_len, start + n * hop)]
        return torch.cat([head.float(), y[:, head.shape[1]:]], dim=1)

    @torch.no_grad()
    def decode(idx: torch.Tensor) -> torch.Tensor:
        idx = idx.to(device)
        idxp = torch.cat([_left_halo(idx, h_dec, seq), idx], dim=1)
        zq = rvq_lookup(idxp, quantizer).to(dec_dtype)
        y = dec_local(zq)[:, h_dec * hop:].float()
        return dec_head(idx, y)

    return encode, decode
