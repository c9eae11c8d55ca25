"""Batch inference through the fused residual-stack kernels (counterpart of
audiodec_tpu/models/fast.py: `_use_folded`, `res_stack_auto` with its int8
branch, `encoder_apply_folded`, `decoder_apply_folded`, and the vocoder fast
path
`_voc_resblock_params`, `_voc_use_folded`, `_voc_resblock_folded`,
`_voc_fusion_auto`, `vocoder_apply_folded`; and the batch folds
`batchfold_auto`, `_apply_batchfold_frames`, `decoder_apply_batchfold`,
`vocoder_fold_from_auto`, `vocoder_apply_batchfold`, `encoder_unfold_auto`,
`decoder_fold_from_auto`, `encoder_apply_batchfold`, `decode_batchfold`,
`_decoder_direct`).

The stacks and resblocks that the JAX package sends to its folded kernel go
to the CUDA kernels, and so do a bf16 vocoder's resblocks above C = 32; the
rest stay plain cuDNN convs.  With int8=True every decoder stack, of any
width, goes to the kernel's int8 mode.

The batch folds cut each utterance's time axis into F chunks, each with a
left halo of real context (parallel/codec.py), and run them as F times the
batch on the plain convs: JAX's default `stack="xla"` route, which launches
no kernel of the port.
"""

from __future__ import annotations

import math
import warnings
from functools import partial

import torch
import torch.nn.functional as F

from audiodec_tpu_torch.models.autoencoder import (
    GeneratorConfig,
    decoder_apply,
    decoder_bct,
    encoder_apply,
    encoder_bct,
    res_stack_plain,
)
from audiodec_tpu_torch.models.vocoder import (
    VocoderConfig,
    _fusion_apply,
    fusion_bct,
    vocoder_apply,
    vocoder_bct,
)
from audiodec_tpu_torch.ops.activations import get_activation
from audiodec_tpu_torch.ops.conv import causal_conv1d, causal_conv_transpose1d
from audiodec_tpu_torch.ops.kernels.folded_stack import (
    WIDE_CHANNELS,
    folded_residual_stack,
    res_stack_params,
)
from audiodec_tpu_torch.ops.vq import rvq_lookup
from audiodec_tpu_torch.parallel.codec import (
    decoder_halo_frames,
    encoder_halo_samples,
    vocoder_halo_frames,
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


def _voc_use_wide(cfg: VocoderConfig, x) -> bool:
    """A bf16 stage above C = 32 (every dot operand already bf16) takes
    csrc/wide_stack_mma.cu, the port's own route: JAX's rule sends it to
    plain convs, and only the order of the f32 sums changes."""
    return (x.dtype == torch.bfloat16
            and WIDE_CHANNELS[0] < x.shape[1] <= WIDE_CHANNELS[1]
            and cfg.use_additional_convs
            and cfg.nonlinear_activation == "LeakyReLU")


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
    and in a bf16 vocoder above C = 32 (`_voc_use_wide`); plain convs
    otherwise.  x: (B, C, T)."""
    _, c, t = x.shape
    if not (_voc_use_folded(cfg, c, t) or _voc_use_wide(cfg, x)):
        return _fusion_apply(p, x, cfg)
    slope = dict(cfg.nonlinear_activation_params).get("negative_slope", 0.01)

    def resblock(p_block, x, kernel_size, dilations, _groups):
        return _voc_resblock_folded(p_block, x, kernel_size=kernel_size,
                                    dilations=dilations, slope=slope,
                                    bf16_dots=bf16_dots)

    return fusion_bct(p, x, cfg, resblock)


def vocoder_apply_folded(p, c, cfg: VocoderConfig, bf16_dots: bool = True):
    """Batch vocoder decode with its low-channel, high-rate resblocks in
    the kernel, and in bf16 its resblocks above C = 32 too.  c: (B, T, D)
    codes -> (B, T * hop, out_channels)."""
    fusion = partial(_voc_fusion_auto, bf16_dots=bf16_dots)
    return vocoder_bct(p, c.transpose(1, 2), cfg, fusion).transpose(1, 2)


# ---------------------------------------------------------------------------
# batch folds: the time axis folded into the batch (plain convs)
# ---------------------------------------------------------------------------

def batchfold_auto(n_frames: int, target_chunk: int = 200,
                   max_fold: int = 8) -> int:
    """The fold factor for an n_frames-long code sequence, as JAX picks it:
    the largest power of two up to max_fold that keeps chunks of at least
    target_chunk frames."""
    f = 1
    while f * 2 <= max_fold and n_frames // (f * 2) >= target_chunk:
        f *= 2
    return f


def _fold(x, h: int, f: int, unit: int = 1):
    """(B, C, T) -> (B*F, C, T'/F + h) chunks, T' = T zero-padded at the
    end to a multiple of f * unit; each chunk carries the h steps before it
    (zeros before the first)."""
    b, c, t = x.shape
    pad = (-t) % (f * unit)
    xp = F.pad(x, (h, pad))
    tc = (t + pad) // f
    chunks = torch.stack([xp[..., i * tc:i * tc + tc + h] for i in range(f)],
                         dim=1)
    return chunks.reshape(b * f, c, tc + h)


def _unfold(y, b: int, h: int):
    """(B*F, C, h + L) chunks -> (B, C, F*L): each chunk's first h steps
    dropped, the chunks joined in time."""
    y = y[..., h:]
    bf, c, n = y.shape
    return (y.reshape(b, bf // b, c, n).permute(0, 2, 1, 3)
            .reshape(b, c, bf // b * n))


def _apply_batchfold_frames(apply_fn, z, h: int, hop: int, f: int,
                            head_patch: bool = True):
    """Frame-level fold of an upsampling decoder or vocoder, in the
    package's layout: z (B, D, n) -> chunks (B*F, D, n/F + h) with an
    h-frame halo of real context, one apply_fn at the folded batch, the
    halo's h*hop output samples dropped and the chunks joined, trimmed to
    n*hop.

    The batch transposed conv left-pads by replicating the first frame,
    which a zero halo cannot reproduce, so the first h*hop samples are
    decoded again directly from the first min(2h, n) frames and written
    over the head of a new tensor (head_patch=False leaves them as the
    zero halo decodes them)."""
    b, _, n = z.shape
    y = _unfold(apply_fn(_fold(z, h, f)), b, h * hop)[..., :n * hop]
    if not head_patch:
        return y
    head = apply_fn(z[..., :min(2 * h, n)])[..., :h * hop]
    return torch.cat([head, y[..., head.shape[-1]:]], dim=-1)


def decoder_apply_batchfold(p, zq, cfg: GeneratorConfig, *, fold=None,
                            head_patch: bool = True, fold_from="auto"):
    """Decoder with the code-frame axis folded into the batch.
    zq (B, n, D) -> (B, n * hop, C_out).

    fold: None picks `batchfold_auto(n)`; 1 or less runs the direct
    decoder.  fold_from: run conv1 and the first `fold_from` blocks
    directly and fold only the rest, with the halo of those stages
    (`decoder_halo_frames(from_stage=)`); "auto" is
    `decoder_fold_from_auto`, None or 0 folds the whole decoder.  The fold
    changes the conv shapes, so in bf16 its output differs from the direct
    decoder's within bf16 rounding (JAX: for bf16-class decoders only)."""
    f = batchfold_auto(zq.shape[1]) if fold is None else fold
    if f <= 1:
        return _decoder_direct(p, zq, cfg)
    if fold_from == "auto":
        fold_from = decoder_fold_from_auto(cfg)
    z = zq.transpose(1, 2)
    if not fold_from:
        def whole(zc):
            return decoder_apply(p, zc.transpose(1, 2), cfg).transpose(1, 2)

        return _apply_batchfold_frames(
            whole, z, decoder_halo_frames(cfg), cfg.hop_length, f,
            head_patch=head_patch).transpose(1, 2)

    x = causal_conv1d(z, p["conv1"])
    for i in range(fold_from):
        bp = p["blocks"][i]
        x = causal_conv_transpose1d(x, bp["conv"],
                                    stride=cfg.dec_strides[i])
        x = res_stack_plain(x, bp, cfg)

    def tail(y):
        for i in range(fold_from, len(cfg.dec_strides)):
            bp = p["blocks"][i]
            y = causal_conv_transpose1d(y, bp["conv"],
                                        stride=cfg.dec_strides[i])
            y = res_stack_plain(y, bp, cfg)
        return causal_conv1d(y, p["conv2"])

    tail_hop = math.prod(cfg.dec_strides[fold_from:])
    h = decoder_halo_frames(cfg, from_stage=fold_from)
    return _apply_batchfold_frames(tail, x, h, tail_hop, f,
                                   head_patch=head_patch).transpose(1, 2)


def vocoder_fold_from_auto(cfg: VocoderConfig) -> int:
    """First upsample stage whose output channels drop below 128."""
    for i in range(len(cfg.upsample_scales)):
        if cfg.stage_channels(i) < 128:
            return i
    return 0


def vocoder_apply_batchfold(p, zq, voc_cfg: VocoderConfig, *, fold=None,
                            head_patch: bool = True, fold_from="auto"):
    """HiFiGAN vocoder with the code-frame axis folded into the batch, the
    AD v1/v2 receiver's counterpart of `decoder_apply_batchfold`.
    zq (B, n, D) -> (B, n * hop, out_channels).  fold_from: the early
    stages (input normalization, input conv, the first `fold_from`
    upsample stages) run directly, the rest folded with their own halo;
    "auto" is `vocoder_fold_from_auto`, None or 0 folds the whole
    vocoder."""
    f = batchfold_auto(zq.shape[1]) if fold is None else fold
    if f <= 1:
        return vocoder_apply(p, zq, voc_cfg)
    if fold_from == "auto":
        fold_from = vocoder_fold_from_auto(voc_cfg)
    z = zq.transpose(1, 2)
    if not fold_from:
        def whole(zc):
            return vocoder_apply(p, zc.transpose(1, 2),
                                 voc_cfg).transpose(1, 2)

        return _apply_batchfold_frames(
            whole, z, vocoder_halo_frames(voc_cfg), voc_cfg.hop_length, f,
            head_patch=head_patch).transpose(1, 2)

    act = voc_cfg.act
    lrelu = get_activation("LeakyReLU")  # the output act is default-slope
    c = z
    if voc_cfg.stats and "mean" in p:
        c = (c - p["mean"][:, None]) / p["scale"][:, None]
    c = causal_conv1d(c, p["input_conv"])
    for i in range(fold_from):
        c = causal_conv_transpose1d(act(c), p["upsamples"][i],
                                    stride=voc_cfg.upsample_scales[i])
        c = _fusion_apply(p["blocks"][i], c, voc_cfg)

    def tail(y):
        for i in range(fold_from, len(voc_cfg.upsample_scales)):
            y = causal_conv_transpose1d(act(y), p["upsamples"][i],
                                        stride=voc_cfg.upsample_scales[i])
            y = _fusion_apply(p["blocks"][i], y, voc_cfg)
        return torch.tanh(causal_conv1d(lrelu(y), p["output_conv"]))

    tail_hop = math.prod(voc_cfg.upsample_scales[fold_from:])
    h = vocoder_halo_frames(voc_cfg, from_stage=fold_from)
    return _apply_batchfold_frames(tail, c, h, tail_hop, f,
                                   head_patch=head_patch).transpose(1, 2)


def encoder_unfold_auto(cfg: GeneratorConfig) -> int:
    """First encoder block whose residual stack reaches C >= 128; a partial
    encoder fold unfolds before it."""
    c = cfg.encode_channels
    for i in range(len(cfg.enc_strides)):
        if c >= 128:
            return i
        c = cfg.encode_channels * cfg.enc_ratios[i]
    return len(cfg.enc_strides)


def decoder_fold_from_auto(cfg: GeneratorConfig) -> int:
    """First decoder block whose residual stack drops below C = 128; the
    late fold starts there."""
    n = len(cfg.dec_strides)
    for i in range(n):
        c = (cfg.decode_channels * cfg.dec_ratios[i + 1]
             if i + 1 < len(cfg.dec_ratios) else cfg.decode_channels)
        if c < 128:
            return i
    return 0


def encoder_apply_batchfold(p, x, cfg: GeneratorConfig, *, fold=None,
                            unfold_after="auto"):
    """Encoder with the waveform's time axis folded into the batch.
    x (B, T, C) -> (B, T / hop, C_enc); run the projector and RVQ on it.

    Each chunk carries an `encoder_halo_samples` left halo (hop-aligned, so
    every frame keeps its stride phase).  Chunk 0's halo is zeros, which is
    not the batch path's padding: each conv pads its own input with zeros,
    and a biased conv of the zero halo gives its bias, not zeros, to the
    next layer.  So the frames whose receptive field reaches before the
    first sample (the first `encoder_halo_samples(cfg)` samples' worth)
    are encoded again directly from those samples and written over the
    fold's (the decoder fold's head patch, for the encoder; JAX's fold
    keeps them as the zero halo gives them).  fold: None picks
    `batchfold_auto(T / hop)`; 1 or less runs the direct encoder, and so
    does an input of no more frames than the head patch replaces.
    unfold_after: run conv0 and the first `unfold_after` blocks folded,
    then drop each chunk's halo at that rate, join the chunks and run the
    deeper blocks directly; "auto" is `encoder_unfold_auto`, None folds
    the whole encoder."""
    b, t, _ = x.shape
    hop = cfg.hop_length
    n = t // hop
    f = batchfold_auto(n) if fold is None else fold
    if f <= 1:
        return encoder_apply(p, x, cfg)
    if n <= encoder_halo_samples(cfg) // hop:
        # the head patch would replace every frame of the fold
        return encoder_apply(p, x[:, :n * hop], cfg)[:, :n]
    if unfold_after == "auto":
        unfold_after = encoder_unfold_auto(cfg)
    n_blocks = len(cfg.enc_strides)
    u = n_blocks if unfold_after is None else min(unfold_after, n_blocks)
    h = (encoder_halo_samples(cfg) if u == n_blocks
         else encoder_halo_samples(cfg, through_blocks=u))
    chunks = _fold(x.transpose(1, 2), h, f, hop)
    if u == n_blocks:
        hh = encoder_apply(p, chunks.transpose(1, 2), cfg).transpose(1, 2)
        return _encoder_head_patch(p, x, cfg,
                                   _unfold(hh, b, h // hop)[..., :n])

    y = causal_conv1d(chunks, p["conv"])
    h_rate = h
    for i in range(u):
        bp = p["blocks"][i]
        y = causal_conv1d(res_stack_plain(y, bp, cfg), bp["conv"],
                          stride=cfg.enc_strides[i])
        h_rate //= cfg.enc_strides[i]
    y = _unfold(y, b, h_rate)
    for i in range(u, n_blocks):
        bp = p["blocks"][i]
        y = causal_conv1d(res_stack_plain(y, bp, cfg), bp["conv"],
                          stride=cfg.enc_strides[i])
    return _encoder_head_patch(p, x, cfg, y[..., :n])


def _encoder_head_patch(p, x, cfg: GeneratorConfig, y):
    """The folded encoder's frames y (B, C_enc, n) with the first
    `encoder_halo_samples(cfg) / hop` of them replaced, in a new tensor, by
    the direct encoder's on the first samples (a causal encoder's frames
    depend only on the samples before them) -> (B, n, C_enc)."""
    k = min(encoder_halo_samples(cfg) // cfg.hop_length, y.shape[-1])
    head = encoder_apply(p, x[:, :k * cfg.hop_length], cfg)[:, :k]
    return torch.cat([head, y[..., k:].transpose(1, 2)], dim=1)


def decode_batchfold(dec_params, q_params, idx, cfg: GeneratorConfig, *,
                     dec_dtype=torch.bfloat16, fold=None):
    """Indices (B, n, Q) -> waveform: one RVQ lookup, cast to dec_dtype,
    then `decoder_apply_batchfold`."""
    zq = rvq_lookup(idx, q_params).to(dec_dtype)
    return decoder_apply_batchfold(dec_params, zq, cfg, fold=fold)


def _decoder_direct(p, zq, cfg: GeneratorConfig):
    return decoder_apply(p, zq, cfg)
