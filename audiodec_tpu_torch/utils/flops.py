"""Analytic FLOP counts of the codec (counterpart of
audiodec_tpu/utils/flops.py: `encoder_flops`, `projector_flops`,
`rvq_flops`, `decoder_flops`, `transcode_flops`, `vocoder_flops`), on the
port's `GeneratorConfig` and `VocoderConfig`.

The model FLOPs of the direct (unfolded) algorithm: a multiply-add is 2
FLOPs, and only the matmul and conv terms count (biases, activations and
residual adds are under 1%, and left out as MFU accounting does).  A
batch fold computes more than this (each chunk's halo again); MFU is
taken against these counts.
"""

from __future__ import annotations

from audiodec_tpu_torch.models.autoencoder import GeneratorConfig
from audiodec_tpu_torch.models.vocoder import VocoderConfig


def _conv1d(t_out: int, k: int, cin: int, cout: int) -> int:
    return 2 * k * cin * cout * t_out


def encoder_flops(cfg: GeneratorConfig, t: int) -> int:
    """Direct causal encoder forward FLOPs for one batch item of t samples
    (the structure of models/autoencoder.py `encoder_bct`)."""
    total = _conv1d(t, cfg.kernel_size, cfg.input_channels,
                    cfg.encode_channels)
    t_i = t
    in_ch = cfg.encode_channels
    for i, stride in enumerate(cfg.enc_strides):
        out_ch = cfg.encode_channels * cfg.enc_ratios[i]
        for _ in cfg.res_dilations:  # conv(k) + 1x1, channels preserved
            total += _conv1d(t_i, cfg.res_kernel_size, in_ch, in_ch)
            total += _conv1d(t_i, 1, in_ch, in_ch)
        t_i //= stride
        total += _conv1d(t_i, 2 * stride, in_ch, out_ch)
        in_ch = out_ch
    return total


def projector_flops(cfg: GeneratorConfig, n_frames: int) -> int:
    return _conv1d(n_frames, 3, cfg.enc_out_channels, cfg.code_dim)


def rvq_flops(cfg: GeneratorConfig, n_frames: int) -> int:
    """The distance cross-term matmuls (z @ E^T per codebook); the
    elementwise |z|^2 / |E|^2 terms and the lookups are small beside
    them."""
    return cfg.codebook_num * 2 * n_frames * cfg.code_dim * cfg.codebook_size


def decoder_flops(cfg: GeneratorConfig, n_frames: int) -> int:
    """Direct causal decoder forward FLOPs from n_frames code frames
    (the structure of models/autoencoder.py `decoder_bct`)."""
    ch0 = cfg.decode_channels * cfg.dec_ratios[0]
    total = _conv1d(n_frames, cfg.kernel_size, cfg.code_dim, ch0)
    n_i = n_frames
    for i, stride in enumerate(cfg.dec_strides):
        in_ch = cfg.decode_channels * cfg.dec_ratios[i]
        out_ch = (cfg.decode_channels * cfg.dec_ratios[i + 1]
                  if i < len(cfg.dec_ratios) - 1 else cfg.decode_channels)
        # transposed conv: every input frame feeds k taps
        total += _conv1d(n_i, 2 * stride, in_ch, out_ch)
        n_i *= stride
        for _ in cfg.res_dilations:
            total += _conv1d(n_i, cfg.res_kernel_size, out_ch, out_ch)
            total += _conv1d(n_i, 1, out_ch, out_ch)
    total += _conv1d(n_i, cfg.kernel_size, cfg.decode_channels,
                     cfg.output_channels)
    return total


def transcode_flops(cfg: GeneratorConfig, t: int) -> dict:
    """Per-batch-item FLOPs of the full encode->RVQ->decode transcode of t
    samples, by stage."""
    n = t // cfg.hop_length
    stages = {
        "encoder": encoder_flops(cfg, t),
        "projector": projector_flops(cfg, n),
        "rvq": rvq_flops(cfg, n),
        "decoder": decoder_flops(cfg, n),
    }
    stages["total"] = sum(stages.values())
    return stages


def vocoder_flops(voc_cfg: VocoderConfig, n_frames: int) -> int:
    """Causal HiFiGAN generator forward FLOPs from n_frames code frames
    (the structure of models/vocoder.py `vocoder_bct`)."""
    c = voc_cfg.channels
    total = _conv1d(n_frames, voc_cfg.kernel_size, voc_cfg.in_channels, c)
    n_i = n_frames
    for i, s in enumerate(voc_cfg.upsample_scales):
        cout = voc_cfg.stage_channels(i)
        total += _conv1d(n_i, voc_cfg.upsample_kernel_sizes[i], c, cout)
        n_i *= s
        c = cout
        groups = voc_cfg.groups if voc_cfg.grouped else 1
        for b, k in enumerate(voc_cfg.resblock_kernel_sizes):
            for _ in voc_cfg.resblock_dilations[b]:
                # grouped convs: groups independent c->c stacks
                total += groups * _conv1d(n_i, k, c, c)
                if voc_cfg.use_additional_convs:
                    total += groups * _conv1d(n_i, k, c, c)
        if voc_cfg.grouped:
            total += _conv1d(n_i, 1, groups * c, c)  # fuse-out 1x1
    total += _conv1d(n_i, voc_cfg.kernel_size, c, voc_cfg.out_channels)
    return total
