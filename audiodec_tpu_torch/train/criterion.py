"""The criterion bundle of a reference-style config (counterpart of
audiodec_tpu/train/criterion.py; ref codecTrain.py:191-213,
trainer/trainerGAN.py:214-268), with the lambda weights and the record keys
the JAX package writes."""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict

import torch

from audiodec_tpu_torch.losses import (
    MultiResolutionSTFTLoss,
    MultiWindowShapeLoss,
    discriminator_adversarial_loss,
    feature_match_loss,
    generator_adversarial_loss,
)
from audiodec_tpu_torch.losses import mel as mel_mod


def build_criterion(config: dict) -> Dict[str, Callable]:
    crit: Dict[str, Callable] = {}
    fs = config.get("sampling_rate", 48000)
    if config.get("use_mel_loss", False):
        crit["mel"] = mel_mod.from_config(fs, config.get("mel_loss_params",
                                                         {}))
    if config.get("use_stft_loss", False):
        p = config.get("stft_loss_params", {})
        crit["stft"] = MultiResolutionSTFTLoss(
            fft_sizes=tuple(p.get("fft_sizes", (1024, 2048, 512))),
            hop_sizes=tuple(p.get("hop_sizes", (120, 240, 50))),
            win_lengths=tuple(p.get("win_lengths", (600, 1200, 240))))
    if config.get("use_shape_loss", False):
        p = config.get("shape_loss_params", {})
        crit["shape"] = MultiWindowShapeLoss(winlen=tuple(p.get("winlen",
                                                                (300,))))
    gp = config.get("generator_adv_loss_params", {})
    crit["gen_adv"] = partial(
        generator_adversarial_loss,
        loss_type=config.get("generator_adv_loss_type", "mse"),
        average_by_discriminators=gp.get("average_by_discriminators", True))
    dp = config.get("discriminator_adv_loss_params", {})
    crit["dis_adv"] = partial(
        discriminator_adversarial_loss,
        loss_type=config.get("discriminator_adv_loss_type", "mse"),
        average_by_discriminators=dp.get("average_by_discriminators", True))
    if config.get("use_feat_match_loss", False):
        fp = config.get("feat_match_loss_params", {})
        crit["feat_match"] = partial(
            feature_match_loss,
            average_by_layers=fp.get("average_by_layers", True),
            average_by_discriminators=fp.get("average_by_discriminators",
                                             True),
            include_final_outputs=fp.get("include_final_outputs", False))
    return crit


def metric_loss(crit: dict, config: dict, y_hat, y, record: dict):
    """Weighted metric loss (ref: trainer/trainerGAN.py:214-241)."""
    total = 0.0
    if "mel" in crit:
        l = crit["mel"](y_hat, y) * config.get("lambda_mel_loss", 45.0)
        record["mel_loss"] = l
        total = total + l
    if "stft" in crit:
        sc, mag = crit["stft"](y_hat, y)
        lam = config.get("lambda_stft_loss", 45.0)
        record["spectral_convergence_loss"] = sc * lam
        record["log_stft_magnitude_loss"] = mag * lam
        total = total + sc * lam + mag * lam
    if "shape" in crit:
        l = crit["shape"](y_hat, y) * config.get("lambda_shape_loss", 45.0)
        record["shape_loss"] = l
        total = total + l
    return total


def adv_loss(crit: dict, config: dict, p_hat, p, record: dict):
    """Generator adversarial (+ feature matching) loss
    (ref: trainer/trainerGAN.py:244-257)."""
    loss = crit["gen_adv"](p_hat)
    if p is not None and "feat_match" in crit:
        fm = crit["feat_match"](p_hat, p)
        record["feature_matching_loss"] = fm
        loss = loss + config.get("lambda_feat_match", 2.0) * fm
    loss = loss * config.get("lambda_adv", 1.0)
    record["adversarial_loss"] = loss
    return loss


def dis_loss(crit: dict, p_hat, p, record: dict):
    """Discriminator loss (ref: trainer/trainerGAN.py:260-268)."""
    real, fake = crit["dis_adv"](p_hat, p)
    record["real_loss"] = real
    record["fake_loss"] = fake
    record["discriminator_loss"] = real + fake
    return real + fake


def vq_loss(config: dict, vqloss, record: dict):
    """Summed, weighted VQ loss (ref: trainer/trainerGAN.py:392-402)."""
    l = torch.sum(vqloss) * config.get("lambda_vq_loss", 1.0)
    record["vqloss"] = l
    return l
