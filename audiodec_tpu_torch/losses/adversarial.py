"""GAN adversarial losses (counterpart of audiodec_tpu/losses/adversarial.py;
ref: losses/adversarial_loss.py:13-124).

Discriminator outputs are a list (one entry per sub-discriminator) of lists
of per-layer feature maps; the last element of each inner list is the logit
map.
"""

from __future__ import annotations

import torch


def _last(outs):
    return outs[-1] if isinstance(outs, (tuple, list)) else outs


def generator_adversarial_loss(outputs, *, loss_type: str = "mse",
                               average_by_discriminators: bool = True):
    if not isinstance(outputs, (tuple, list)):
        outputs = [outputs]
    loss = 0.0
    for o in outputs:
        x = _last(o)
        if loss_type == "mse":
            loss = loss + torch.mean(torch.square(x - 1.0))
        elif loss_type == "hinge":
            loss = loss - torch.mean(x)
        else:
            raise ValueError(loss_type)
    if average_by_discriminators:
        loss = loss / len(outputs)
    return loss


def discriminator_adversarial_loss(outputs_hat, outputs, *,
                                   loss_type: str = "mse",
                                   average_by_discriminators: bool = True):
    """Returns (real_loss, fake_loss)."""
    if not isinstance(outputs, (tuple, list)):
        outputs, outputs_hat = [outputs], [outputs_hat]
    real, fake = 0.0, 0.0
    for oh, o in zip(outputs_hat, outputs):
        xh, x = _last(oh), _last(o)
        if loss_type == "mse":
            real = real + torch.mean(torch.square(x - 1.0))
            fake = fake + torch.mean(torch.square(xh))
        elif loss_type == "hinge":
            real = real - torch.mean(torch.clamp(x - 1.0, max=0.0))
            fake = fake - torch.mean(torch.clamp(-xh - 1.0, max=0.0))
        else:
            raise ValueError(loss_type)
    if average_by_discriminators:
        real = real / len(outputs)
        fake = fake / len(outputs)
    return real, fake
