"""Name -> activation function (counterpart of audiodec_tpu/ops/activations.py).

Only the names the codec's configs use: ELU (autoencoder) and LeakyReLU
(vocoder and discriminators).  Parameter names follow torch.nn.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def elu_exp(v: torch.Tensor) -> torch.Tensor:
    """ELU as the TPU kernels compute it, exp(min(v, 0)) - 1 (Pallas has no
    expm1 on the TPU), where torch's F.elu uses expm1: the two differ by
    an ulp on part of the arguments."""
    return torch.where(v > 0, v, torch.exp(torch.clamp(v, max=0.0)) - 1.0)


def get_activation(name: str, params: dict | None = None):
    params = dict(params or {})
    if name == "ELU":
        alpha = params.get("alpha", 1.0)
        return lambda x: F.elu(x, alpha=alpha)
    if name == "LeakyReLU":
        slope = params.get("negative_slope", 0.01)
        return lambda x: F.leaky_relu(x, negative_slope=slope)
    raise NotImplementedError(f"Activation {name} is not supported!")
