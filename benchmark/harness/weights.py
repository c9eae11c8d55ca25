"""Seeded inputs and weights, made on the device in a few large draws.

The weights are a state dict in the reference checkpoint's layout
(benchmark/reference/layout.py), every tensor a slice of one normal draw
scaled by its row's `init` entry of the configuration file:

  "w"  N(0, 1) * gain / sqrt(fan_in)       (a plain conv)
  "v"  N(0, 1); "g" = gain                  (a weight-normed conv: each
                                             output channel's norm is gain)
  "b"  N(0, 1) * bias_std
  "embed" N(0, 1) * std * decay ** q        (codebook q; embed_avg a copy,
                                             cluster_size ones)
  "mean" 0, "scale" 1                       (the vocoder's input statistics)

so each conv keeps its input's scale times its gain and the residual
codebooks shrink layer by layer, as a trained codec's do.  A seed gives the
same numbers on every run; every seed gives the same shapes and work.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterable

import numpy as np
import torch

from benchmark.reference.layout import Row


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    h = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, tag))


def state_dict(rows: Iterable[Row], init: Dict[str, dict], seed: int,
               tag: str, device) -> Dict[str, torch.Tensor]:
    """The seeded state dict of `rows`, float32 on `device`."""
    rows = list(rows)
    sizes = [int(np.prod(r.shape)) for r in rows]
    flat = torch.randn(sum(sizes), generator=generator(seed, tag, device),
                       device=device)
    sd, at = {}, 0
    embeds = {}
    for r, n in zip(rows, sizes):
        a = flat[at:at + n].view(r.shape)
        at += n
        spec = init[r.group]
        if r.role == "w":
            sd[r.key] = a * (spec["gain"] / r.fan_in ** 0.5)
        elif r.role == "v":
            sd[r.key] = a
        elif r.role == "g":
            sd[r.key] = torch.full(r.shape, float(spec["gain"]),
                                   device=device)
        elif r.role == "b":
            sd[r.key] = a * spec.get("bias_std", 0.0)
        elif r.role == "embed":
            embeds[r.key] = sd[r.key] = a * (spec["std"]
                                             * spec["decay"] ** r.fan_in)
        elif r.role == "embed_avg":
            sd[r.key] = embeds[r.key.replace("embed_avg", "embed")].clone()
        elif r.role in ("cluster_size", "scale"):
            sd[r.key] = torch.ones(r.shape, device=device)
        elif r.role == "mean":
            sd[r.key] = torch.zeros(r.shape, device=device)
        else:
            raise ValueError(f"unknown role {r.role!r} of {r.key}")
    return sd


def to_numpy(sd: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The state dict as host arrays, in one copy from the device: what a
    reference checkpoint loads as."""
    keys = list(sd)
    flat = torch.cat([sd[k].reshape(-1) for k in keys]).cpu().numpy()
    out, at = {}, 0
    for k in keys:
        n = sd[k].numel()
        out[k] = flat[at:at + n].reshape(tuple(sd[k].shape))
        at += n
    return out


def audio(seed: int, tag: str, shape, scale: float, device) -> torch.Tensor:
    """scale * N(0, 1) audio of `shape`, on the device."""
    return scale * torch.randn(shape, generator=generator(seed, tag, device),
                               device=device)
