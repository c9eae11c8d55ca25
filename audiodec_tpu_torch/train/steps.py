"""The autoencoder's GAN training steps (counterpart of
audiodec_tpu/train/steps.py `make_autoencoder_steps`; ref
trainer/autoencoder.py:49-131).

A train state is {"gen", "disc": param trees, "gen_opt", "disc_opt":
train/optim.py Optimizers}.  A step updates the trained leaves in place,
replaces the buffers no optimizer drives (the quantizer's EMA codebooks,
BN's running stats, spectral norm's `u`) with new tensors, and returns
(state, record): the losses the JAX package records, as detached scalars on
the state's device.

The semantics are JAX's, which are the reference's:
- metric step: train mode (EMA codebooks, batch-stat BN), the buffers
  merged after the optimizer step;
- adversarial step ("efficient" paradigm): encoder, projector and quantizer
  frozen (no gradient reaches them, no update moves them), the codebook in
  eval mode, a BN projector still in train mode; the real audio's
  discriminator features under no gradient for feature matching; then the
  discriminator's update on y_ recomputed with the updated generator (which
  advances a BN projector's running stats a second time, ref
  autoencoder.py:117-126) with the spectral-norm `u` its own loss
  advanced;
- eval step: eval mode, no update.
"""

from __future__ import annotations

from typing import Callable

import torch

from audiodec_tpu_torch.models.autoencoder import (
    GeneratorConfig,
    generator_forward,
    merge_forward_buffers,
)
from audiodec_tpu_torch.ops.norms import resolve_params
from audiodec_tpu_torch.train import criterion as C
from audiodec_tpu_torch.train.optim import Optimizer, tree_leaves
from audiodec_tpu_torch.utils.bridge import tree_map

# the subtrees the adversarial stage freezes
FROZEN = ("encoder", "projector", "quantizer")


def _ppl_record(record, ppl):
    for i in range(ppl.shape[0]):
        record[f"ppl_{i}"] = ppl[i]


def _detached(record: dict) -> dict:
    return {k: torch.as_tensor(v).detach() for k, v in record.items()}


def _frozen_detached(tree: dict) -> dict:
    """The tree with the frozen subtrees cut from the autograd graph."""
    return {k: tree_map(torch.Tensor.detach, v) if k in FROZEN else v
            for k, v in tree.items()}


def make_autoencoder_steps(gen_cfg: GeneratorConfig, disc_apply: Callable,
                           config: dict, crit: dict):
    """-> {"metric": fn, "adv": fn, "eval": fn}, each fn(state, x) with x a
    (B, T, C) batch on the state's device."""

    def generator_losses(eff, x, record, *, train, bn_train=None):
        y, _, _, vql, ppl, new_buf = generator_forward(
            eff, x, gen_cfg, train=train, bn_train=bn_train)
        _ppl_record(record, ppl)
        loss = C.vq_loss(config, vql, record)
        loss = loss + C.metric_loss(crit, config, y, x, record)
        return loss, y, new_buf

    def metric_step(state, x):
        record = {}
        eff, _ = resolve_params(state["gen"])
        loss, _, new_buf = generator_losses(eff, x, record, train=True)
        record["generator_loss"] = loss
        state["gen_opt"].step(loss)
        state["gen"] = merge_forward_buffers(state["gen"], new_buf)
        return state, _detached(record)

    def adv_step(state, x):
        record = {}
        gen_opt = state["gen_opt"]
        eff, _ = resolve_params(state["gen"])
        loss, y, new_buf = generator_losses(
            _frozen_detached(eff), x, record, train=False, bn_train=True)
        # the generator's loss resolves the discriminator's norms too; the
        # `u` that advances there is thrown away, as in JAX
        disc_eff, _ = resolve_params(state["disc"])
        p_hat = disc_apply(disc_eff, y)
        p = None
        if "feat_match" in crit:
            with torch.no_grad():
                p = disc_apply(disc_eff, x)
        loss = loss + C.adv_loss(crit, config, p_hat, p, record)
        record["generator_loss"] = loss
        gen_opt.step(loss, [path for path in gen_opt.params
                            if path.split("/")[0] not in FROZEN])
        gen = merge_forward_buffers(state["gen"], new_buf)

        # the discriminator's update, on y_ from the updated generator
        with torch.no_grad():
            gen_eff, _ = resolve_params(gen)
            y_, _, _, _, _, buf2 = generator_forward(
                gen_eff, x, gen_cfg, train=False, bn_train=True)
        state["gen"] = merge_forward_buffers(gen, buf2)
        drec = {}
        disc_eff, new_disc = resolve_params(state["disc"])
        dloss = C.dis_loss(crit, disc_apply(disc_eff, y_),
                           disc_apply(disc_eff, x), drec)
        state["disc_opt"].step(dloss)
        state["disc"] = new_disc
        record.update(drec)
        return state, _detached(record)

    @torch.no_grad()
    def eval_step(state, x):
        record = {}
        eff, _ = resolve_params(state["gen"])
        loss, _, _ = generator_losses(eff, x, record, train=False)
        record["generator_loss"] = loss
        return _detached(record)

    return {"metric": metric_step, "adv": adv_step, "eval": eval_step}


def is_buffer(path: str) -> bool:
    """Leaves no optimizer drives: the quantizer's codebooks and EMA
    statistics, BN's running statistics, spectral norm's `u`."""
    parts = path.split("/")
    return (parts[0] == "quantizer" or parts[-1] == "u"
            or (len(parts) > 2 and parts[-2] == "bn"
                and parts[-1] in ("mean", "var", "count")))


def train_state(gen: dict, disc: dict, config: dict) -> dict:
    """{gen, disc, gen_opt, disc_opt}, each optimizer over every leaf of
    its tree but the buffers."""
    def trained(tree):
        return [(p, t) for p, t in tree_leaves(tree) if not is_buffer(p)]

    return {"gen": gen, "disc": disc,
            "gen_opt": Optimizer(config, "generator", trained(gen)),
            "disc_opt": Optimizer(config, "discriminator", trained(disc))}
