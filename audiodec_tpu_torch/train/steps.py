"""GAN and denoising training steps (counterpart of
audiodec_tpu/train/steps.py `make_autoencoder_steps`, `analyzer_codes`,
`make_vocoder_steps`, `make_denoise_steps`; ref trainer/autoencoder.py:49-131,
trainer/vocoder.py:49-146, trainer/denoise.py:52-111).

A train state is {"gen", "disc": param trees, "gen_opt", "disc_opt":
train/optim.py Optimizers}; a vocoder's adds the frozen "analyzer" (a symAD
generator tree), a denoiser's has no "disc" and no "disc_opt".  A step
updates the trained leaves in place, replaces the buffers no optimizer
drives (the quantizer's EMA codebooks, BN's running stats, spectral norm's
`u`) with new tensors, and returns (state, record): the losses the JAX
package records, as detached scalars on the state's device.

The semantics are JAX's, which are the reference's:
- autoencoder metric step: train mode (EMA codebooks, batch-stat BN), the
  buffers merged after the optimizer step;
- autoencoder adversarial step ("efficient" paradigm): encoder, projector
  and quantizer frozen (no gradient reaches them, no update moves them),
  the codebook in eval mode, a BN projector still in train mode; the real
  audio's discriminator features under no gradient for feature matching;
  then the discriminator's update on y_ recomputed with the updated
  generator (which advances a BN projector's running stats a second time,
  ref autoencoder.py:117-126) with the spectral-norm `u` its own loss
  advanced;
- vocoder steps: the analyzer's codes under no gradient, the stats
  buffers `mean` and `scale` never trained; the adversarial step updates
  the discriminator on y_ recomputed with the updated vocoder;
- denoise step: the noisy input encoded, the losses against the clean
  target; quantizer and decoder frozen, the codebook in eval mode, a BN
  projector in train mode (eval mode in the eval step);
- eval steps: eval mode, no update.

Data parallelism (JAX's `axis_name`, `shard_steps`): each maker takes the
data axis of a mesh (parallel/distributed.py `Axis`) as axis_name; every
rank runs the step on its rows of the global batch (`shard_steps` cuts
them), the optimizers average the gradients over the axis before they clip
(train/optim.py), the autoencoder's metric step reduces the RVQ's
statistics over it (ops/vq.py `rvq_forward`), and the records are averaged
over it (`_psum_mean`).  A BN projector normalizes over each rank's rows
and keeps the running statistics of its rows, as JAX's does: its
shard_map returns the state with out_specs P() unchecked, so each device
keeps its own, and the first one's is what is read and saved.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from audiodec_tpu_torch.models.autoencoder import (
    GeneratorConfig,
    encoder_apply,
    generator_forward,
    merge_forward_buffers,
    projector_apply,
)
from audiodec_tpu_torch.models.vocoder import VocoderConfig, vocoder_apply
from audiodec_tpu_torch.ops.norms import resolve_params
from audiodec_tpu_torch.ops.vq import rvq_forward
from audiodec_tpu_torch.train import criterion as C
from audiodec_tpu_torch.train.optim import Optimizer, tree_leaves
from audiodec_tpu_torch.utils.bridge import tree_map
from audiodec_tpu_torch.utils.profiling import span

# the subtrees the autoencoder's adversarial stage freezes
FROZEN = ("encoder", "projector", "quantizer")
# the subtrees denoising freezes
DENOISE_FROZEN = ("quantizer", "decoder")


def shard_steps(steps: dict, axis) -> dict:
    """The step functions fed this rank's contiguous rows of each global
    batch argument (JAX's shard_map over a 1-D data mesh with the state
    replicated); the batch size must divide over the axis."""
    def rows(x):
        if x.shape[0] % axis.size:
            raise ValueError(f"batch {x.shape[0]} does not divide over "
                             f"{axis.name}={axis.size}")
        n = x.shape[0] // axis.size
        return x[axis.index * n:(axis.index + 1) * n]

    def wrap(fn):
        return lambda state, *batch: fn(state, *map(rows, batch))

    return {name: wrap(fn) for name, fn in steps.items()}


def _psum_mean(record: dict, axis_name) -> dict:
    """The records averaged over the axis, in one collective."""
    if axis_name is None or axis_name.size == 1:
        return record
    keys = list(record)
    mean = axis_name.all_reduce(torch.stack([record[k].float()
                                             for k in keys]), "mean")
    return dict(zip(keys, mean.unbind()))


def _ppl_record(record, ppl):
    for i in range(ppl.shape[0]):
        record[f"ppl_{i}"] = ppl[i]


def _detached(record: dict) -> dict:
    return {k: torch.as_tensor(v).detach() for k, v in record.items()}


def _frozen_detached(tree: dict, frozen=FROZEN) -> dict:
    """The tree with the frozen subtrees cut from the autograd graph."""
    return {k: tree_map(torch.Tensor.detach, v) if k in frozen else v
            for k, v in tree.items()}


def _trained_paths(opt: Optimizer, frozen) -> list:
    return [path for path in opt.params
            if path.split("/")[0] not in frozen]


def _disc_loss(state, disc_apply, crit, y_, x, record):
    """The discriminator's loss on fake y_ and real x -> (loss, the
    discriminator's tree with the spectral-norm `u` the loss advanced)."""
    disc_eff, new_disc = resolve_params(state["disc"])
    return C.dis_loss(crit, disc_apply(disc_eff, y_),
                      disc_apply(disc_eff, x), record), new_disc


def _disc_update(state, disc_apply, crit, y_, x, record, axis_name=None):
    """The discriminator's step on fake y_ and real x; the spectral-norm
    `u` its loss advanced is kept."""
    dloss, new_disc = _disc_loss(state, disc_apply, crit, y_, x, record)
    state["disc_opt"].step(dloss, axis=axis_name)
    state["disc"] = new_disc


def _adv_loss(state, disc_apply, crit, config, y, x, record):
    """The generator's adversarial and feature-matching terms; the `u`
    that advances in the discriminator's norms is thrown away, as in
    JAX."""
    disc_eff, _ = resolve_params(state["disc"])
    p_hat = disc_apply(disc_eff, y)
    p = None
    if "feat_match" in crit:
        with torch.no_grad():
            p = disc_apply(disc_eff, x)
    return C.adv_loss(crit, config, p_hat, p, record)


def _codec_losses(gen_cfg, config, crit, eff, x, target, record, *, train,
                  bn_train=None, axis_name=None):
    """generator_forward on x, its VQ loss and its metric losses against
    `target` -> (loss, y, new buffers)."""
    y, _, _, vql, ppl, new_buf = generator_forward(
        eff, x, gen_cfg, train=train, bn_train=bn_train,
        axis_name=axis_name)
    _ppl_record(record, ppl)
    loss = C.vq_loss(config, vql, record)
    loss = loss + C.metric_loss(crit, config, y, target, record)
    return loss, y, new_buf


def make_autoencoder_steps(gen_cfg: GeneratorConfig, disc_apply: Callable,
                           config: dict, crit: dict, axis_name=None):
    """-> {"metric": fn, "adv": fn, "eval": fn}, each fn(state, x) with x a
    (B, T, C) batch on the state's device; axis_name: the data axis, or
    None."""

    def generator_losses(eff, x, record, **mode):
        return _codec_losses(gen_cfg, config, crit, eff, x, x, record, **mode)

    def metric_step(state, x):
        record = {}
        eff, _ = resolve_params(state["gen"])
        loss, _, new_buf = generator_losses(eff, x, record, train=True,
                                            axis_name=axis_name)
        record["generator_loss"] = loss
        state["gen_opt"].step(loss, axis=axis_name)
        state["gen"] = merge_forward_buffers(state["gen"], new_buf)
        return state, _psum_mean(_detached(record), axis_name)

    def adv_step(state, x):
        dev = x.device
        with span("adv_step", dev):
            record = {}
            gen_opt = state["gen_opt"]
            with span("generator", dev):
                eff, _ = resolve_params(state["gen"])
                loss, y, new_buf = generator_losses(
                    _frozen_detached(eff), x, record, train=False,
                    bn_train=True)
            with span("adversarial", dev):
                loss = loss + _adv_loss(state, disc_apply, crit, config, y,
                                        x, record)
            record["generator_loss"] = loss
            with span("gen_update", dev):
                gen_opt.step(loss, _trained_paths(gen_opt, FROZEN),
                             axis=axis_name)
                gen = merge_forward_buffers(state["gen"], new_buf)

            # the discriminator's update, on y_ from the updated generator
            with span("regenerate", dev):
                with torch.no_grad():
                    gen_eff, _ = resolve_params(gen)
                    y_, _, _, _, _, buf2 = generator_forward(
                        gen_eff, x, gen_cfg, train=False, bn_train=True)
                state["gen"] = merge_forward_buffers(gen, buf2)
            with span("discriminate", dev):
                dloss, new_disc = _disc_loss(state, disc_apply, crit, y_, x,
                                             record)
            with span("disc_update", dev):
                state["disc_opt"].step(dloss, axis=axis_name)
                state["disc"] = new_disc
            return state, _psum_mean(_detached(record), axis_name)

    @torch.no_grad()
    def eval_step(state, x):
        record = {}
        eff, _ = resolve_params(state["gen"])
        loss, _, _ = generator_losses(eff, x, record, train=False)
        record["generator_loss"] = loss
        return _psum_mean(_detached(record), axis_name)

    return {"metric": metric_step, "adv": adv_step, "eval": eval_step}


@torch.no_grad()
def analyzer_codes(analyzer: dict, x, gen_cfg: GeneratorConfig):
    """The frozen analyzer's encode path, encoder -> projector (eval) ->
    quantize-dequantize (eval), under no gradient (ref:
    trainer/vocoder.py:69-73).  x: (B, T, 1) -> zq (B, T', D)."""
    h = encoder_apply(analyzer["encoder"], x, gen_cfg)
    z = projector_apply(analyzer["projector"], h, gen_cfg)
    return rvq_forward(z, analyzer["quantizer"], train=False)[0]


def make_vocoder_steps(voc_cfg: VocoderConfig, gen_cfg: GeneratorConfig,
                       disc_apply: Callable, config: dict, crit: dict,
                       axis_name=None):
    """-> {"metric": fn, "adv": fn, "eval": fn}, each fn(state, x) with x a
    (B, T, 1) batch on the state's device; gen_cfg is the analyzer's;
    axis_name: the data axis, or None."""

    def vocoder_losses(state, zq, x, record, adversarial: bool):
        eff, _ = resolve_params(state["gen"])
        y = vocoder_apply(eff, zq, voc_cfg)
        loss = C.metric_loss(crit, config, y, x, record)
        if adversarial:
            loss = loss + _adv_loss(state, disc_apply, crit, config, y, x,
                                    record)
        record["generator_loss"] = loss
        return loss

    def metric_step(state, x):
        record = {}
        zq = analyzer_codes(state["analyzer"], x, gen_cfg)
        state["gen_opt"].step(vocoder_losses(state, zq, x, record, False),
                              axis=axis_name)
        return state, _psum_mean(_detached(record), axis_name)

    def adv_step(state, x):
        record = {}
        zq = analyzer_codes(state["analyzer"], x, gen_cfg)
        state["gen_opt"].step(vocoder_losses(state, zq, x, record, True),
                              axis=axis_name)
        with torch.no_grad():
            gen_eff, _ = resolve_params(state["gen"])
            y_ = vocoder_apply(gen_eff, zq, voc_cfg)
        _disc_update(state, disc_apply, crit, y_, x, record, axis_name)
        return state, _psum_mean(_detached(record), axis_name)

    @torch.no_grad()
    def eval_step(state, x):
        record = {}
        vocoder_losses(state, analyzer_codes(state["analyzer"], x, gen_cfg),
                       x, record, False)
        return _psum_mean(_detached(record), axis_name)

    return {"metric": metric_step, "adv": adv_step, "eval": eval_step}


def make_denoise_steps(gen_cfg: GeneratorConfig, config: dict, crit: dict,
                       axis_name=None):
    """-> {"train": fn, "eval": fn}, each fn(state, x_noisy, x_clean) with
    (B, T, C) batches on the state's device; axis_name: the data axis, or
    None."""

    def denoise_losses(eff, x_n, x_c, record, bn_train: bool):
        # the codebook in eval mode (ref denoise.py:60)
        loss, _, new_buf = _codec_losses(gen_cfg, config, crit, eff, x_n,
                                         x_c, record, train=False,
                                         bn_train=bn_train)
        record["generator_loss"] = loss
        return loss, new_buf

    def train_step(state, x_n, x_c):
        record = {}
        gen_opt = state["gen_opt"]
        eff, _ = resolve_params(state["gen"])
        loss, new_buf = denoise_losses(
            _frozen_detached(eff, DENOISE_FROZEN), x_n, x_c, record, True)
        gen_opt.step(loss, _trained_paths(gen_opt, DENOISE_FROZEN),
                     axis=axis_name)
        state["gen"] = merge_forward_buffers(state["gen"], new_buf)
        return state, _psum_mean(_detached(record), axis_name)

    @torch.no_grad()
    def eval_step(state, x_n, x_c):
        record = {}
        eff, _ = resolve_params(state["gen"])
        denoise_losses(eff, x_n, x_c, record, False)
        return _psum_mean(_detached(record), axis_name)

    return {"train": train_step, "eval": eval_step}


def is_buffer(path: str) -> bool:
    """Leaves no optimizer drives: the quantizer's codebooks and EMA
    statistics, BN's running statistics, spectral norm's `u`, and a
    vocoder's input statistics `mean` and `scale` (torch buffers in the
    reference, ref models/vocoder/HiFiGAN.py:206-219)."""
    parts = path.split("/")
    return (parts[0] == "quantizer" or parts[-1] == "u"
            or (len(parts) == 1 and parts[0] in ("mean", "scale"))
            or (len(parts) > 2 and parts[-2] == "bn"
                and parts[-1] in ("mean", "var", "count")))


def train_state(gen: dict, disc: Optional[dict], config: dict,
                analyzer: Optional[dict] = None) -> dict:
    """{gen, gen_opt[, disc, disc_opt][, analyzer]}, each optimizer over
    every leaf of its tree but the buffers; no discriminator for
    denoising, the frozen analyzer for a vocoder."""
    def trained(tree):
        return [(p, t) for p, t in tree_leaves(tree) if not is_buffer(p)]

    state = {"gen": gen,
             "gen_opt": Optimizer(config, "generator", trained(gen))}
    if disc is not None:
        state.update(disc=disc, disc_opt=Optimizer(config, "discriminator",
                                                   trained(disc)))
    if analyzer is not None:
        state["analyzer"] = analyzer
    return state
