"""Training entry point (counterpart of audiodec_tpu/bin/codec_train.py;
ref codecTrain.py, bin/train.py) for every `train_mode` of a config:

- autoencoder: symAD with the HiFiGAN discriminator (model_type
  symAudioDec) or UnivNet's (symAudioDecUniv), in two stages, the
  metric-only one and then the adversarial one with the encoder, projector
  and quantizer frozen;
- vocoder: a HiFiGAN vocoder (model_type HiFiGAN), weight-normed, on the
  codes of a frozen symAD analyzer (the config's `analyzer:` checkpoint,
  its config.yml beside it), its input normalized by the statistics file
  that bin/codec_stats.py writes (`generator_params.stats`); the same two
  stages, the adversarial one from the step after
  `discriminator_train_start_steps`;
- denoise: a symAD generator warm-started from a trained one (`initial:`)
  on (noisy, clean) pair corpora, with the quantizer and decoder frozen.

    python -m audiodec_tpu_torch.bin.codec_train \\
        --config configs/autoencoder/symAD_vctk_48000_hop300.yaml \\
        --tag exp/autoencoder/mytag [--resume CKPT] [--device cpu]

Data-parallel training over N ranks (one per device, parallel/distributed.py
says which backend): start N processes with torchrun
(`torchrun --nproc-per-node N -m audiodec_tpu_torch.bin.codec_train ...`)
or each with `--coordinator host:port --num-processes N --process-id I`,
all with the same arguments; `--dp N` names the data axis (default: the
whole world).  `batch_size` is the global batch: every rank builds the same
global batch from the same seeds (the loader draws the crops in batch order
for any number of threads) and trains on its contiguous rows; the
gradients, the RVQ's statistics and the records are averaged over the
ranks, so N ranks train as one does at the same global batch.  Only the
first rank writes config.yml, the metrics and the checkpoints.

It writes config.yml, metrics.jsonl and the checkpoints (the JAX package's
format: its `load_only_params` and the port's `codec_test` read them) under
the tag.  Initial weights come from a torch.Generator seeded by --seed (not
JAX's draw); a config's `initial:` checkpoint warm-starts the generator in
every mode.  The card is the default device, with TF32 off.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from audiodec_tpu_torch.bin.codec_test import require_device
from audiodec_tpu_torch.data.collate import CollaterAudio, CollaterAudioPair
from audiodec_tpu_torch.data.dataset import MultiDataset, SingleDataset
from audiodec_tpu_torch.data.loader import DataLoader
from audiodec_tpu_torch.models import discriminators as D
from audiodec_tpu_torch.models.autoencoder import generator_init
from audiodec_tpu_torch.models.vocoder import vocoder_init
from audiodec_tpu_torch.ops.norms import apply_weight_norm_tree
from audiodec_tpu_torch.parallel.distributed import (
    add_parallel_flags,
    global_mesh,
    join_world,
    process_index,
    world_size,
)
from audiodec_tpu_torch.train.checkpoint import load_params_into
from audiodec_tpu_torch.train.criterion import build_criterion
from audiodec_tpu_torch.train.steps import (
    make_autoencoder_steps,
    make_denoise_steps,
    make_vocoder_steps,
    shard_steps,
    train_state,
)
from audiodec_tpu_torch.train.trainer import GanTrainer
from audiodec_tpu_torch.utils.bridge import params_from_jax, tree_map
from audiodec_tpu_torch.utils.checkpoint import load_only_params
from audiodec_tpu_torch.utils.config import (
    discriminator_config,
    dump_yaml,
    generator_config,
    load_config,
    load_config_near_checkpoint,
)

TRAIN_MODES = ("autoencoder", "vocoder", "denoise")


def _subset_path(config, subset):
    return os.path.join(config["data"]["path"],
                        config["data"]["subset"][subset])


def build_dataloaders(config, train_mode, batch_length):
    """(train, valid) loaders: one corpus for the GAN modes, (noisy,
    clean) pair corpora for denoising (ref: codecTrain.py:55-65)."""
    bs = config.get("batch_size", 16)
    workers = config.get("num_workers", 2)
    if train_mode == "denoise":
        col = CollaterAudioPair(batch_length)

        def dataset(subset):
            return MultiDataset([_subset_path(config, f"noisy_{subset}"),
                                 _subset_path(config, f"clean_{subset}")])
    else:
        col = CollaterAudio(batch_length)

        def dataset(subset):
            return SingleDataset(_subset_path(config, subset))

    def loader(subset, shuffle):
        return DataLoader(dataset(subset), col, bs, shuffle=shuffle,
                          num_workers=workers)

    return loader("train", True), loader("valid", False)


def load_analyzer(ckpt: str, device):
    """The frozen symAD analyzer of vocoder training and of codec_stats (a
    checkpoint with its config.yml beside it) -> (its tree on `device`,
    norms folded, and its GeneratorConfig) (ref: codecTrain.py:258-267)."""
    gen_cfg = generator_config(load_config_near_checkpoint(ckpt))
    tree, _ = load_only_params(ckpt, "gen")
    return tree_map(lambda t: t.to(device), params_from_jax(tree)), gen_cfg


def _discriminator(config, rng):
    """(params, apply) of the config's discriminator."""
    disc_cfg = discriminator_config(config)
    if isinstance(disc_cfg, D.UnivNetDiscriminatorConfig):
        disc = D.univnet_discriminator_init(rng, disc_cfg)
        apply = D.univnet_discriminator_apply
    else:
        disc = D.hifigan_discriminator_init(rng, disc_cfg)
        apply = D.hifigan_discriminator_apply
    return disc, (lambda p, x: apply(p, x, disc_cfg))


def build_models(config, train_mode, device, seed: int):
    """(gen_cfg, gen, disc_apply, disc) from a seeded torch.Generator;
    no discriminator (None, None) for denoising."""
    gen_cfg = generator_config(config)
    rng = torch.Generator(device=device).manual_seed(seed)
    gp = config.get("generator_params", {})
    if train_mode == "vocoder":
        gen = vocoder_init(gen_cfg, rng)
        if gp.get("use_weight_norm", True):
            # axis 0 is the preserved one, the transposed convs' input
            # channels included (JAX's transposed_paths)
            gen = apply_weight_norm_tree(gen)
        if gen_cfg.stats and gp.get("stats"):
            stats = np.load(gp["stats"])
            gen["mean"] = torch.as_tensor(stats[0].reshape(-1),
                                          device=device)
            gen["scale"] = torch.as_tensor(stats[1].reshape(-1),
                                           device=device)
    else:
        gen = generator_init(gen_cfg, rng)
        if gp.get("use_weight_norm", False):
            # weight-norm reparametrized training (ref: AudioDec.py:107-109)
            gen = apply_weight_norm_tree(gen)
    if train_mode == "denoise":
        return gen_cfg, gen, None, None
    disc, disc_apply = _discriminator(config, rng)
    return gen_cfg, gen, disc_apply, disc


def build_trainer(argv=None) -> GanTrainer:
    """Parse the command line and set up the run: config.yml, data, models,
    steps and the trainer (resumed where --resume is given)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--tag", required=True, help="experiment output dir")
    parser.add_argument("--exp-root", default="",
                        help="prefix joined ahead of --tag (expdir = "
                             "exp_root/tag)")
    parser.add_argument("--resume", default="")
    parser.add_argument("--seed", type=int, default=1337)
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    add_parallel_flags(parser, "data-parallel ranks (default: the world)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    device = join_world(args, parser, require_device(args.device))
    config = load_config(args.config)
    train_mode = config.get("train_mode", "autoencoder")
    if train_mode not in TRAIN_MODES:
        raise NotImplementedError(f"train_mode {train_mode!r}")
    axis_name = None
    if args.dp > 1 or world_size() > 1:
        # grads, EMA statistics and records averaged over every rank, so
        # N ranks train as one does at the same global batch
        axis_name = global_mesh(data=-1 if args.dp <= 1 else args.dp,
                                device=device).axis("data")
    primary = process_index() == 0
    if args.exp_root:
        args.tag = os.path.join(args.exp_root, args.tag)
    os.makedirs(args.tag, exist_ok=True)
    if primary:
        # snapshot the config beside the checkpoints (ref: bin/train.py:58-64)
        with open(os.path.join(args.tag, "config.yml"), "w") as f:
            f.write(dump_yaml(config))

    gen_cfg, gen, disc_apply, disc = build_models(config, train_mode,
                                                  device, args.seed)
    if config.get("initial"):
        # warm start (ref `initial:` key, codecTrain.py:245-247)
        params, _ = load_only_params(config["initial"], "gen", fold=False)
        gen = load_params_into(gen, params)
        logging.info("Warm-started generator from %s", config["initial"])
    crit = build_criterion(config)
    if train_mode == "autoencoder":
        state = train_state(gen, disc, config)
        steps = make_autoencoder_steps(gen_cfg, disc_apply, config, crit,
                                       axis_name=axis_name)
    elif train_mode == "vocoder":
        analyzer, an_cfg = load_analyzer(config["analyzer"], device)
        state = train_state(gen, disc, config, analyzer=analyzer)
        steps = make_vocoder_steps(gen_cfg, an_cfg, disc_apply, config,
                                   crit, axis_name=axis_name)
    else:
        state = train_state(gen, None, config)
        steps = make_denoise_steps(gen_cfg, config, crit,
                                   axis_name=axis_name)
    if axis_name is not None:
        steps = shard_steps(steps, axis_name)

    bl = config.get("batch_length", 9600)
    adv_bl = config.get("adv_batch_length", bl)
    train_dl, valid_dl = build_dataloaders(config, train_mode, bl)
    adv_dl = (train_dl if adv_bl == bl
              else build_dataloaders(config, train_mode, adv_bl)[0])
    trainer = GanTrainer(
        steps_fns=steps, state=state, config=config, outdir=args.tag,
        train_iter=train_dl.infinite(), adv_train_iter=adv_dl.infinite(),
        eval_iter_fn=lambda: iter(valid_dl), device=device,
        strict_start=(train_mode == "autoencoder"), primary=primary,
        steps_per_epoch=len(train_dl) or None,
        adv_steps_per_epoch=len(adv_dl) or None)
    if args.resume:
        trainer.resume(args.resume)
    return trainer


def main(argv=None):
    trainer = build_trainer(argv)
    trainer.run()
    return trainer


if __name__ == "__main__":
    main()
