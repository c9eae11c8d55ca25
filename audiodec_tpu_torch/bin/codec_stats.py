"""Code statistics for vocoder training (counterpart of
audiodec_tpu/bin/codec_stats.py; ref codecStatistic.py).

The frozen analyzer's encoder -> projector -> quantize-dequantize runs over
a training subset, and the running mean and standard deviation of the codes
zq (Chan/Welford in float64, what sklearn's StandardScaler.partial_fit
gives, ref codecStatistic.py:92-112, a constant feature's scale 1 as
there) are saved as np.stack([mean, scale]), a (2, code_dim) float32 .npy
that the vocoder's input normalization reads (`generator_params.stats`).

    python -m audiodec_tpu_torch.bin.codec_stats \\
        --config configs/statistic/symAD_vctk_48000_hop300_clean.yaml \\
        [--analyzer CKPT] [--data-path DIR] [--out stats.npy] [--device cpu]

Utterances are cut into fixed-size windows, batched; each window carries
the encoder's receptive-field halo of real left context, so the codes
equal a whole-utterance encode's to f32 rounding.  The card is the default
device, with TF32 off.

`--dp N` splits each batch of windows over N ranks (started as
bin/codec_train.py's docstring says: torchrun, or --coordinator
--num-processes --process-id): each rank encodes its rows, the codes are
gathered on every rank, and the first rank writes the file.  The merge is
exact, so N ranks give one rank's moments to f32 rounding.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from audiodec_tpu_torch.bin.codec_test import require_device
from audiodec_tpu_torch.bin.codec_train import load_analyzer
from audiodec_tpu_torch.data.dataset import SingleDataset
from audiodec_tpu_torch.models.autoencoder import (
    encoder_apply,
    projector_apply,
)
from audiodec_tpu_torch.ops.vq import rvq_forward_index
from audiodec_tpu_torch.parallel.codec import encoder_halo_samples
from audiodec_tpu_torch.parallel.distributed import (
    add_parallel_flags,
    global_mesh,
    join_world,
    process_index,
    world_size,
)
from audiodec_tpu_torch.utils.config import load_config


class RunningMoments:
    """Chan's parallel Welford merge over batches of frames."""

    def __init__(self, dim: int):
        self.n = 0
        self.mean = np.zeros(dim, np.float64)
        self.m2 = np.zeros(dim, np.float64)

    def update(self, frames: np.ndarray):
        """frames: (N, D)."""
        n_b = len(frames)
        if n_b == 0:
            return
        mean_b = frames.mean(axis=0)
        m2_b = ((frames - mean_b) ** 2).sum(axis=0)
        if self.n == 0:
            self.n, self.mean, self.m2 = n_b, mean_b, m2_b
            return
        delta = mean_b - self.mean
        tot = self.n + n_b
        self.mean += delta * n_b / tot
        self.m2 += m2_b + delta ** 2 * self.n * n_b / tot
        self.n = tot

    def finalize(self):
        """-> (mean, scale), float32: the population standard deviation,
        1 for a feature StandardScaler calls constant (its variance within
        float64 rounding of 0, sklearn's `_is_constant_feature`), as the
        reference's `scaler.scale_` has it; a 0 there would make the
        vocoder's normalized input 0 / 0."""
        var = self.m2 / self.n
        eps = np.finfo(np.float64).eps
        constant = var <= self.n * eps * var + (self.n * self.mean * eps) ** 2
        scale = np.where(constant, 1.0, np.sqrt(var))
        return self.mean.astype(np.float32), scale.astype(np.float32)


def _windows(dataset, window: int, hop: int, halo: int = 0):
    """Yield (a (halo + window, C) slice, its number of valid frames) over
    every utterance: whole windows, then the tail if it holds a hop, zero
    padded.  Each window carries `halo` samples of its own utterance's left
    context (zeros at the utterance's start, the batch path's own
    padding); the consumer drops the first halo // hop frames of its
    codes."""
    for i in range(len(dataset)):
        x = dataset[i]

        def make(s, n_samples):
            buf = np.zeros((halo + window, x.shape[-1]), np.float32)
            lo = max(0, s - halo)
            start = halo - (s - lo)
            buf[start:start + (s + n_samples - lo)] = x[lo:s + n_samples]
            return buf

        for s in range(0, len(x) - window + 1, window):
            yield make(s, window), window // hop
        rem = len(x) % window if len(x) >= window else len(x)
        if rem >= hop:
            yield make(len(x) - rem, rem), rem // hop


def extract_stats(params, cfg, dataset, window_hops: int = 160,
                  batch_size: int = 8, axis=None) -> np.ndarray:
    """The codes' moments over fixed-size windows in batches of
    `batch_size` (the last one zero padded to that shape), on the device
    of the analyzer's tree `params` -> (2, code_dim) float32 [mean, scale].
    The grouping of windows does not change the moments (the merge is
    exact).  axis: a data axis (parallel/distributed.py `Axis`) whose
    ranks each encode their contiguous rows of every batch, the codes
    then gathered on all of them (JAX's `dp`); batch_size must divide
    over it."""
    device = params["quantizer"]["embed"].device
    if axis is not None and batch_size % axis.size:
        raise ValueError(f"--batch-size {batch_size} must divide over "
                         f"--dp {axis.size}")
    halo = encoder_halo_samples(cfg)
    halo_frames = halo // cfg.hop_length

    @torch.no_grad()
    def codes(x):
        h = encoder_apply(params["encoder"], x, cfg)
        z = projector_apply(params["projector"], h, cfg)
        return rvq_forward_index(z, params["quantizer"])[0][:, halo_frames:]

    window = cfg.hop_length * window_hops
    mom = RunningMoments(cfg.code_dim)

    def flush(buf, counts):
        xb = np.zeros((batch_size,) + buf[0].shape, np.float32)
        xb[:len(buf)] = np.stack(buf)
        if axis is None:
            zq = codes(torch.from_numpy(xb).to(device)).cpu().numpy()
        else:
            rows = batch_size // axis.size
            mine = xb[axis.index * rows:(axis.index + 1) * rows]
            zq = axis.all_gather(codes(torch.from_numpy(mine).to(device)),
                                 0).cpu().numpy()
        mom.update(np.concatenate([zq[j, :n] for j, n in enumerate(counts)],
                                  axis=0).astype(np.float64))

    buf, counts = [], []
    for w, n_frames in _windows(dataset, window, cfg.hop_length, halo):
        buf.append(w)
        counts.append(n_frames)
        if len(buf) == batch_size:
            flush(buf, counts)
            buf, counts = [], []
    if buf:
        flush(buf, counts)
    return np.stack(mom.finalize())


def main(argv=None) -> np.ndarray:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--analyzer", default=None)
    parser.add_argument("--data-path", default=None)
    parser.add_argument("--subset", default="train")
    parser.add_argument("--subset-num", type=int, default=-1,
                        help="only scan the first N utterances "
                             "(ref codecStatistic.py --subset_num)")
    parser.add_argument("--out", default=None)
    parser.add_argument("--batch-size", type=int, default=8,
                        help="windows per device batch")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda)")
    add_parallel_flags(parser, "data-parallel ranks, each encoding its "
                               "rows of every batch (default: the world)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    config = load_config(args.config)
    device = join_world(args, parser, require_device(args.device))
    axis = None
    if args.dp > 1 or world_size() > 1:
        axis = global_mesh(data=-1 if args.dp <= 1 else args.dp,
                           device=device).axis("data")
    params, cfg = load_analyzer(args.analyzer or config["analyzer"], device)
    data_path = args.data_path or os.path.join(
        config["data"]["path"], config["data"]["subset"][args.subset])
    dataset = SingleDataset(data_path, subset_num=args.subset_num)
    stats = extract_stats(params, cfg, dataset, batch_size=args.batch_size,
                          axis=axis)
    if process_index() == 0:
        out = args.out or config.get("stats", "stats.npy")
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        np.save(out, stats)
        logging.info("saved stats %s (shape %s)", out, stats.shape)
    return stats


if __name__ == "__main__":
    main()
