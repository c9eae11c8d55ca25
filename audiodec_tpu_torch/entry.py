"""Two whole-model checks (counterpart of __graft_entry__.py).

entry(): the symAD generator's eval forward at the full
`GeneratorConfig()` width (symAD_vctk_48000_hop300) with seeded weights,
and an example input -> (fn, (params, x)); fn(params, x) gives
(y, zq, vqloss), as JAX's does.

dryrun_multichip(n): the three cross-device workloads of JAX's dryrun on
its tiny codec, over n ranks (one process per device, parallel/): one
data-parallel metric step and one adversarial GAN step over every rank
(averaged gradients, summed EMA statistics), the chunk-halo transcode
over a data x seq mesh (seq = 2 for even n), direct and with each shard's
batch folds (encode_fold = decode_fold = 2), and the tensor-parallel
transcode over a data x model mesh (model = 2 for even n).  The direct
sharded transcode's indices must equal the unsharded transcode's and its
waveform must match to f32 rounding; the folded and channel-parallel
transcodes must give finite outputs of the unsharded shapes (a fold or a
channel split reorders f32 sums, so an index on a near tie may move; the
share of equal indices is printed).

    python -m audiodec_tpu_torch.entry [--device cpu]
    python -m audiodec_tpu_torch.entry --dryrun N [--device cpu]

Outside a world of ranks, dryrun_multichip(n) starts n ranks on this
machine (bin/multihost_probe.py's launcher, a rendezvous on localhost)
and waits for them; inside one (torchrun's environment, or a process that
has joined), it runs this rank's part, and a world of another size than
n is refused with how to start the ranks.  The ranks run on the card
unless device="cpu" asks for the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

from audiodec_tpu_torch.bin.codec_test import require_device
from audiodec_tpu_torch.models.autoencoder import (
    GeneratorConfig,
    generator_forward,
    generator_init,
)
from audiodec_tpu_torch.utils.bridge import tree_map

EXAMPLE_SHAPE = (2, 9600, 1)     # batch_length of the symAD config
TINY = dict(encode_channels=2, decode_channels=2, code_dim=8,
            codebook_num=2, codebook_size=16)


def entry(device=None):
    """-> (fn, (params, x)): the symAD eval forward at full width, seeded
    weights and a zero (2, 9600, 1) input on `device` (the card unless the
    caller asks for the CPU)."""
    device = require_device(device)
    cfg = GeneratorConfig()
    params = tree_map(lambda t: t.to(device),
                      generator_init(cfg, torch.Generator().manual_seed(0)))
    x = torch.zeros(EXAMPLE_SHAPE, device=device)

    @torch.no_grad()
    def fn(params, x):
        y, zq, _, vqloss, _, _ = generator_forward(params, x, cfg,
                                                   train=False)
        return y, zq, vqloss

    return fn, (params, x)


def _transcode(mesh, codec, spec, x_full):
    """One sharded transcode of the global batch x_full -> (idx, y), the
    whole arrays on every rank of the mesh."""
    from audiodec_tpu_torch.parallel import (
        global_to_host_local,
        host_local_to_global,
        local_block,
    )
    encode, decode = codec
    idx = encode(host_local_to_global(mesh, spec,
                                      local_block(mesh, spec, x_full)))
    y = decode(idx)
    return (global_to_host_local(mesh, idx, spec),
            global_to_host_local(mesh, y, spec))


def dryrun_rank(device) -> str:
    """This rank's part of dryrun_multichip, in a world that it has
    joined -> the summary line."""
    from audiodec_tpu_torch.bin.multihost_probe import (
        TINY_GAN_CONFIG,
        same_on_every_rank,
    )
    from audiodec_tpu_torch.models import discriminators as D
    from audiodec_tpu_torch.models.autoencoder import (
        decoder_apply,
        encoder_apply,
        projector_apply,
    )
    from audiodec_tpu_torch.ops.vq import rvq_forward_index, rvq_lookup
    from audiodec_tpu_torch.parallel import (
        global_mesh,
        make_mesh,
        make_sharded_codec,
        make_tp_codec,
        make_tp_mesh,
    )
    from audiodec_tpu_torch.train.criterion import build_criterion
    from audiodec_tpu_torch.train.steps import (
        make_autoencoder_steps,
        shard_steps,
        train_state,
    )

    n = dist.get_world_size()
    cfg = GeneratorConfig(**TINY)
    hop = cfg.hop_length
    disc_cfg = D.HiFiGANDiscriminatorConfig(
        msd=D.MultiScaleConfig(scales=2, follow_official_norm=True,
                               discriminator=D.ScaleDiscriminatorConfig(
                                   channels=16, max_downsample_channels=32,
                                   max_groups=4)),
        mpd=D.MultiPeriodConfig(periods=(2, 3),
                                discriminator=D.PeriodDiscriminatorConfig(
                                    channels=4, max_downsample_channels=16)))
    gen_rng = torch.Generator(device=device).manual_seed(0)
    state = train_state(generator_init(cfg, gen_rng),
                        D.hifigan_discriminator_init(gen_rng, disc_cfg),
                        TINY_GAN_CONFIG)

    # 1. one data-parallel metric step and one adversarial step
    axis = global_mesh(data=-1, device=device).axis("data")
    steps = shard_steps(make_autoencoder_steps(
        cfg, lambda p, v: D.hifigan_discriminator_apply(p, v, disc_cfg),
        TINY_GAN_CONFIG, build_criterion(TINY_GAN_CONFIG), axis_name=axis),
        axis)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(0.1 * rng.randn(n, 2 * hop, 1).astype(np.float32))
    for kind in ("metric", "adv"):
        state, rec = steps[kind](state, x.to(device))
        if not all(torch.isfinite(v).all() for v in rec.values()):
            raise AssertionError(f"{kind} step: records not finite")
        if not same_on_every_rank(state):
            raise AssertionError(f"{kind} step: the ranks' params differ")
    gen = tree_map(lambda t: t.detach(), state["gen"])
    cpu_gen = tree_map(lambda t: t.cpu(), gen)

    @torch.no_grad()
    def unsharded(xs):
        h = encoder_apply(cpu_gen["encoder"], torch.from_numpy(xs), cfg)
        z = projector_apply(cpu_gen["projector"], h, cfg)
        _, i = rvq_forward_index(z, cpu_gen["quantizer"])
        return i.numpy(), decoder_apply(cpu_gen["decoder"], rvq_lookup(
            i, cpu_gen["quantizer"]), cfg).numpy()

    def finite_like(name, got, ref):
        idx, y = got
        if idx.shape != ref[0].shape or y.shape != ref[1].shape:
            raise AssertionError(f"{name}: shapes {idx.shape}, {y.shape}")
        if not np.isfinite(y).all():
            raise AssertionError(f"{name}: waveform not finite")
        return float(np.mean(idx == ref[0]))

    # 2. data x seq chunk-halo transcode, direct and with the folds
    seq = 2 if n % 2 == 0 else 1
    mesh = make_mesh(data=n // seq, seq=seq, device=device)
    spec = ("data", "seq", None)
    xt = (0.3 * rng.randn(n // seq, seq * 8 * hop, 1)).astype(np.float32)
    ref = unsharded(xt)
    idx, y = _transcode(mesh, make_sharded_codec(mesh, gen, cfg), spec, xt)
    if not np.array_equal(idx, ref[0]):
        raise AssertionError("sharded transcode: indices differ")
    np.testing.assert_allclose(y, ref[1], rtol=1e-5, atol=1e-6)
    folded = finite_like("folded sharded transcode", _transcode(
        mesh, make_sharded_codec(mesh, gen, cfg, encode_fold=2,
                                 decode_fold=2), spec, xt), ref)

    # 3. data x model tensor-parallel transcode
    tp = 2 if n % 2 == 0 else 1
    tp_mesh = make_tp_mesh(data=n // tp, model=tp, device=device)
    xp = (0.3 * rng.randn(n // tp, 8 * hop, 1)).astype(np.float32)
    channel = finite_like("tensor-parallel transcode", _transcode(
        tp_mesh, make_tp_codec(tp_mesh, gen, cfg), ("data", None, None),
        xp), unsharded(xp))
    return (f"dryrun_multichip({n}): ok - dp train step + {n // seq}x{seq} "
            f"chunk-halo transcode (direct: indices equal; shard-local "
            f"batch-fold: {folded:.4f} of the indices equal) + "
            f"{n // tp}x{tp} tensor-parallel transcode ({channel:.4f} "
            f"equal), {dist.get_backend()} on {device}")


def dryrun_multichip(n_devices: int, device=None, timeout: float = 600):
    """Run the dryrun over n_devices ranks (module docstring) -> the
    summary lines, one per rank."""
    from audiodec_tpu_torch.bin import multihost_probe
    from audiodec_tpu_torch.parallel.distributed import (
        init_distributed,
        world_size,
    )

    device = require_device(device)
    if not (dist.is_initialized() or "WORLD_SIZE" in os.environ):
        # one thread a rank on the CPU, where the ranks share the cores
        outs = multihost_probe.run_ranks(
            n_devices, ["--worker", "dryrun", "--device", device.type,
                        "--threads", "1" if device.type == "cpu" else "0"],
            timeout=timeout)
        lines = [line for out in outs for line in out.splitlines()
                 if line.startswith("dryrun_multichip(")]
        if len(lines) != n_devices:
            raise RuntimeError(f"{len(lines)} of {n_devices} ranks "
                               f"reported:\n" + "\n".join(outs))
        return lines
    device = init_distributed(device=device)
    if world_size() != n_devices:
        raise ValueError(
            f"dryrun_multichip({n_devices}) needs a world of {n_devices} "
            f"ranks, one per device, and this one has {world_size()}: call "
            f"it outside a world (it starts the ranks itself), or start "
            f"them with torchrun --nproc-per-node {n_devices} -m "
            f"audiodec_tpu_torch.entry --dryrun {n_devices}")
    return [dryrun_rank(device)]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dryrun", type=int, default=0,
                   help="run dryrun_multichip over this many ranks")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.dryrun:
        for line in dryrun_multichip(args.dryrun, args.device):
            print(line, flush=True)
        return
    fn, example = entry(args.device)
    y, zq, vqloss = fn(*example)
    if not all(torch.isfinite(t).all() for t in (y, zq, vqloss)):
        raise AssertionError("entry: outputs not finite")
    print(f"entry: ok - y {tuple(y.shape)}, zq {tuple(zq.shape)}, "
          f"vqloss {tuple(vqloss.shape)} on {y.device}", flush=True)


if __name__ == "__main__":
    main()
