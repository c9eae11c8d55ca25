"""Multi-rank verification probe (counterpart of tools/multihost_probe.py:
`worker`, `main`), and the rank launcher the tests and chip_smoke.py use.

    python -m audiodec_tpu_torch.bin.multihost_probe [--nprocs 4] \\
        [--seq 2] [--device cuda|cpu]

starts N ranks of itself on this machine (one process each, a rendezvous
at localhost on a free port; parallel/distributed.py picks the backend:
gloo on the CPU and on ranks that share a card) and runs the two
cross-rank workloads of the JAX probe on a tiny codec:

  1. the chunk-halo sharded transcode (parallel/codec.py
     `make_sharded_codec`) on a (N / seq) x seq mesh, its halo exchanges
     crossing ranks, against an unsharded transcode of the same batch:
     indices equal, the waveform within rtol 1e-5 / atol 1e-6; then a
     (1, N) mesh whose 2-hop shards are far shorter than the encoder's
     halo, so that the chained halo crosses every rank;
  2. data-parallel GAN steps (train/steps.py with the data axis: averaged
     gradients, summed EMA statistics) over all N ranks, one metric and
     one adversarial step, the records finite and the params identical
     on every rank after each step.

Each rank prints "multihost_probe rank i/N: OK ...", the launcher
"multihost_probe: OK".  A failing rank fails the run; the launcher stops
every rank it started.

Other workers, run by `run_ranks` (`--worker NAME`):
  codec_cases: the sharded and channel-parallel codecs over the cases of
      an input file, each case's whole outputs written by rank 0 and each
      rank's times, collectives, kernel launches and peak memory;
  train_cases: data-parallel steps of the three train modes and the RVQ's
      reduced statistics over the input file's batches;
  cli: command lines (codec_test, codec_train, codec_stats), one after
      the other in one world, with the rendezvous flags added; codec_train's
      ranks also check that every rank steps on the same global batch and
      holds the same params after each step;
  dryrun: entry.py's dryrun_multichip (its three workloads on JAX's tiny
      codec), each rank printing its summary line.

The ranks run on the card (all bound to cuda:0 on a one-card machine)
unless `--device cpu` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[2]
MODULE = "audiodec_tpu_torch.bin.multihost_probe"


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def free_port() -> int:
    """A port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(nprocs: int, worker_argv: list, timeout: float = 600,
              env: dict | None = None) -> list:
    """Start `nprocs` ranks of this module's `worker_argv` (rank i gets
    --coordinator localhost:PORT --num-processes N --process-id i), wait
    for all -> their outputs (stdout and stderr together), in rank order.
    A rank that fails or a run past `timeout` seconds stops every rank and
    raises with the outputs' tails."""
    port = free_port()
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    # the rendezvous flags are the probe's, ahead of a command line's `--`
    cut = worker_argv.index("--") if "--" in worker_argv else None
    head = worker_argv[:cut]
    tail = worker_argv[cut:] if cut is not None else []
    logs = [tempfile.TemporaryFile("w+") for _ in range(nprocs)]
    procs = []
    try:
        for i in range(nprocs):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", MODULE, *head,
                 "--coordinator", f"localhost:{port}",
                 "--num-processes", str(nprocs), "--process-id", str(i),
                 *tail],
                cwd=ROOT, env=env, stdout=logs[i], stderr=subprocess.STDOUT,
                text=True))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read())
        f.close()
    rcs = [p.returncode for p in procs]
    if any(rcs):
        tails = "\n".join(f"--- rank {i} (exit {rc}) ---\n{out[-4000:]}"
                          for i, (rc, out) in enumerate(zip(rcs, outs)))
        raise RuntimeError(f"ranks failed {rcs} on {worker_argv}:\n{tails}")
    return outs


# ---------------------------------------------------------------------------
# helpers of the workers
# ---------------------------------------------------------------------------

def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launches(device: torch.device) -> dict:
    """Every kernel wrapper's launch count in this rank (chip_smoke.py
    `read_launches`) and, on the card, the CUDA launches of the libraries
    that count their own."""
    from audiodec_tpu_torch.archive import resunit_kernel, vq_kernel
    from audiodec_tpu_torch.ops.kernels import (
        ablate_stack,
        dot_chain,
        folded_stack,
    )
    counts = {"mma": folded_stack.mma_launches,
              "mma_voc": folded_stack.mma_voc_launches,
              "mma_other": folded_stack.mma_other_launches,
              "int8": folded_stack.int8_launches,
              "resunit": resunit_kernel.launches,
              "rvq": vq_kernel.launches,
              "dot_chain": dot_chain.launches,
              "ablate": ablate_stack.launches,
              "int8_tile": folded_stack.int8_tile_launches,
              "wide": folded_stack.wide_launches,
              "resunit_f32": folded_stack.resunit_launches}
    if device.type == "cuda":
        for src in ("resunit_stack", "wide_stack_mma"):
            counts[f"cuda_{src}"] = folded_stack.cuda_launches(src)
    return counts


def _peak_gib(device: torch.device):
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2 ** 30


def _flat_params(state: dict) -> torch.Tensor:
    """Every leaf of the state's gen and disc trees in one vector, but a
    BN projector's running statistics: each rank keeps those of its own
    rows, as each of JAX's devices does (train/steps.py)."""
    from audiodec_tpu_torch.train.optim import tree_leaves
    leaves = [t.detach().reshape(-1).float()
              for key in ("gen", "disc") if key in state
              for path, t in tree_leaves(state[key])
              if not (path.split("/")[-2:-1] == ["bn"]
                      and path.endswith(("/mean", "/var")))]
    return torch.cat(leaves)


def same_on_every_rank(state: dict) -> bool:
    """True where every rank's params equal rank 0's, bit for bit (rank
    0's broadcast and compared; the verdict all-reduced)."""
    return _equal_on_every_rank(_flat_params(state))


def _equal_on_every_rank(flat: torch.Tensor) -> bool:
    ref = flat.clone()
    dist.broadcast(ref, 0)
    bad = torch.tensor([0.0 if torch.equal(flat, ref) else 1.0],
                       device=flat.device)
    dist.all_reduce(bad)
    return bool(bad.item() == 0.0)


def check_steps_in_sync(steps: dict, timings: dict) -> dict:
    """The step functions (of `shard_steps`, fed the global batch), each
    preceded by the every-rank check of that batch and followed by the
    every-rank params check (either raises on a divergence), and timed on
    this rank's clock (after a synchronize) into timings[name]."""
    def wrap(name, fn):
        def step(state, *batch):
            device = batch[0].device
            if not _equal_on_every_rank(torch.cat(
                    [b.reshape(-1).float() for b in batch])):
                raise AssertionError(f"{name} step: the ranks' global "
                                     f"batches differ")
            _sync(device)
            t0 = time.perf_counter()
            out = fn(state, *batch)
            _sync(device)
            timings.setdefault(name, []).append(
                1e3 * (time.perf_counter() - t0))
            if not same_on_every_rank(out[0] if isinstance(out, tuple)
                                      else state):
                raise AssertionError(f"{name} step: the ranks' params "
                                     f"differ")
            return out
        return step
    return {name: wrap(name, fn) for name, fn in steps.items()}


# ---------------------------------------------------------------------------
# the probe
# ---------------------------------------------------------------------------

TINY_GAN_CONFIG = {
    "sampling_rate": 48000,
    "use_mel_loss": True,
    "mel_loss_params": {"fs": 48000, "fft_sizes": [256], "hop_sizes": [64],
                        "win_lengths": [256], "num_mels": 8, "fmin": 0,
                        "fmax": 24000, "log_base": None},
    "use_feat_match_loss": True,
    "lambda_adv": 1.0, "lambda_feat_match": 2.0, "lambda_vq_loss": 1.0,
    "lambda_mel_loss": 45.0,
    "generator_optimizer_params": {"lr": 1e-4, "betas": [0.5, 0.9]},
    "discriminator_optimizer_params": {"lr": 2e-4, "betas": [0.5, 0.9]},
    "generator_scheduler_params": {"step_size": 200000, "gamma": 1.0},
    "discriminator_scheduler_type": "MultiStepLR",
    "discriminator_scheduler_params": {"gamma": 0.5,
                                       "milestones": [200000]},
    "generator_grad_norm": -1, "discriminator_grad_norm": -1,
}


def worker_probe(args, device: torch.device, seq=None):
    """The two cross-rank workloads (module docstring) on a tiny codec;
    seq: the first workload's seq axis (default: --seq)."""
    from audiodec_tpu_torch.models import discriminators as D
    from audiodec_tpu_torch.models.autoencoder import (
        GeneratorConfig,
        decoder_apply,
        encoder_apply,
        generator_init,
        projector_apply,
    )
    from audiodec_tpu_torch.ops.vq import rvq_forward_index, rvq_lookup
    from audiodec_tpu_torch.parallel import (
        global_mesh,
        global_to_host_local,
        host_local_to_global,
        local_block,
        make_sharded_codec,
    )
    from audiodec_tpu_torch.train.criterion import build_criterion
    from audiodec_tpu_torch.train.steps import (
        make_autoencoder_steps,
        shard_steps,
        train_state,
    )

    n, rank = dist.get_world_size(), dist.get_rank()
    cfg = GeneratorConfig(encode_channels=2, decode_channels=2, code_dim=8,
                          codebook_num=2, codebook_size=16)
    params = generator_init(cfg, torch.Generator().manual_seed(0))
    hop = cfg.hop_length
    rng = np.random.RandomState(7)
    spec = ("data", "seq", None)

    @torch.no_grad()
    def ref_transcode(x):
        h = encoder_apply(params["encoder"], torch.from_numpy(x), cfg)
        z = projector_apply(params["projector"], h, cfg)
        _, i = rvq_forward_index(z, params["quantizer"])
        return (i.numpy(), decoder_apply(
            params["decoder"], rvq_lookup(i, params["quantizer"]),
            cfg).numpy())

    def transcode(mesh, x_full):
        encode, decode = make_sharded_codec(mesh, params, cfg)
        block = host_local_to_global(mesh, spec,
                                     local_block(mesh, spec, x_full))
        idx = encode(block)
        y = decode(idx)
        return (global_to_host_local(mesh, idx, spec),
                global_to_host_local(mesh, y, spec))

    # 1. data x seq, the halo exchanges crossing ranks
    seq = args.seq if seq is None else seq
    mesh = global_mesh(data=-1, seq=seq, device=device)
    data = mesh.shape["data"]
    x_full = rng.randn(data, seq * 8 * hop, 1).astype(np.float32)
    idx, y = transcode(mesh, x_full)
    idx_ref, y_ref = ref_transcode(x_full)
    if not np.array_equal(idx, idx_ref):
        raise AssertionError("sharded transcode: indices differ")
    np.testing.assert_allclose(y, y_ref, rtol=1e-5, atol=1e-6)

    # 1b. one seq line over every rank, 2-hop shards, the chained halo
    mesh_x = global_mesh(data=1, seq=n, device=device)
    x2 = rng.randn(1, n * 2 * hop, 1).astype(np.float32)
    idx2, y2 = transcode(mesh_x, x2)
    idx2_ref, y2_ref = ref_transcode(x2)
    if not np.array_equal(idx2, idx2_ref):
        raise AssertionError("multi-hop halo: indices differ")
    np.testing.assert_allclose(y2, y2_ref, rtol=1e-5, atol=1e-6)

    # 2. data-parallel GAN steps over every rank
    disc_cfg = D.HiFiGANDiscriminatorConfig(
        msd=D.MultiScaleConfig(scales=2, follow_official_norm=True,
                               discriminator=D.ScaleDiscriminatorConfig(
                                   channels=16, max_downsample_channels=32,
                                   max_groups=4)),
        mpd=D.MultiPeriodConfig(periods=(2, 3),
                                discriminator=D.PeriodDiscriminatorConfig(
                                    channels=4, max_downsample_channels=16)))
    gen_rng = torch.Generator(device=device).manual_seed(0)
    gen = generator_init(cfg, gen_rng)
    disc = D.hifigan_discriminator_init(gen_rng, disc_cfg)
    axis = global_mesh(data=-1, device=device).axis("data")
    state = train_state(gen, disc, TINY_GAN_CONFIG)
    steps = shard_steps(make_autoencoder_steps(
        cfg, lambda p, v: D.hifigan_discriminator_apply(p, v, disc_cfg),
        TINY_GAN_CONFIG, build_criterion(TINY_GAN_CONFIG),
        axis_name=axis), axis)
    xt = torch.from_numpy(rng.randn(n, 2 * hop, 1).astype(np.float32))
    for kind in ("metric", "adv"):
        state, rec = steps[kind](state, xt.to(device))
        if not all(torch.isfinite(v).all() for v in rec.values()):
            raise AssertionError(f"{kind} step: records not finite")
        if not same_on_every_rank(state):
            raise AssertionError(f"{kind} step: the ranks' params differ")
    print(f"multihost_probe rank {rank}/{n}: OK - {data}x{seq} transcode "
          f"(indices equal, waveform to f32 rounding), a 1x{n} chained "
          f"halo, data-parallel steps finite with the params equal on "
          f"every rank ({dist.get_backend()} on {device})", flush=True)


# ---------------------------------------------------------------------------
# the codec cases
# ---------------------------------------------------------------------------

def _case_mesh(case, device):
    from audiodec_tpu_torch.parallel import make_mesh, make_tp_mesh
    if case["kind"] == "tp":
        return make_tp_mesh(case["data"], case["model"], device=device)
    return make_mesh(case["data"], case["seq"], device=device)


def _case_codec(case, mesh, inputs):
    """(encode, decode, spec of the input) of one case on its mesh."""
    from audiodec_tpu_torch.parallel import make_sharded_codec, make_tp_codec
    params = inputs[case.get("params", "params")]
    if case["kind"] == "tp":
        encode, decode = make_tp_codec(mesh, params, inputs["cfg"])
        return encode, decode, ("data", None, None)
    mixed = case.get("dtype") == "mixed"
    encode, decode = make_sharded_codec(
        mesh, params, inputs["cfg"],
        vocoder=inputs["voc"] if case.get("vocoder") else None,
        dec_dtype=torch.bfloat16 if mixed else None,
        encode_fold=case.get("encode_fold", False),
        decode_fold=case.get("decode_fold", False))
    return encode, decode, ("data", "seq", None)


def _run_case(case, inputs, device, reps: int) -> tuple:
    """One case in this rank -> (its whole outputs on the mesh's ranks,
    this rank's stats).  The first call is checked and timed; `reps` more
    are timed (the first call's time stands alone where reps is 0)."""
    from audiodec_tpu_torch.parallel import (
        global_to_host_local,
        host_local_to_global,
        local_block,
    )
    from audiodec_tpu_torch.parallel.distributed import (
        comm_snapshot,
        process_index,
        reset_comm,
    )

    mesh = _case_mesh(case, device)
    if not mesh.member:
        return None, {"member": False}
    encode, decode, spec = _case_codec(case, mesh, inputs)
    x = host_local_to_global(mesh, spec, local_block(
        mesh, spec, inputs[case.get("input", "x")]))
    before = _launches(device)
    reset_comm()
    _sync(device)
    t0 = time.perf_counter()
    idx = encode(x)
    y = decode(idx)
    _sync(device)
    first_ms = 1e3 * (time.perf_counter() - t0)
    comm = comm_snapshot()
    ms = []
    for _ in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        decode(encode(x))
        _sync(device)
        ms.append(1e3 * (time.perf_counter() - t0))
    launches = {k: v - before[k] for k, v in _launches(device).items()}
    ms = ms or [first_ms]
    full = {"idx": global_to_host_local(mesh, idx, spec),
            "y": global_to_host_local(mesh, y, spec)}
    stats = {"member": True, "rank": process_index(), "coords": mesh.coords,
             "comm_per_call": comm, "ms": ms, "launches": launches,
             "peak_gib": _peak_gib(device)}
    return full, stats


def _helpers(inputs, device) -> dict:
    """process_shard, host_local_rows and global_to_host_local on a
    ('data', 'seq') mesh over the world."""
    from audiodec_tpu_torch.parallel import (
        global_mesh,
        global_to_host_local,
        host_local_rows,
        host_local_to_global,
        local_block,
        process_shard,
    )
    spec = ("data", "seq", None)
    data = inputs["helpers_data"]
    mesh = global_mesh(data=data, seq=dist.get_world_size() // data,
                       device=device)
    block = host_local_to_global(mesh, spec, local_block(mesh, spec,
                                                         inputs["x"]))
    lo, rows = host_local_rows(mesh, block)
    return {"shard": process_shard(list(range(11))), "lo": lo, "rows": rows,
            "full": global_to_host_local(mesh, block, spec),
            "coords": mesh.coords}


def worker_codec_cases(args, device: torch.device):
    """The cases of `--in` (a torch.save'd dict: params (and other trees a
    case names by its "params"), cfg, voc, inputs x / x_hop (B, T, 1)
    numpy, cases, reps (a case's own "reps" first); with probe_seq, the
    probe's workloads first, in the same world) -> `--out`/rank{i}.pt per
    rank
    ({case name: whole outputs or None}, the helpers' results) and
    `--out`/rank{i}.json (the stats)."""
    inputs = torch.load(args.inp, weights_only=False)
    rank = dist.get_rank()
    if inputs.get("probe_seq"):
        worker_probe(args, device, inputs["probe_seq"])
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    results, stats = {}, {"backend": dist.get_backend(),
                          "device": str(device), "cases": {}}
    for case in inputs["cases"]:
        full, st = _run_case(case, inputs, device,
                             case.get("reps", inputs.get("reps", 0)))
        results[case["name"]] = full
        stats["cases"][case["name"]] = st
        dist.barrier()
    if inputs.get("helpers_data"):
        results["helpers"] = _helpers(inputs, device)
    staged = set()
    for st in stats["cases"].values():
        staged.update(st.get("comm_per_call", {}).get("staged", ()))
    stats["staged"] = sorted(staged)
    stats["peak_gib"] = _peak_gib(device)
    out = Path(args.out)
    torch.save(results if rank == 0 or inputs.get("helpers_data")
               else {}, out / f"rank{rank}.pt")
    (out / f"rank{rank}.json").write_text(json.dumps(stats))


# ---------------------------------------------------------------------------
# the training cases
# ---------------------------------------------------------------------------

def _tree_np(tree):
    from audiodec_tpu_torch.utils.bridge import tree_map
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


def worker_train_cases(args, device: torch.device):
    """Data-parallel steps over the world on the cases of `--in` (a
    torch.save'd dict of cases, each {name, kind: "autoencoder" | "vocoder"
    | "denoise" | "rvq", the port trees, config, configs, global batches,
    step kinds, and optionally dtype: "float64" to run the case in double
    precision}) -> `--out`/rank{i}.pt: per case the state's trees after
    the steps and the records (every rank writes its own: a BN projector's
    running statistics are per rank)."""
    from audiodec_tpu_torch.models import discriminators as D
    from audiodec_tpu_torch.ops.vq import rvq_forward
    from audiodec_tpu_torch.parallel import global_mesh
    from audiodec_tpu_torch.train.criterion import build_criterion
    from audiodec_tpu_torch.train.steps import (
        make_autoencoder_steps,
        make_denoise_steps,
        make_vocoder_steps,
        shard_steps,
        train_state,
    )
    from audiodec_tpu_torch.utils.bridge import tree_map

    inputs = torch.load(args.inp, weights_only=False)
    axis = global_mesh(data=-1, device=device).axis("data")
    rank = dist.get_rank()

    def on(tree, dtype=torch.float32):
        # a copy: the cases of one file may share their trees' storage
        def leaf(t):
            t = torch.as_tensor(t)
            return t.to(device, dtype if t.is_floating_point() else None,
                        copy=True)
        return tree_map(leaf, tree)

    out = {}
    for case in inputs["cases"]:
        kind = case["kind"]
        dtype = getattr(torch, case.get("dtype", "float32"))
        torch.set_default_dtype(dtype)
        if kind == "rvq":
            z = torch.as_tensor(case["z"]).to(device)
            n = z.shape[0] // axis.size
            zq, loss, ppl, new = rvq_forward(
                z[axis.index * n:(axis.index + 1) * n], on(case["params"]),
                train=True, axis_name=axis)
            out[case["name"]] = {"zq": zq.cpu().numpy(),
                                 "loss": loss.cpu().numpy(),
                                 "ppl": ppl.cpu().numpy(),
                                 "new": _tree_np(new)}
            continue
        config = case["config"]
        crit = build_criterion(config)
        disc_apply = None
        if case.get("disc_cfg") is not None:
            disc_cfg = case["disc_cfg"]
            disc_apply = (lambda p, v, c=disc_cfg:
                          D.hifigan_discriminator_apply(p, v, c))
        gen = on(case["gen"], dtype)
        disc = (on(case["disc"], dtype) if case.get("disc") is not None
                else None)
        if kind == "autoencoder":
            state = train_state(gen, disc, config)
            steps = make_autoencoder_steps(case["gen_cfg"], disc_apply,
                                           config, crit, axis_name=axis)
        elif kind == "vocoder":
            state = train_state(gen, disc, config,
                                analyzer=on(case["analyzer"], dtype))
            steps = make_vocoder_steps(case["gen_cfg"], case["an_cfg"],
                                       disc_apply, config, crit,
                                       axis_name=axis)
        else:
            state = train_state(gen, None, config)
            steps = make_denoise_steps(case["gen_cfg"], config, crit,
                                       axis_name=axis)
        steps = shard_steps(steps, axis)
        records = []
        for step_kind, batch in zip(case["steps"], case["batches"]):
            batch = tuple(torch.as_tensor(b).to(device, dtype)
                          for b in batch)
            state, rec = steps[step_kind](state, *batch)
            records.append({k: float(v) for k, v in rec.items()})
            if not same_on_every_rank(state):
                raise AssertionError(f"{case['name']} {step_kind}: the "
                                     f"ranks' params differ")
        out[case["name"]] = {
            "records": records,
            **{k: _tree_np(state[k]) for k in ("gen", "disc")
               if k in state}}
        torch.set_default_dtype(torch.float32)
    torch.save(out, Path(args.out) / f"rank{rank}.pt")


# ---------------------------------------------------------------------------
# the command lines
# ---------------------------------------------------------------------------

def worker_cli(args, device: torch.device, cli_argvs: list):
    """The command lines of `--cli` in this rank, one after the other in one
    world, each with its arguments (`cli_argvs`, in order) and the
    rendezvous flags; codec_train's steps are checked for one global batch
    and equal params on every rank and timed.  `--out`/rank{i}.json:
    {command line: its backend, kernel launches, peak memory, collectives
    and, for codec_train, step ms; for the others, what main returned}."""
    import importlib

    from audiodec_tpu_torch.parallel.distributed import (
        comm_snapshot,
        rank_device,
        reset_comm,
    )

    if len(args.cli) != len(cli_argvs):
        raise ValueError(f"{len(args.cli)} --cli for {len(cli_argvs)} "
                         f"command lines")
    rendezvous = ["--coordinator", args.coordinator, "--num-processes",
                  str(args.num_processes), "--process-id",
                  str(args.process_id)]
    report = {}
    for cli, argv in zip(args.cli, cli_argvs):
        module = importlib.import_module(f"audiodec_tpu_torch.bin.{cli}")
        before = _launches(device)
        # the peak since the last command line (the first one's since the
        # start: its main joins the world and binds the card)
        if device.type == "cuda" and dist.is_initialized():
            torch.cuda.reset_peak_memory_stats(rank_device(device))
        reset_comm()
        if cli == "codec_train":
            trainer = module.build_trainer(argv + rendezvous)
            timings: dict = {}
            trainer.steps_fns = check_steps_in_sync(trainer.steps_fns,
                                                    timings)
            if trainer.device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(trainer.device)
            reset_comm()
            trainer.run()
            rec = {"step_ms": timings, "steps": trainer.steps,
                   "in_sync_after_every_step": True}
        else:
            result = module.main(argv + rendezvous)
            rec = {"summary": result if isinstance(result, dict) else None}
        # the next command line may read what this one's first rank wrote
        dist.barrier()
        report[cli] = {**rec, "backend": dist.get_backend(),
                       "launches": {k: v - before[k]
                                    for k, v in _launches(device).items()},
                       "peak_gib": _peak_gib(rank_device(device)),
                       "comm": comm_snapshot()}
    if args.out:
        Path(args.out, f"rank{dist.get_rank()}.json").write_text(
            json.dumps(report))


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def worker_dryrun(args, device: torch.device):
    """entry.py's dryrun_multichip, this rank's part."""
    from audiodec_tpu_torch.entry import dryrun_rank
    print(dryrun_rank(device), flush=True)


def _parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nprocs", type=int, default=4)
    p.add_argument("--seq", type=int, default=2,
                   help="the probe's seq axis (its data axis takes the "
                        "rest)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu, for every rank")
    p.add_argument("--timeout", type=float, default=600)
    p.add_argument("--worker", default="probe",
                   choices=["probe", "codec_cases", "train_cases", "cli",
                            "dryrun"])
    p.add_argument("--cli", action="append", default=[],
                   help="with --worker cli: codec_test, codec_train or "
                        "codec_stats, once per command line; the command "
                        "lines' arguments follow `--`, each after its own "
                        "`--`")
    p.add_argument("--in", dest="inp", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--threads", type=int, default=0,
                   help="torch.set_num_threads in each rank (0: torch's "
                        "default)")
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cli_argvs = []
    if "--" in argv:
        for arg in argv[argv.index("--"):]:
            if arg == "--":
                cli_argvs.append([])
            else:
                cli_argvs[-1].append(arg)
        argv = argv[:argv.index("--")]
    args = _parser().parse_args(argv)
    from audiodec_tpu_torch.bin.codec_test import require_device
    device = require_device(args.device)
    if args.process_id is None:
        outs = run_ranks(args.nprocs,
                         ["--worker", "probe", "--seq", str(args.seq),
                          "--device", device.type, "--threads",
                          str(args.threads)], timeout=args.timeout)
        for out in outs:
            sys.stdout.write(out)
        print("multihost_probe: OK", flush=True)
        return 0

    import logging
    logging.basicConfig(level=logging.INFO)
    if args.threads:
        torch.set_num_threads(args.threads)
    from audiodec_tpu_torch.parallel.distributed import init_distributed

    if args.worker == "cli":
        # the command line joins the world itself, from its flags
        worker_cli(args, device, cli_argvs)
        dist.barrier()
        dist.destroy_process_group()
        return 0
    device = init_distributed(args.coordinator, args.num_processes,
                              args.process_id, device)
    {"probe": worker_probe, "codec_cases": worker_codec_cases,
     "train_cases": worker_train_cases,
     "dryrun": worker_dryrun}[args.worker](args, device)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
