"""The multi-process runtime of the port (counterpart of
audiodec_tpu/parallel/distributed.py: `init_distributed`, `global_mesh`,
`host_local_to_global`, `global_to_host_local`, `host_local_rows`,
`process_shard`), and the collectives every parallel path runs.

One process ("rank") per device.  JAX runs a mesh of devices from each
process; the port runs one device per rank under torch.distributed, so one
rank stands where JAX has one device.  A JAX process with several local
devices has no counterpart: with a world of one, a data or seq axis above
1 is refused by the command lines, which say how to start the ranks.

The backend rule, in one place (`backend_for`):
  - CPU tensors: gloo.
  - CUDA tensors: nccl when every rank of a host has a card of its own
    (LOCAL_WORLD_SIZE, else the world, <= torch.cuda.device_count()); rank
    r binds cuda:(LOCAL_RANK % device_count).
  - CUDA tensors on ranks that share a card (several ranks on the one card
    of a machine): NCCL refuses two ranks on one device, so gloo.  Gloo
    takes CUDA tensors only in the collectives of `GLOO_CUDA` (not in
    send/recv, which the halo shift uses); each other collective of a CUDA
    tensor is staged through a host tensor (copied to the host, exchanged,
    copied back).  The compute stays on the card.
The chosen backend is logged, and so is the first staging of each
collective.  A backend or collective that fails raises: nothing falls back
to the CPU.

Bootstrap: every rank calls `init_distributed` before the first collective.
With no arguments it reads torchrun's environment (MASTER_ADDR,
MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK, LOCAL_WORLD_SIZE); explicit
values (`--coordinator host:port --num-processes N --process-id I` of the
command lines) rendezvous over tcp:// with a 300 s window, JAX's.
"""

from __future__ import annotations

import collections
import logging
import os
from datetime import timedelta
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# the collectives of `Axis` that gloo runs on CUDA tensors itself, as
# measured on the card's torch (2.11.0+cu128 takes all_reduce, broadcast,
# all_gather, all_gather_into_tensor, gather and reduce_scatter, and
# refuses send/recv: PERF.md, slice 18); the halo shift (point to point)
# goes through the host
GLOO_CUDA = frozenset({"all_reduce", "broadcast", "all_gather"})
# the rendezvous window (JAX's initialization_timeout)
TIMEOUT = timedelta(seconds=300)
# dtypes gloo does not exchange, and the wider ones they travel as (exact):
# the PCM16 waveform a command line gathers
_GLOO_WIRE = {torch.int16: torch.int32}

log = logging.getLogger(__name__)


def local_rank_and_world() -> tuple:
    """(LOCAL_RANK, LOCAL_WORLD_SIZE) from the environment, else this
    rank's global rank and the world: the ranks of a world started without
    torchrun are taken to share one host."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    return (int(os.environ.get("LOCAL_RANK", rank)),
            int(os.environ.get("LOCAL_WORLD_SIZE", world)))


def backend_for(device_type: str, local_world: int) -> str:
    """The process-group backend for ranks computing on `device_type`,
    `local_world` of them on this host."""
    if device_type != "cuda":
        return "gloo"
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("no CUDA device for a cuda rank")
    return "nccl" if local_world <= cards else "gloo"


def rank_device(device=None) -> torch.device:
    """This rank's device: cpu, or cuda:(LOCAL_RANK % device_count), which
    is cuda:0 for every rank of a one-card machine."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or device.index is not None:
        return device
    local, _ = local_rank_and_world()
    return torch.device("cuda", local % max(1, torch.cuda.device_count()))


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device=None) -> torch.device:
    """Join the world of ranks and bind this rank's device -> the device.

    All-None arguments read torchrun's environment; explicit values
    rendezvous at tcp://coordinator.  `device` ("cuda" by default, or
    "cpu") picks the backend by `backend_for`.  A second call in a process
    that has joined returns its device."""
    device = torch.device("cuda" if device is None else device)
    if dist.is_initialized():
        return rank_device(device)
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num-processes and "
                             "--process-id")
        world, rank = int(num_processes), int(process_id)
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        kwargs = dict(init_method=f"tcp://{coordinator}", world_size=world,
                      rank=rank)
    else:
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                         os.environ.get("WORLD_SIZE", 1)))
        kwargs = dict(init_method="env://")
    backend = backend_for(device.type, local_world)
    dist.init_process_group(backend, timeout=TIMEOUT, **kwargs)
    bound = rank_device(device)
    if bound.type == "cuda":
        torch.cuda.set_device(bound)
    log.info("rank %d of %d: backend %s on %s%s", dist.get_rank(),
             dist.get_world_size(), backend, bound,
             "; collectives outside %s staged through the host"
             % sorted(GLOO_CUDA) if backend == "gloo"
             and bound.type == "cuda" else "")
    return bound


def world_max(value: float) -> float:
    """The largest `value` over every rank of the world (the value itself
    in a world of one); on the bound card under nccl, on the host under
    gloo."""
    if not dist.is_initialized():
        return value
    device = (rank_device("cuda") if dist.get_backend() == "nccl"
              else torch.device("cpu"))
    t = torch.tensor([value], dtype=torch.float64, device=device)
    dist.all_reduce(t, dist.ReduceOp.MAX)
    return float(t.item())


def add_parallel_flags(parser, dp_help: str):
    """--dp and the three rendezvous flags of the command lines."""
    parser.add_argument("--dp", type=int, default=1, help=dp_help)
    parser.add_argument("--coordinator", default=None,
                        help="host:port of rank 0's rendezvous; every rank "
                             "runs the same command line with its own "
                             "--process-id (torchrun's environment is read "
                             "when this is not given)")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)


def join_world(args, parser, device) -> torch.device:
    """A command line's start: join the world of ranks (--coordinator, or
    torchrun's WORLD_SIZE above 1) and bind this rank's device; refuse
    --dp (or --seq) above 1 in a world of one, saying how to start the
    ranks -> the device."""
    if args.coordinator is not None:
        device = init_distributed(args.coordinator, args.num_processes,
                                  args.process_id, device)
    elif int(os.environ.get("WORLD_SIZE", 1)) > 1:
        device = init_distributed(device=device)
    wanted = max(args.dp, getattr(args, "seq", 1))
    if wanted > 1 and world_size() == 1:
        parser.error(
            f"a mesh axis of {wanted} needs {wanted} ranks, one per device "
            f"(a process of the port drives one device): start them with "
            f"torchrun --nproc-per-node N -m <this module> ..., or run this "
            f"command N times with --coordinator HOST:PORT --num-processes "
            f"N --process-id I (bin/multihost_probe.py starts such a world "
            f"on one machine)")
    return device


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


# What the collectives of every mesh did in this rank, as the kernel
# wrappers count their launches: calls by collective, the payload bytes this
# rank sent, and the collectives staged through the host.
comm_calls: collections.Counter = collections.Counter()
comm_bytes = 0
comm_staged: set = set()


def reset_comm():
    """Set the collective counters to 0."""
    global comm_bytes
    comm_calls.clear()
    comm_bytes = 0
    comm_staged.clear()


def comm_snapshot() -> dict:
    """The collective counters since `reset_comm`."""
    return {"calls": dict(comm_calls), "bytes": comm_bytes,
            "staged": sorted(comm_staged)}


class Axis:
    """One mesh axis as this rank sees it: its size, this rank's index on
    it, the global ranks of its line and their process group (None when
    the axis has one rank), and the collectives over that line.  Every
    rank of the line calls each collective with tensors of one shape."""

    def __init__(self, name: str, size: int, index: int,
                 ranks: Sequence[int], group):
        self.name, self.size, self.index = name, size, index
        self.ranks, self.group = tuple(ranks), group

    def __repr__(self):
        return f"Axis({self.name!r}, {self.index}/{self.size})"

    def _staged(self, op: str, t: torch.Tensor) -> bool:
        """True where gloo cannot take this CUDA tensor in `op`."""
        staged = (t.is_cuda and op not in GLOO_CUDA
                  and dist.get_backend(self.group) == "gloo")
        if staged and op not in comm_staged:
            log.info("gloo on CUDA tensors: %s staged through the host",
                     op)
        if staged:
            comm_staged.add(op)
        return staged

    def _wire(self, t: torch.Tensor, staged: bool) -> torch.Tensor:
        """t as it travels: on the host where staged, in a dtype gloo
        takes, contiguous (a copy where any of that changes it)."""
        dtype = t.dtype
        if dist.get_backend(self.group) == "gloo":
            dtype = _GLOO_WIRE.get(dtype, dtype)
        return t.detach().to("cpu" if staged else t.device,
                             dtype).contiguous()

    def _count(self, op: str, t: torch.Tensor):
        global comm_bytes
        comm_calls[op] += 1
        comm_bytes += t.numel() * t.element_size()

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """A new tensor: t summed ("sum"), averaged ("mean", the sum over
        the size, JAX's pmean) or maximized ("max") over the line."""
        if self.size == 1:
            return t.clone()
        red = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
        buf = self._wire(t, self._staged("all_reduce", t)).clone()
        dist.all_reduce(buf, red, group=self.group)
        self._count("all_reduce", buf)
        out = buf.to(t.device, t.dtype)
        return out / self.size if op == "mean" else out

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The line's tensors joined along `dim` in index order."""
        if self.size == 1:
            return t
        src = self._wire(t, self._staged("all_gather", t))
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        self._count("all_gather", src)
        return torch.cat(parts, dim=dim).to(t.device, t.dtype)

    def shift(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor of the rank one index lower on the line; zeros at
        index 0 (JAX's ppermute i -> i + 1, which leaves the first shard
        nothing)."""
        if self.size == 1:
            return torch.zeros_like(t)
        send = self._wire(t, self._staged("shift", t))
        recv = torch.zeros_like(send)
        reqs = []
        if self.index + 1 < self.size:
            reqs.append(dist.isend(send, self.ranks[self.index + 1],
                                   group=self.group))
        if self.index > 0:
            reqs.append(dist.irecv(recv, self.ranks[self.index - 1],
                                   group=self.group))
        for r in reqs:
            r.wait()
        self._count("shift", send)
        return recv.to(t.device, t.dtype)


def global_mesh(data: int = -1, seq: int = 1, device=None):
    """A ('data', 'seq') mesh over every rank of the world (process-major:
    a seq line holds consecutive ranks); data=-1 takes the rest."""
    from audiodec_tpu_torch.parallel.mesh import Mesh, _mesh_shape
    return Mesh(_mesh_shape("data", data, "seq", seq, True), device)


def _spec_axes(mesh, spec) -> list:
    """[(dim, Axis)] of the dims `spec` shards, spec[d] an axis name or
    None."""
    return [(d, mesh.axis(a)) for d, a in enumerate(spec) if a is not None]


def local_block(mesh, spec, full) -> np.ndarray:
    """This rank's block of an array every rank holds whole: each dim that
    `spec` names an axis for cut into that axis's size, at this rank's
    index."""
    block = np.asarray(full)
    for d, ax in _spec_axes(mesh, spec):
        n = block.shape[d]
        if n % ax.size:
            raise ValueError(f"dim {d} of {block.shape} does not divide "
                             f"over {ax.name}={ax.size}")
        step = n // ax.size
        block = np.take(block, range(ax.index * step, (ax.index + 1) * step),
                        axis=d)
    return block


def host_local_to_global(mesh, spec, local) -> torch.Tensor:
    """This rank's part of a global array laid out by `spec`: `local` is
    its block (a rank is one JAX device, so its process-local data is its
    shard), placed on the mesh's device.  `local_block` cuts it from a
    whole array."""
    return torch.as_tensor(np.ascontiguousarray(local)).to(mesh.device)


def global_to_host_local(mesh, block: torch.Tensor, spec) -> np.ndarray:
    """The whole array on every rank of the mesh: each rank's `block`,
    gathered along every dim `spec` shards."""
    out = block
    for d, ax in reversed(_spec_axes(mesh, spec)):
        out = ax.all_gather(out, d)
    return out.cpu().numpy()


def host_local_rows(mesh, block: torch.Tensor,
                    spec=("data", "seq", None)) -> tuple:
    """(row offset, this rank's rows): the rows of this rank's data index,
    whole along every other dim (gathered over the other axes of `spec`)
    -> (offset, numpy rows).  No traffic over the data axis."""
    rows = block
    for d, ax in reversed(_spec_axes(mesh, spec)):
        if d != 0:
            rows = ax.all_gather(rows, d)
    lo = 0
    if spec[0] is not None:
        lo = mesh.axis(spec[0]).index * block.shape[0]
    return lo, rows.cpu().numpy()


def process_shard(items: Sequence, pid: Optional[int] = None,
                  nprocs: Optional[int] = None) -> list:
    """Strided split of a work list over the ranks (file-level work each
    rank does on its own)."""
    pid = process_index() if pid is None else pid
    nprocs = world_size() if nprocs is None else nprocs
    return list(items[pid::nprocs])
