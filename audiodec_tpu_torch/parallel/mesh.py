"""Meshes of ranks (counterpart of audiodec_tpu/parallel/mesh.py
`make_mesh`; the ('data', 'model') mesh of parallel/tp.py uses the same
class).

JAX lays a mesh over the devices of its processes; the port runs one
process ("rank") per device under torch.distributed, so a mesh axis is a
set of ranks.  Ranks are laid out process-major, as
audiodec_tpu/parallel/distributed.py `global_mesh` lays out devices:
rank = data_index * seq + seq_index for a ('data', 'seq') mesh.  Along each
axis, the ranks that differ only in that axis's index form one line; every
line gets its own process group, built once, by every rank, in one order
(`dist.new_group` is collective over the world).

A mesh may use fewer ranks than the world, as JAX's `make_mesh` may use
fewer devices: the first prod(shape) ranks; a rank outside it has
`member` False and runs none of the mesh's collectives.  In a world of
one (no process group) every axis has size 1 and its collectives are the
identity.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.distributed as dist

from audiodec_tpu_torch.parallel.distributed import Axis


class Mesh:
    """A mesh of ranks with named axes, this rank's place in it, and one
    `Axis` (group and collectives) per axis name."""

    def __init__(self, shape: Dict[str, int], device=None):
        world = dist.get_world_size() if dist.is_initialized() else 1
        rank = dist.get_rank() if dist.is_initialized() else 0
        names = tuple(shape)
        sizes = tuple(int(shape[a]) for a in names)
        n = math.prod(sizes)
        if n > world:
            raise ValueError(f"mesh {dict(shape)} needs {n} ranks, the "
                             f"world has {world}")
        self.shape = dict(zip(names, sizes))
        self.axis_names = names
        self.size = n
        self.rank = rank
        self.member = rank < n
        self.device = torch.device("cpu" if device is None else device)
        coords = _unravel(rank if self.member else 0, sizes)
        self.coords = dict(zip(names, coords))
        self._axes = {}
        for k, name in enumerate(names):
            lines = _lines(sizes, k)
            mine = None
            for line in lines:
                # every rank creates every group, in one order
                group = (dist.new_group(list(line))
                         if world > 1 and sizes[k] > 1 else None)
                if self.member and rank in line:
                    mine = (line, group)
            line, group = mine if mine is not None else ((rank,), None)
            self._axes[name] = Axis(name, sizes[k], coords[k], tuple(line),
                                    group)

    def axis(self, name: str) -> Axis:
        return self._axes[name]

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}, coords={self.coords},"
                f" device={self.device})")


def _unravel(index: int, sizes: Sequence[int]) -> tuple:
    out = []
    for s in reversed(sizes):
        out.append(index % s)
        index //= s
    return tuple(reversed(out))


def _lines(sizes: Sequence[int], k: int) -> list:
    """The rank lines along axis k: for every index of the other axes, the
    ranks that differ only in axis k (row-major layout)."""
    stride = math.prod(sizes[k + 1:])
    n = math.prod(sizes)
    starts = [r for r in range(n) if (r // stride) % sizes[k] == 0]
    return [tuple(s + i * stride for i in range(sizes[k])) for s in starts]


def _mesh_shape(first: str, data: int, other: str, size: int,
                exact: bool) -> Dict[str, int]:
    """{first: data, other: size} over the world's ranks (data -1: the
    rest); `exact`: the mesh must use every rank."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data == -1:
        if world % size:
            raise ValueError(f"{world} ranks not divisible by "
                             f"{other}={size}")
        data = world // size
    if exact and data * size != world:
        raise ValueError(f"a multi-process mesh must use every rank: "
                         f"{data}x{size} != {world}")
    if data * size > world:
        raise ValueError(f"mesh {data}x{size} > {world} ranks")
    return {first: data, other: size}


def make_mesh(data: int = -1, seq: int = 1, device=None) -> Mesh:
    """A ('data', 'seq') mesh over the first data * seq ranks; data=-1
    takes the rest of the world."""
    return Mesh(_mesh_shape("data", data, "seq", seq, False), device)
