"""The rank grid: process groups for the mesh axes (port of the
``("pod", "data", "model")`` mesh of ``repro/launch/mesh.py:19-24``).

The JAX package lays its devices out on a mesh and names the axes; the
pipeline's stage dimension is sharded over ``pod`` and the batch over
``data``.  The port's ranks form the same grid, ``world = pp * dp`` in
row-major ``(pod, data)`` order: rank ``r`` is stage ``r // dp`` and
replica ``r % dp``.  ``model`` is 1: tensor parallelism within a stage is
ROADMAP.md queue A, item A5c.  ``make_rank_grid`` makes one
``torch.distributed`` group for each pod column (the stages of one
replica) and each data row (the replicas of one stage), and binds this
rank's two to the axis names for ``iccl.communicator.Communicator``.
"""
from __future__ import annotations

import dataclasses
import socket
from typing import List, Tuple

import torch
import torch.distributed as dist

from repro_torch.iccl.communicator import bind_axis

@dataclasses.dataclass(frozen=True)
class RankGrid:
    pp: int
    dp: int
    rank: int

    @property
    def stage(self) -> int:
        return self.rank // self.dp

    @property
    def replica(self) -> int:
        return self.rank % self.dp


def _pod_ranks(pp: int, dp: int, replica: int) -> Tuple[int, ...]:
    """The stages of one replica, in stage order."""
    return tuple(s * dp + replica for s in range(pp))


def _data_ranks(dp: int, stage: int) -> Tuple[int, ...]:
    """The replicas of one stage."""
    return tuple(stage * dp + r for r in range(dp))


def device_key(device: torch.device) -> str:
    """``host/device``: two ranks with one key drive one card."""
    return f"{socket.gethostname()}/{torch.device(device)}"


def _device_keys(device: torch.device) -> List[str]:
    keys: List[str] = [""] * dist.get_world_size()
    dist.all_gather_object(keys, device_key(device))
    return keys


def bind_world_axis(axis: str, device: torch.device) -> None:
    """Bind the whole process group (every rank calls this at once) to
    ``axis``: the one-axis mesh over every device that the profile runner
    measures collectives on."""
    keys = _device_keys(device)
    bind_axis(axis, dist.group.WORLD, range(len(keys)), keys,
              "nccl" in str(dist.get_backend()))


def make_rank_grid(pp: int, dp: int, device: torch.device) -> RankGrid:
    """The grid of this process group (every rank calls this at once) with
    the ``pod`` and ``data`` axes bound; ``device`` is this rank's."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_rank_grid needs an initialised "
                           "torch.distributed process group")
    world = dist.get_world_size()
    if world != pp * dp:
        raise ValueError(f"world size {world} is not pp {pp} x dp {dp}")
    grid = RankGrid(pp, dp, dist.get_rank())
    keys = _device_keys(device)
    nccl = "nccl" in str(dist.get_backend())
    mine = []
    # every rank makes every group, in the same order
    for axis, ranks in ([("pod", _pod_ranks(pp, dp, r)) for r in range(dp)]
                        + [("data", _data_ranks(dp, s)) for s in range(pp)]):
        group = dist.new_group(list(ranks))
        if grid.rank in ranks:
            bind_axis(axis, group, ranks, [keys[r] for r in ranks], nccl)
            mine.append(group)
    if nccl and torch.device(device).type == "cuda" and \
            len(set(keys)) == world:
        # NCCL wants a group's first call made by all its ranks, and a
        # pipeline's first hop is made by two
        for group in mine:
            dist.all_reduce(torch.zeros(1, device=device), group=group)
    return grid
