"""The rank grid: process groups for the mesh axes (port of the
``("pod", "data", "model")`` mesh of ``repro/launch/mesh.py:19-24``).

The JAX package lays its devices out on a mesh and names the axes; the
pipeline's stage dimension is sharded over ``pod``, the batch over
``data`` and each stage's tensors over ``model``.  The port's ranks form
the same grid, ``world = pp * dp * tp`` in the mesh's row-major order:
``rank = (stage * dp + replica) * tp + model_rank``, so a stage's tp ranks
sit next to each other, as on one node.  ``make_rank_grid`` makes one
``torch.distributed`` group for each model row (the tp ranks of one
replica of one stage), each pod column (the stages of one replica at one
model rank) and each data row (the replicas of one stage at one model
rank), and binds this rank's three to the axis names for
``iccl.communicator.Communicator``.  ``data`` carries the replicas'
gradient all-reduce and, under ZeRO-1, the all-gather of the parameter
slices each replica updated.  Left for ROADMAP.md queue A, item A5c (d):
stages of mixed tp widths (the ``pp_reshard`` boundary).
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
    tp: int
    rank: int

    @property
    def stage(self) -> int:
        return self.rank // (self.dp * self.tp)

    @property
    def replica(self) -> int:
        return self.rank // self.tp % self.dp

    @property
    def model_rank(self) -> int:
        return self.rank % self.tp


def _rank(grid: RankGrid, stage: int, replica: int, model_rank: int) -> int:
    return (stage * grid.dp + replica) * grid.tp + model_rank


def _axes(grid: RankGrid) -> List[Tuple[str, Tuple[int, ...]]]:
    """Every group of the grid, (axis, global ranks in axis order), in the
    order every rank makes them."""
    pp, dp, tp = grid.pp, grid.dp, grid.tp
    return ([("model", tuple(_rank(grid, s, r, i) for i in range(tp)))
             for s in range(pp) for r in range(dp)]
            + [("pod", tuple(_rank(grid, s, r, i) for s in range(pp)))
               for r in range(dp) for i in range(tp)]
            + [("data", tuple(_rank(grid, s, r, i) for r in range(dp)))
               for s in range(pp) for i in range(tp)])


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


def make_rank_grid(pp: int, dp: int, device: torch.device,
                   tp: int = 1) -> RankGrid:
    """The grid of this process group (every rank calls this at once) with
    the ``model``, ``pod`` and ``data`` axes bound; ``device`` is this
    rank's."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_rank_grid needs an initialised "
                           "torch.distributed process group")
    world = dist.get_world_size()
    if world != pp * dp * tp:
        raise ValueError(f"world size {world} is not pp {pp} x dp {dp} x "
                         f"tp {tp}")
    grid = RankGrid(pp, dp, tp, dist.get_rank())
    keys = _device_keys(device)
    nccl = "nccl" in str(dist.get_backend())
    mine = []
    for axis, ranks in _axes(grid):     # every rank makes every group
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
