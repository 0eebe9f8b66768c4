"""The rank grid: process groups for the mesh axes (port of the
``("pod", "data", "model")`` mesh of ``repro/launch/mesh.py:19-24``).

The JAX package lays its devices out on a mesh and names the axes; the
pipeline's stage dimension is sharded over ``pod``, the batch over
``data`` and each stage's tensors over ``model``.  The port's ranks form
the same grid, ``world = pp * cp * dp * tp`` in the mesh's row-major
order: ``rank = ((stage * cp + ring) * dp + replica) * tp + model_rank``,
so a stage's tp ranks sit next to each other, as on one node.  A cp > 1
plan (pp 1 only) lays its ring ranks on the axis bound as ``pod``, which a
pp 1 plan leaves free, as the JAX package lays the ring on the mesh's
``pod`` axis (``repro/parallel/context.py``): ``rank = (ring * dp +
group) * tp + model_rank``, where ``dp`` counts the plan's data groups
(``ParallelPlan.dp / cp``) and ``replica`` names this rank's group.  At
cp 1 the order is the one above, so every grid, checkpoint and test of a
cp 1 plan is unchanged.  ``make_rank_grid`` makes one
``torch.distributed`` group for each model row (the tp ranks of one
replica of one stage), each pod column (the stages, or at cp > 1 the ring
ranks, of one replica at one model rank) and each data row (the replicas
of one stage and ring rank at one model rank), and binds this rank's
three to the axis names for ``iccl.communicator.Communicator``;
``destroy_rank_grid`` releases them when a replan builds another grid.
``data`` carries the replicas' gradient all-reduce and, under ZeRO-1,
the all-gather of the parameter slices each replica updated.  A grid
may hold only some ranks of the process group (``ranks``, the trainer's
elastic membership): its rank order is then over that list, every
process still makes every group in one order, and a process outside the
list gets no grid.  Left for ROADMAP.md queue A, item A5c (d):
stages of mixed tp widths (the ``pp_reshard`` boundary).
"""
from __future__ import annotations

import dataclasses
import socket
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.iccl.communicator import bind_axis


@dataclasses.dataclass(frozen=True)
class RankGrid:
    pp: int
    dp: int                 # the data axis: replicas (cp > 1: data groups)
    tp: int
    rank: int               # in the grid's rank order
    # the process group's rank of each grid rank (default: the world)
    ranks: Tuple[int, ...] = dataclasses.field(default=(), compare=False)
    # this rank's groups, which ``destroy_rank_grid`` releases
    groups: Tuple[dist.ProcessGroup, ...] = dataclasses.field(
        default=(), compare=False, repr=False)
    cp: int = 1             # ring ranks on ``pod`` (pp 1 only)

    @property
    def stage(self) -> int:
        return self.rank // (self.cp * self.dp * self.tp)

    @property
    def ring(self) -> int:
        """This rank's place on the cp ring (0 at cp 1)."""
        return self.rank // (self.dp * self.tp) % self.cp

    @property
    def replica(self) -> int:
        return self.rank // self.tp % self.dp

    @property
    def model_rank(self) -> int:
        return self.rank % self.tp


def _rank(grid: RankGrid, stage: int, replica: int, model_rank: int,
          ring: int = 0) -> int:
    return (((stage * grid.cp + ring) * grid.dp + replica) * grid.tp
            + model_rank)


def _axes(grid: RankGrid) -> List[Tuple[str, Tuple[int, ...]]]:
    """Every group of the grid, (axis, global ranks in axis order), in the
    order every rank makes them.  ``pod`` runs over the stages, or at
    cp > 1 (one stage) over the ring."""
    dp, tp = grid.dp, grid.tp
    pods = [(s, c) for s in range(grid.pp) for c in range(grid.cp)]
    return ([("model", tuple(_rank(grid, s, r, i, c) for i in range(tp)))
             for s, c in pods for r in range(dp)]
            + [("pod", tuple(_rank(grid, s, r, i, c) for s, c in pods))
               for r in range(dp) for i in range(tp)]
            + [("data", tuple(_rank(grid, s, r, i, c) for r in range(dp)))
               for s, c in pods for i in range(tp)])


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
                   tp: int = 1, ranks: Optional[Sequence[int]] = None,
                   cp: int = 1) -> Optional[RankGrid]:
    """The grid of ``ranks`` (default: the whole process group; every
    process calls this at once, with the same list) with the ``model``,
    ``pod`` and ``data`` axes bound; ``device`` is this rank's; ``dp``
    the data axis's width (at cp > 1 the data groups).  None on a
    process outside ``ranks``."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_rank_grid needs an initialised "
                           "torch.distributed process group")
    if cp > 1 and pp > 1:
        raise ValueError(f"cp={cp} at pp={pp}: the ring and the stages "
                         "would share the pod axis (ROADMAP.md queue A, "
                         "item A8b)")
    world = dist.get_world_size()
    ranks = tuple(range(world)) if ranks is None else tuple(ranks)
    if len(ranks) != pp * cp * dp * tp:
        raise ValueError(f"{len(ranks)} ranks are not pp {pp} x cp {cp} x "
                         f"dp {dp} x tp {tp}" if cp > 1 else
                         f"{len(ranks)} ranks are not pp {pp} x dp {dp} x "
                         f"tp {tp}")
    me = dist.get_rank()
    grid = RankGrid(pp, dp, tp, ranks.index(me) if me in ranks else -1,
                    ranks, cp=cp)
    keys = _device_keys(device)
    nccl = "nccl" in str(dist.get_backend())
    mine = []
    pod = None
    for axis, local in _axes(grid):     # every rank makes every group
        members = [ranks[r] for r in local]
        group = dist.new_group(members)
        if me in members:
            bind_axis(axis, group, members, [keys[r] for r in members],
                      nccl)
            mine.append(group)
            if axis == "pod":
                pod = (group, members)
    if me not in ranks:
        return None
    if nccl and torch.device(device).type == "cuda" and \
            len(set(keys[r] for r in ranks)) == len(ranks):
        # NCCL wants a group's first call made by all its ranks, and a
        # pipeline's first hop is made by two
        for group in mine:
            dist.all_reduce(torch.zeros(1, device=device), group=group)
        _connect_stages(*pod, device)
    return dataclasses.replace(grid, groups=tuple(mine))


def _connect_stages(group: dist.ProcessGroup, members: Sequence[int],
                    device: torch.device) -> None:
    """Connect this rank with its neighbours on the ``pod`` ring (the
    stages before and after it, the last stage's next being the first, as
    interleaving sends; at cp > 1 the cp ring's neighbours, which its KV
    hops join) both ways now, one send to and one receive from
    each posted at once.  Without it the CLI's 8-layer ``gpipe`` plan at
    pp 2 x dp 2 hung over NCCL at the pivot: stage 0's ranks waited in
    ``batch_isend_irecv`` of the batch that posts its last activation's
    send with its first gradient's receive, the first message stage 0
    takes from stage 1, and stage 1's ranks waited on the card inside the
    backward engine (which of that backward's calls waits is not known).
    NCCL connects a pair's direction on its first message; with the
    stages' pairs connected before the first step, the plan finishes."""
    if len(members) < 2:
        return
    i = members.index(dist.get_rank())
    peers = {members[(i + 1) % len(members)], members[i - 1]}
    ops = []
    for peer in sorted(peers):
        ops.append(dist.P2POp(dist.isend, torch.zeros(1, device=device),
                              peer, group))
        ops.append(dist.P2POp(dist.irecv, torch.zeros(1, device=device),
                              peer, group))
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    torch.cuda.synchronize(device)


def destroy_rank_grid(grid: RankGrid) -> None:
    """Release the groups of ``grid`` (every rank calls this at once), its
    NCCL communicators and their buffers included, before a new grid is
    made."""
    for group in grid.groups:
        dist.destroy_process_group(group)
