"""Live redistribution of a train state between two rank plans (the rank
route's counterpart of the JAX trainer's in-memory migration,
``repro/train/trainer.py:1136-1146``).

The JAX trainer reshards a replan's state by ``ckpt.migrate`` of the
host copy and a ``device_put`` under the new shardings.  On the port's
ranks no process holds the whole state, so ``redistribute`` moves it
element by element: ``pipeline.rank_leaf_slices`` maps every rank's
leaves of the old plan into the whole state, with one writer an element
(the rank that would write it to a checkpoint), and every rank's leaves
of the new plan likewise.  For each leaf, in one fixed order on every
rank, each element goes from its old writer to every new rank that holds
it: a rank sends the boxes it writes to each peer as one message, receives
the boxes it needs from each peer as one message, and copies those it
keeps.  The two plans may run on different ranks of the process group
(elastic membership): a rank that leaves sends what it writes and ends
with nothing, a rank that comes back starts from nothing.  The ring ranks
of a cp plan's data group hold one state, which ring rank 0 writes: a move
from a cp plan sends from there, one to a cp plan copies to every ring
rank.  The stage chunks under vpp, the tp slice and the ZeRO-1 slices of
``m``, ``v`` and the master come out of the slices; ``step`` and the
AdamW count go from rank 0 to every rank.  Nothing is gathered: a rank
holds, beside its new leaf, only the leaf it still has to send from.

The messages go point to point over the whole process group, posted a
leaf at a time in one ``dist.batch_isend_irecv``: host-staged through
pinned memory on transport ``"cpu"`` (as ``Communicator._isend_irecv_batch``
stages), over NCCL on the cards' own transports, over gloo for CPU
tensors.  gloo has ``all_to_all_single`` (the ``Communicator``'s
``ialltoall`` runs on it), but a leaf's messages involve only the ranks
whose boxes meet, so the move posts point-to-point messages and no rank
takes part in an exchange it has no box in.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.plan import ParallelPlan
from repro_torch.parallel import groups
from repro_torch.parallel.pipeline import LeafSlices, rank_leaf_slices
from repro_torch.parallel.sharding import ShardingRules, map_with_path

Box = Tuple[slice, ...]
Path = Tuple[str, ...]


def rank_coords(plan: ParallelPlan, rank: int) -> Tuple[int, int, int]:
    """(stage, replica, model rank) of ``rank`` in the rank order of
    ``groups.RankGrid``: ``(stage * dp + replica) * tp + model_rank``; at
    cp > 1 ``(ring * dp / cp + group) * tp + model_rank``, whose replica
    is the data group (``ring_of`` gives the ring rank)."""
    groups_, tp = plan.dps[0] // plan.cp, plan.tps[0]
    return rank // (plan.dps[0] * tp), rank // tp % groups_, rank % tp


def ring_of(plan: ParallelPlan, rank: int) -> int:
    """The cp ring rank of ``rank`` (0 at cp 1)."""
    return rank // (plan.dps[0] // plan.cp * plan.tps[0]) % plan.cp


def plan_slices(whole: Dict[str, Any], plan: ParallelPlan, rules,
                rank: int) -> Dict[str, Any]:
    """``rank_leaf_slices`` of ``rank`` under ``plan``: at cp > 1 the ring
    ranks of a group hold the same elements, which ring rank 0 writes, so
    a move from a cp plan sends them from there and one to a cp plan
    gives every ring rank a copy."""
    stage, replica, model_rank = rank_coords(plan, rank)
    return rank_leaf_slices(whole, plan, stage, rules, model_rank,
                            replica=replica, ring=ring_of(plan, rank))


def _flat(tree: Any) -> Dict[Path, Any]:
    out: Dict[Path, Any] = {}
    map_with_path(lambda path, x: out.__setitem__(path, x), tree)
    return out


def _meet(a: Box, b: Box) -> Optional[Box]:
    """The intersection of two boxes of the whole leaf, or None."""
    out = []
    for x, y in zip(a, b):
        lo, hi = max(x.start, y.start), min(x.stop, y.stop)
        if lo >= hi:
            return None
        out.append(slice(lo, hi))
    return tuple(out)


def _local(local: Box, whole: Box, box: Box) -> Box:
    """``box`` (whole coordinates, inside ``whole``) in the coordinates of
    the rank's leaf, where ``whole`` sits at ``local``."""
    return tuple(slice(lo.start + b.start - w.start,
                       lo.start + b.stop - w.start)
                 for lo, w, b in zip(local, whole, box))


def _numel(box: Box) -> int:
    n = 1
    for s in box:
        n *= s.stop - s.start
    return n


def _plan_moves(old: Sequence[LeafSlices], new: Sequence[LeafSlices]
                ) -> List[Tuple[int, int, Box, Box, Box]]:
    """Every (old writer, new holder, box in the writer's leaf, box in the
    holder's leaf, box in the whole leaf) of one leaf, in one order on
    every rank; ``old`` / ``new``: each rank's slices (None: not held)."""
    moves = []
    for o, so in enumerate(old):
        if so is None or not so.writer:
            continue
        for ol, ow in so.pieces:
            for n, sn in enumerate(new):
                if sn is None:
                    continue
                for nl, nw in sn.pieces:
                    box = _meet(ow, nw)
                    if box is not None:
                        moves.append((o, n, _local(ol, ow, box),
                                      _local(nl, nw, box), box))
    return moves


def redistribute(state: Dict[str, Any], whole: Dict[str, Any],
                 old_plan: ParallelPlan, new_plan: ParallelPlan,
                 cfg, device: torch.device, transport: str,
                 old_ranks: Optional[Sequence[int]] = None,
                 new_ranks: Optional[Sequence[int]] = None
                 ) -> Tuple[Optional[Dict[str, Any]], Dict[str, Any]]:
    """This rank's state under ``new_plan`` from every rank's state under
    ``old_plan`` (every rank of the process group calls it at once, with
    the same plans and rank lists; ``whole``: the whole state's shapes and
    dtypes, a ``meta`` tree).  ``old_ranks`` / ``new_ranks``: the process
    group's ranks each plan runs on, in its rank order (default: the
    whole group); a rank outside ``old_ranks`` passes an empty state, and
    one outside ``new_ranks`` gets None.  ``state`` is consumed: each old
    leaf is dropped once its boxes are sent.  Returns (the new state on
    ``device``, stats: ``sent_bytes``, ``recv_bytes``, ``kept_bytes``,
    ``seconds`` and ``moved``, the ``(path, box in the new leaf, box in
    the whole leaf)`` of every box this rank received)."""
    world, me = dist.get_world_size(), dist.get_rank()
    old_ranks = list(range(world)) if old_ranks is None else list(old_ranks)
    new_ranks = list(range(world)) if new_ranks is None else list(new_ranks)
    for p, ranks in ((old_plan, old_ranks), (new_plan, new_ranks)):
        if p.pp * p.dps[0] * p.tps[0] != len(ranks):
            raise ValueError(f"plan {p.describe()} holds "
                             f"{p.pp * p.dps[0] * p.tps[0]} ranks, not the "
                             f"{len(ranks)} it runs on ({ranks})")
    device = torch.device(device)
    staged = device.type == "cuda" and transport == "cpu"
    if device.type == "cuda" and not staged:
        keys = groups._device_keys(device)
        if len(set(keys)) != world or "nccl" not in str(dist.get_backend()):
            raise ValueError(f"transport {transport!r} moves CUDA tensors "
                             "over NCCL, which needs a card a rank and an "
                             "NCCL backend; use transport='cpu'")
        # NCCL wants a group's first call made by all its ranks, and a
        # leaf's messages may leave some out
        dist.all_reduce(torch.zeros(1, device=device))
    rules = [ShardingRules(cfg, tp=p.tps[0]) for p in (old_plan, new_plan)]
    old: List[Dict[Path, Any]] = [{} for _ in range(world)]
    for i, r in enumerate(old_ranks):
        old[r] = _flat(plan_slices(whole, old_plan, rules[0], i))
    new: List[Dict[Path, Any]] = [{} for _ in range(world)]
    new_tree = None
    for i, r in enumerate(new_ranks):
        tree = plan_slices(whole, new_plan, rules[1], i)
        if r == me:
            new_tree = tree
        new[r] = _flat(tree)
    mine = _flat(state)
    _clear(state)
    shapes = _flat(whole)
    out: Dict[Path, torch.Tensor] = {}
    stats: Dict[str, Any] = {"sent_bytes": 0, "recv_bytes": 0,
                             "kept_bytes": 0, "moved": []}
    t0 = time.perf_counter()
    for path, meta in shapes.items():
        moves = _plan_moves([o.get(path) for o in old],
                            [n.get(path) for n in new])
        src = mine.pop(path, None)
        dst = None
        if path in new[me]:
            dst = torch.empty(new[me][path].shape, dtype=meta.dtype,
                              device=device)
        sends: Dict[int, List[torch.Tensor]] = {}
        recvs: Dict[int, List[Tuple[Box, Box]]] = {}
        for o, n, sbox, dbox, box in moves:
            if o == me and n == me:
                dst[dbox].copy_(src[sbox])
                stats["kept_bytes"] += _numel(box) * dst.element_size()
            elif o == me:
                sends.setdefault(n, []).append(src[sbox])
            elif n == me:
                recvs.setdefault(o, []).append((dbox, box))
        _exchange(sends, recvs, dst, meta.dtype, device, staged, stats,
                  path)
        del src
        if dst is not None:
            out[path] = dst
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stats["seconds"] = time.perf_counter() - t0
    if new_tree is None:
        return None, stats
    return map_with_path(lambda path, _: out[path], new_tree), stats


def _clear(tree: Any) -> None:
    """Empty every dict of ``tree``, so that its caller no longer holds
    the leaves."""
    if isinstance(tree, dict):
        for v in tree.values():
            _clear(v)
        tree.clear()


def _exchange(sends: Dict[int, List[torch.Tensor]],
              recvs: Dict[int, List[Tuple[Box, Box]]],
              dst: Optional[torch.Tensor], dtype: torch.dtype,
              device: torch.device, staged: bool, stats: Dict[str, Any],
              path: Path) -> None:
    """One leaf's messages: to each peer its boxes flattened into one
    buffer, from each peer one buffer split into its boxes."""
    ops, bufs, pinned = [], [], staged
    for peer in sorted(sends):
        buf = torch.cat([x.reshape(-1) for x in sends[peer]])
        if pinned:
            host = torch.empty(buf.shape, dtype=dtype, pin_memory=True)
            host.copy_(buf, non_blocking=True)
            buf = host
        stats["sent_bytes"] += buf.numel() * buf.element_size()
        ops.append(dist.P2POp(dist.isend, buf, peer))
    for peer in sorted(recvs):
        n = sum(_numel(box) for _, box in recvs[peer])
        buf = (torch.empty((n,), dtype=dtype, pin_memory=True) if pinned
               else torch.empty((n,), dtype=dtype, device=device))
        bufs.append((peer, buf))
        ops.append(dist.P2POp(dist.irecv, buf, peer))
    if not ops:
        return
    if pinned and sends:    # gloo reads the host buffers at once
        torch.cuda.current_stream(device).synchronize()
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    for peer, buf in bufs:
        stats["recv_bytes"] += buf.numel() * buf.element_size()
        at = 0
        for dbox, box in recvs[peer]:
            k = _numel(box)
            dst[dbox].copy_(buf[at:at + k].view(dst[dbox].shape),
                            non_blocking=pinned)
            stats["moved"].append((path, dbox, box))
            at += k
