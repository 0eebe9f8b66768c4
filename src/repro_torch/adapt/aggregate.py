"""Multi-host telemetry aggregation: one profile view per cluster, not per
process.

``StageTelemetry`` attributes ticks for a single process — on a real
multi-pod deployment each process folds its OWN pod's stages, under its
own island's device kind, into its own local ``ProfileStore``.  Before the
adaptation policy evaluates (and before a replan searches), those
per-process folds must be gathered into one per-island profile, or the
policy would be reasoning about a 1/N view of the cluster.

The aggregation is a pure fold-merge (``ProfileStore.merge``): running
means with observation counts compose exactly, so gathering full stores
and merging from scratch each time is idempotent — no delta tracking, no
double counting.  Three aggregators, one protocol:

  * ``LocalAggregator`` — single-process runs: the local store IS the
    cluster view (identity; the default on one process);
  * ``InMemoryFanIn`` — CPU test meshes and unit tests: per-"process"
    stores registered explicitly, gathered by direct merge (what a real
    deployment does over the network, minus the network);
  * ``ProcessAllGatherAggregator`` — processes of a ``torch.distributed``
    process group: observed-telemetry entries are JSON-serialized and
    exchanged with an all-gather over a gloo group of the whole world
    (length-padded uint8 payloads, the lengths first, since an all-gather
    wants equal shapes), then merged.

Aggregators also carry the DECISION side of the multi-host protocol:
``is_leader()`` names the one process whose policy evaluates, and
``broadcast(obj)`` ships the leader's adaptation directive to every
process — so the collective plan adoption (checkpoint, jit-step rebuild,
live migration) is entered by ALL processes together or by none, never
gated on per-process policy state.  ``collective`` marks aggregators
whose gather/broadcast are real collectives: the Trainer calls those
only at a step-synchronized cadence.

LEADER RE-ELECTION (elastic membership): leadership is not pinned to
process 0 — it is the LOWEST SURVIVING RANK.  When the leader's node
leaves the cluster, ``lose_rank`` removes it from the surviving set and
``leader_rank()``/``is_leader()`` deterministically re-elect on every
process without any election traffic (each process computes the same
minimum from the same membership facts); ``broadcast`` then originates
from the new leader.  ``rejoin_rank`` restores a rank.  The rank-loss
facts come from outside the protocol (the cluster scheduler, the launch
harness, a test's ``MembershipView``) — on a real mesh a hard-dead
process stalls the collectives themselves, so ``lose_rank`` models the
decision protocol AFTER the runtime's surviving processes have reformed
(or, in the simulated harnesses, immediately).

``default_aggregator()`` picks by ``torch.distributed``'s world size —
the launch layer wires it through, so a run of several ranks needs no
extra flags.

A copy of ``repro/adapt/aggregate.py`` but for the all-gather, which the
JAX package runs through ``multihost_utils.process_allgather`` over its
processes: the wire format (``_encode`` / ``_merge_payloads``, the padded
payloads, gather-then-select for ``broadcast``) is JAX's byte for byte.
"""
from __future__ import annotations

import json
from typing import List, Optional, Sequence

from repro_torch.profile.store import Entry, ProfileStore

# the entry kinds that are per-process observations and therefore worth
# shipping between processes (static calibration kinds — layer_cost,
# link, ... — are host-local measurements every process already has or
# can serve from its own fallback)
OBSERVED_OPS = ("observed_stage_tick", "observed_bubble",
                "observed_step", "observed_layer_step")


def merge_stores(stores: Sequence[ProfileStore],
                 ops: Optional[Sequence[str]] = None) -> ProfileStore:
    """Fold-merge ``stores`` into one fresh store (n-weighted running
    means compose exactly; see ``ProfileStore.merge``)."""
    merged = ProfileStore()
    for s in stores:
        merged.merge(s, ops=list(ops) if ops is not None else None)
    return merged


class _LocalDecisionProtocol:
    """Decision-protocol identity shared by the single-Python-process
    aggregators: this process leads and ``broadcast`` is a no-op."""

    collective = False

    def is_leader(self) -> bool:
        return True

    def broadcast(self, obj):
        return obj


class LocalAggregator(_LocalDecisionProtocol):
    """Single-process identity: the local store already sees everything."""

    def gather(self, local: ProfileStore) -> ProfileStore:
        return local


class InMemoryFanIn(_LocalDecisionProtocol):
    """In-memory fan-in for CPU test meshes: every simulated process
    registers its local store; ``gather`` merges them all (the local store
    included) into one fresh cluster view.  Runs inside ONE Python
    process (the simulated peers never execute concurrently), hence the
    local decision protocol."""

    def __init__(self, stores: Optional[Sequence[ProfileStore]] = None):
        self.stores: List[ProfileStore] = list(stores or [])

    def register(self, store: ProfileStore) -> None:
        self.stores.append(store)

    def gather(self, local: ProfileStore) -> ProfileStore:
        peers = [s for s in self.stores if s is not local]
        return merge_stores([local] + peers)


class MembershipView:
    """Shared membership ledger for SIMULATED multi-process runs (CPU
    test meshes): the alive-rank set every simulated process's
    ``ElectingFanIn`` reads, plus the broadcast log the surviving leader
    writes directives into.  One instance is shared by all simulated
    peers — losing a rank flips every peer's ``is_leader()`` answer at
    once, exactly like the deterministic rule on a real mesh."""

    def __init__(self, n_ranks: int):
        if n_ranks < 1:
            raise ValueError(f"need >= 1 rank, got {n_ranks}")
        self.n_ranks = n_ranks
        self.alive = set(range(n_ranks))
        self.log: list = []        # every directive broadcast (None incl.)

    def lose(self, rank: int) -> None:
        if rank not in self.alive:
            raise ValueError(f"rank {rank} is not alive ({self.alive})")
        if len(self.alive) == 1:
            raise ValueError("cannot lose the last surviving rank")
        self.alive.discard(rank)

    def rejoin(self, rank: int) -> None:
        if not 0 <= rank < self.n_ranks:
            raise ValueError(f"rank {rank} out of range 0..{self.n_ranks-1}")
        self.alive.add(rank)

    def leader(self) -> int:
        """Deterministic election: the lowest surviving rank leads."""
        return min(self.alive)


class ElectingFanIn(InMemoryFanIn):
    """Rank-aware ``InMemoryFanIn``: the decision protocol of a simulated
    multi-process mesh WITH leader re-election.  Each simulated process
    holds one instance (its rank + local stores) over a shared
    ``MembershipView``; ``is_leader()`` answers by the
    lowest-surviving-rank rule, so killing the leader's rank re-elects
    instantly and deterministically on every survivor.

    ``broadcast`` mirrors the wire protocol minus the wire: the current
    leader appends its directive (None included — every cadence point
    broadcasts) to the shared log and followers replay it in order, JSON
    round-tripped exactly as ``ProcessAllGatherAggregator`` would deliver
    it.  A follower whose cursor has caught up to the log (its leader is
    dead or behind) reads None and does not advance — when this process
    is later elected, it starts writing instead.  ``collective`` is True:
    a real deployment's equivalent runs collectives, so the Trainer must
    drive this one from its step-synchronized cadence too."""

    collective = True

    def __init__(self, view: MembershipView, rank: int, stores=None):
        super().__init__(stores)
        if not 0 <= rank < view.n_ranks:
            raise ValueError(f"rank {rank} out of range "
                             f"0..{view.n_ranks - 1}")
        self.view = view
        self.rank = rank
        self._cursor = 0              # next view.log slot this rank reads

    def is_leader(self) -> bool:
        return self.rank == self.view.leader()

    def lose_rank(self, rank: int) -> None:
        self.view.lose(rank)

    def rejoin_rank(self, rank: int) -> None:
        self.view.rejoin(rank)

    def leader_rank(self) -> int:
        return self.view.leader()

    def broadcast(self, obj):
        if self.is_leader():
            wired = None if obj is None else json.loads(json.dumps(obj))
            self.view.log.append(wired)
            self._cursor = len(self.view.log)
            return wired
        assert obj is None, "a follower never originates a directive"
        if self._cursor < len(self.view.log):
            out = self.view.log[self._cursor]
            self._cursor += 1
            return out
        return None                   # leader dead/behind: nothing sent


class ProcessAllGatherAggregator:
    """Ranks of a ``torch.distributed`` process group: all-gather each
    process's observed telemetry entries and merge them into a fresh
    cluster view.

    The local store's full contents (calibration entries included) seed
    the view; only ``OBSERVED_OPS`` entries cross the wire.  Payloads are
    JSON -> uint8 tensors padded to the gathered max length (an
    all-gather needs equal shapes across processes).  Every exchange runs
    over one gloo group of the whole world, made once (every rank makes
    the aggregator at the same point, right after the process group), on
    the host: a cadence collective never enters the order of the cards'
    NCCL communicators.

    Decision side: the LOWEST SURVIVING RANK leads (rank 0 until
    ``lose_rank`` says otherwise), and ``broadcast`` ships its directive
    as a length-padded JSON payload selected out of an all-gather —
    gather-then-select rather than a broadcast from a fixed root, so a
    re-elected leader can originate.  Both are COLLECTIVES and must be
    entered by every process at the same step (the Trainer calls them
    only from its step-synchronized cadence point).  ``lose_rank`` facts
    must arrive identically on every process (they come from the same
    membership directive / scheduler signal), so each computes the same
    leader with no election traffic.  A rank that left the run's plan
    stays a process of the group and enters every exchange."""

    collective = True

    def __init__(self, ops: Sequence[str] = OBSERVED_OPS):
        self.ops = tuple(ops)
        self._lost: set = set()
        self._group = None
        if _world() > 1:
            import torch.distributed as dist
            self._group = dist.new_group(backend="gloo")

    # ----------------------------------------------- leader (re-)election --
    def lose_rank(self, rank: int) -> None:
        """Mark ``rank``'s process as gone; every process applying the
        same fact re-elects the same new leader (lowest survivor)."""
        self._lost.add(int(rank))

    def rejoin_rank(self, rank: int) -> None:
        self._lost.discard(int(rank))

    def leader_rank(self) -> int:
        alive = [r for r in range(_world()) if r not in self._lost]
        if not alive:
            raise RuntimeError("no surviving rank to lead")
        return alive[0]

    def is_leader(self) -> bool:
        return _rank() == self.leader_rank()

    # split out for the unit tests (exercised without a multi-host run)
    def _encode(self, local: ProfileStore) -> bytes:
        entries = [e.to_dict() for op in self.ops
                   for e in local.entries(op=op)]
        return json.dumps(entries).encode("utf-8")

    def _merge_payloads(self, local: ProfileStore,
                        payloads: Sequence[bytes]) -> ProfileStore:
        merged = ProfileStore()
        merged.merge(local)
        for raw in payloads:
            if not raw:
                continue
            remote = ProfileStore()
            for d in json.loads(raw.decode("utf-8")):
                e = Entry.from_dict(d)
                remote.put(e.device_kind, e.op, e.shape, e.value,
                           meta=e.meta)
            merged.merge(remote, ops=list(self.ops))
        return merged

    def _allgather(self, payload: bytes) -> List[bytes]:
        """Every rank's ``payload``, in rank order: the lengths first, then
        the payloads padded to the longest."""
        import numpy as np
        import torch
        import torch.distributed as dist
        n = _world()
        arr = np.frombuffer(payload, dtype=np.uint8)
        lengths = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
        dist.all_gather(lengths, torch.tensor([arr.size], dtype=torch.int64),
                        group=self._group)
        sizes = [int(x) for x in lengths]
        padded = torch.zeros(max(sizes), dtype=torch.uint8)
        padded[:arr.size] = torch.from_numpy(arr.copy())
        got = [torch.zeros(max(sizes), dtype=torch.uint8) for _ in range(n)]
        dist.all_gather(got, padded, group=self._group)
        return [bytes(g[:k].numpy()) for g, k in zip(got, sizes)]

    def gather(self, local: ProfileStore) -> ProfileStore:
        if _world() == 1:
            return local
        me = _rank()
        payloads = [p for i, p in enumerate(self._allgather(
            self._encode(local))) if i != me]
        return self._merge_payloads(local, payloads)

    def broadcast(self, obj):
        """COLLECTIVE broadcast of the leader's JSON-serializable
        directive (None included) to every process.  Non-leaders' ``obj``
        is ignored.  Implemented as allgather-then-select-the-leader's
        payload so it works from WHICHEVER rank currently leads.  Two
        rounds because collectives want equal shapes: the payload lengths
        first, then the length-padded payloads.  The single-process
        shortcut still round-trips through JSON, so a directive behaves
        identically on and off the wire."""
        if _world() == 1:
            return None if obj is None else json.loads(json.dumps(obj))
        leader = self.leader_rank()
        payload = (json.dumps(obj).encode("utf-8")
                   if self.is_leader() and obj is not None else b"")
        got = self._allgather(payload)[leader]
        if not got:
            return None
        return json.loads(got.decode("utf-8"))


def _world() -> int:
    import torch.distributed as dist
    return (dist.get_world_size() if dist.is_available()
            and dist.is_initialized() else 1)


def _rank() -> int:
    import torch.distributed as dist
    return (dist.get_rank() if dist.is_available()
            and dist.is_initialized() else 0)


def default_aggregator():
    """The right aggregator for this runtime: the all-gather over the
    ranks of an initialised process group of several, identity
    otherwise.  The launch layer calls this — telemetry aggregation over
    ranks needs no extra flags."""
    return ProcessAllGatherAggregator() if _world() > 1 \
        else LocalAggregator()
