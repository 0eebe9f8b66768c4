"""Workload simulator (paper §3.2): replays a candidate plan through an exact
pipeline schedule and reports iteration time + peak memory.

The port's copy of ``repro/core/simulator.py``: the same arithmetic in the
same order, held exactly equal to it by ``tests/test_torch_planner.py``.

Schedules:
  * ``1f1b``        strict PipeDream-1F1B op order (paper's data constraint);
                    P2P transfer time sits on the critical path.
  * ``1f1b-eager``  1F1B with compute/comm overlap: a stage may run its next
                    ready forward while a backward is still in flight, with
                    the in-flight count capped at (pp - stage) + slack.  This
                    models async iSend/iRecv (ICCL) overlap and is required
                    to reach the paper's 97.5%-of-bound numbers when the
                    heterogeneous-boundary link is slow.
  * ``gpipe``       all forwards then all backwards (memory-hungry baseline).
  * ``interleaved-1f1b``  virtual pipeline stages (Megatron interleaving):
                    each physical stage holds ``vpp`` model chunks; chunk c
                    of stage i is virtual stage c*pp + i.  ``timings`` then
                    has pp*vpp entries in VIRTUAL order — entry vs describes
                    chunk vs//pp on physical stage vs%pp, and ``.send`` is
                    the P2P hop to the physical stage hosting vs+1
                    (including the pp-1 -> 0 wrap between passes).  Each
                    stage issues forwards/backwards in the Megatron stream
                    orders (``interleaved_streams``: microbatch groups of
                    pp per chunk, backwards chunk-reversed); op timing is
                    greedy/eager (async iSend/iRecv, the repo's standing
                    ICCL assumption) with in-flight chunk-forwards capped
                    at the Megatron warmup envelope
                    2*(pp-1-i) + (vpp-1)*pp + 1 and backwards preferred on
                    start-time ties.  Finer chunks cut the warmup/drain
                    ramp per pass by ~1/vpp, shrinking the bubble on deep
                    models at the cost of more in-flight activation memory
                    (``peak_activation_microbatches``).

The simulation is greedy event-driven list scheduling over the op DAG and is
exact for the given per-op times.

This module is the REFERENCE ORACLE: O(m·pp²) (O(m·vpp²·pp²) interleaved)
and deliberately simple.  The planner's hot path scores plans through
repro_torch.core.fastsim, whose vectorized recurrences /
bounded-lookahead event loops are asserted exact against this
implementation (tests/test_fastsim.py, tests/test_schedules.py).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

SCHEDULES = ("1f1b", "1f1b-eager", "gpipe", "interleaved-1f1b")


class ScheduleError(RuntimeError):
    """A pipeline schedule wedged: no runnable op exists although work
    remains.  Carries the first stuck (stage, microbatch, direction) triple
    so the failing dependency is diagnosable from the message alone."""

    def __init__(self, stage: int, microbatch: int, direction: str,
                 schedule: str, detail: str = ""):
        self.stage = stage
        self.microbatch = microbatch
        self.direction = direction
        self.schedule = schedule
        msg = (f"schedule {schedule!r} deadlocked: stuck op "
               f"(stage={stage}, microbatch={microbatch}, "
               f"dir={direction})")
        if detail:
            msg += f" — {detail}"
        super().__init__(msg)


@dataclasses.dataclass(frozen=True)
class StageTiming:
    fwd: float           # seconds per microbatch forward
    bwd: float           # seconds per microbatch backward
    send: float          # seconds to transfer activations stage i -> i+1


@dataclasses.dataclass(frozen=True)
class SimReport:
    iter_time: float
    stage_busy: Tuple[float, ...]
    bubble_frac: float
    schedule: str


@dataclasses.dataclass(frozen=True)
class SimEvent:
    """One executed op of the interleaved oracle's trace (virtual stage
    ``vs`` = chunk vs//pp on physical stage vs%pp)."""
    start: float
    finish: float
    stage: int           # physical stage
    vs: int              # virtual stage
    microbatch: int
    dir: str             # "F" | "B"


def interleaved_inflight_cap(stage: int, pp: int, m: int, vpp: int) -> int:
    """Max chunk-forwards in flight (done, backward pending) at a physical
    stage under interleaved-1F1B: the Megatron warmup count
    2*(pp-1-stage) + (vpp-1)*g, plus the one in steady-state flight,
    bounded by the stage's total chunk-forwards vpp*m.  g = min(pp, m) is
    the microbatch-group size of ``interleaved_streams`` — Megatron's pp,
    ragged when m < pp."""
    return min(vpp * m, 2 * (pp - 1 - stage) + (vpp - 1) * min(pp, m) + 1)


@functools.lru_cache(maxsize=64)
def interleaved_streams(pp: int, vpp: int, m: int
                        ) -> Tuple[Tuple[Tuple[int, int], ...],
                                   Tuple[Tuple[int, int], ...]]:
    """Megatron interleaved op order as two per-stage (chunk, microbatch)
    streams (identical for every stage — only the virtual-stage id
    chunk*pp + stage differs).

    Forwards run microbatches in groups of pp per chunk — chunk 0 mbs
    0..pp-1, chunk 1 mbs 0..pp-1, ..., then mbs pp..2pp-1 — i.e. sorted by
    (mb // pp, chunk, mb % pp); backwards mirror it with chunks reversed.
    Defined for ANY m (the last group is simply ragged), reducing to plain
    microbatch order at vpp=1.  Each stage issues its forwards strictly in
    fwd-stream order and backwards in bwd-stream order; the event-driven
    simulators only choose, greedily by start time, WHICH stream head runs
    next (in-flight forwards capped at ``interleaved_inflight_cap``)."""
    ops = [(c, j) for c in range(vpp) for j in range(m)]
    fwd = tuple(sorted(ops, key=lambda o: (o[1] // pp, o[0], o[1] % pp)))
    bwd = tuple(sorted(ops, key=lambda o: (o[1] // pp, vpp - 1 - o[0],
                                           o[1] % pp)))
    return fwd, bwd


def _finish_report(end: float, busy: Sequence[float], last_b: Sequence[float],
                   schedule: str, dp_allreduce: float, overlap_dp: bool
                   ) -> SimReport:
    if dp_allreduce > 0.0:
        if overlap_dp:
            end = max(end, max(lb + dp_allreduce for lb in last_b))
        else:
            end += dp_allreduce
    bubble = 1.0 - sum(b / end for b in busy) / len(busy)
    return SimReport(iter_time=end, stage_busy=tuple(busy),
                     bubble_frac=bubble, schedule=schedule)


def _simulate_interleaved(timings: Sequence[StageTiming], m: int, vpp: int,
                          dp_allreduce: float, overlap_dp: bool,
                          inflight_cap: Optional[int],
                          trace: Optional[List[SimEvent]]) -> SimReport:
    """Greedy event-driven interleaved-1F1B over pp*vpp virtual stages.

    Each physical stage issues its forwards in the Megatron fwd-stream
    order and its backwards in the bwd-stream order
    (``interleaved_streams``); at every step the globally
    earliest-startable stream-head op runs, start-time ties preferring
    backwards (memory pressure).  Forwards additionally respect the
    per-stage in-flight cap (``interleaved_inflight_cap``, or the
    ``inflight_cap`` override) — the stream order guarantees in-flight
    work is always retirable, so the cap cannot wedge the schedule (a
    too-small explicit override can, raising ScheduleError).  The policy
    is identical to fastsim._interleaved — the two implementations must
    stay op-for-op equal (tests/test_schedules.py)."""
    V = len(timings)
    if vpp < 1 or V % vpp:
        raise ValueError(
            f"interleaved-1f1b needs len(timings) divisible by vpp; "
            f"got {V} timings, vpp={vpp}")
    pp = V // vpp
    finish_f: List[List[Optional[float]]] = [[None] * m for _ in range(V)]
    finish_b: List[List[Optional[float]]] = [[None] * m for _ in range(V)]
    fseq, bseq = interleaved_streams(pp, vpp, m)
    pf = [0] * pp                     # per-physical-stage stream positions
    pb = [0] * pp
    free = [0.0] * pp
    inflight = [0] * pp
    cap = [interleaved_inflight_cap(i, pp, m, vpp) if inflight_cap is None
           else inflight_cap for i in range(pp)]
    n_ops = m * vpp

    total = 2 * m * V
    done = 0
    while done < total:
        best = None  # (start, dir_key, vs, j); global strict-min start
        for i in range(pp):
            cand = []
            if pb[i] < n_ops:
                c, j = bseq[pb[i]]
                vs = c * pp + i
                if vs == V - 1:
                    d = finish_f[vs][j]
                else:
                    t = finish_b[vs + 1][j]
                    d = None if t is None else t + timings[vs].send
                if d is not None:
                    cand.append((max(free[i], d), 0, vs, j))
            if pf[i] < n_ops and inflight[i] < cap[i]:
                c, j = fseq[pf[i]]
                vs = c * pp + i
                if vs == 0:
                    d = 0.0
                else:
                    t = finish_f[vs - 1][j]
                    d = None if t is None else t + timings[vs - 1].send
                if d is not None:
                    cand.append((max(free[i], d), 1, vs, j))
            if not cand:
                continue
            cand.sort()
            if best is None or cand[0][0] < best[0]:
                best = cand[0]
        if best is None:
            for i in range(pp):
                if pf[i] < n_ops:
                    c, j = fseq[pf[i]]
                    raise ScheduleError(i, j, "F", "interleaved-1f1b",
                                        f"chunk {c} forward blocked "
                                        f"(in-flight cap {cap[i]})")
                if pb[i] < n_ops:  # pragma: no cover - dependency bug guard
                    c, j = bseq[pb[i]]
                    raise ScheduleError(i, j, "B", "interleaved-1f1b",
                                        f"chunk {c} backward dependency "
                                        "never satisfied")
            raise ScheduleError(-1, -1, "?", "interleaved-1f1b")  # pragma: no cover
        s, dir_key, vs, j = best
        i = vs % pp
        if dir_key == 1:
            finish_f[vs][j] = free[i] = s + timings[vs].fwd
            pf[i] += 1
            inflight[i] += 1
            kind = "F"
        else:
            finish_b[vs][j] = free[i] = s + timings[vs].bwd
            pb[i] += 1
            inflight[i] -= 1
            kind = "B"
        if trace is not None:
            trace.append(SimEvent(start=s, finish=free[i], stage=i, vs=vs,
                                  microbatch=j, dir=kind))
        done += 1

    # stage i's final op is its chunk-0 backward B(vs=i, m-1)
    last_b = [max(finish_b[c * pp + i][m - 1] for c in range(vpp))
              for i in range(pp)]
    end = max(last_b)
    busy = [m * sum(timings[c * pp + i].fwd + timings[c * pp + i].bwd
                    for c in range(vpp)) for i in range(pp)]
    return _finish_report(end, busy, last_b, "interleaved-1f1b",
                          dp_allreduce, overlap_dp)


def simulate(timings: Sequence[StageTiming], m: int,
             schedule: str = "1f1b-eager", dp_allreduce: float = 0.0,
             overlap_dp: bool = True, eager_slack: int = 2, vpp: int = 1,
             inflight_cap: Optional[int] = None,
             trace: Optional[List[SimEvent]] = None) -> SimReport:
    """``vpp``/``inflight_cap`` only apply to ``interleaved-1f1b`` (see
    module docstring for the virtual-order ``timings`` convention).
    ``trace`` is appended with the executed ``SimEvent`` list for every
    schedule (non-interleaved ops carry ``vs == stage``) — memory
    accounting tests and the observability predicted-lane renderer
    (the JAX package's ``repro/obs/trace.py``) consume it."""
    if schedule == "interleaved-1f1b":
        return _simulate_interleaved(timings, m, vpp, dp_allreduce,
                                     overlap_dp, inflight_cap, trace)
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}")
    if vpp != 1:
        raise ValueError(f"schedule {schedule!r} does not take vpp={vpp}")
    pp = len(timings)
    finish_f: List[List[Optional[float]]] = [[None] * m for _ in range(pp)]
    finish_b: List[List[Optional[float]]] = [[None] * m for _ in range(pp)]
    nf = [0] * pp            # next forward / backward microbatch index
    nb = [0] * pp
    free = [0.0] * pp

    def f_dep(i: int, j: int) -> Optional[float]:
        if i == 0:
            return 0.0
        t = finish_f[i - 1][j]
        return None if t is None else t + timings[i - 1].send

    def b_dep(i: int, j: int) -> Optional[float]:
        if i == pp - 1:
            return finish_f[i][j]
        t = finish_b[i + 1][j]
        return None if t is None else t + timings[i].send

    def cap(i: int) -> int:
        if schedule == "gpipe":
            return m
        base = min(m, pp - i)
        return base + (eager_slack if schedule == "1f1b-eager" else 0)

    def strict_next_is_f(i: int) -> bool:
        """Strict 1F1B order: warmup forwards then alternate F,B then drain."""
        if schedule == "gpipe":
            return nf[i] < m
        w = min(m, pp - i - 1)
        if nf[i] < w:
            return True
        if nf[i] >= m:
            return False
        # steady state: F_{w+k} precedes B_k
        return nf[i] - w == nb[i]

    total = 2 * m * pp
    done = 0
    while done < total:
        best = None  # (start, kind, stage)
        for i in range(pp):
            cand = []
            f_ok = nf[i] < m and (nf[i] - nb[i]) < cap(i)
            b_ok = nb[i] < m and nb[i] < nf[i] if i == pp - 1 else nb[i] < m
            if schedule in ("1f1b", "gpipe"):
                if strict_next_is_f(i):
                    b_ok = False
                else:
                    f_ok = False
            if b_ok:
                d = b_dep(i, nb[i])
                if d is not None:
                    cand.append((max(free[i], d), "B"))
            if f_ok:
                d = f_dep(i, nf[i])
                if d is not None:
                    cand.append((max(free[i], d), "F"))
            if not cand:
                continue
            # prefer earlier start; tie-break backward (memory pressure)
            cand.sort(key=lambda c: (c[0], c[1] != "B"))
            s, kind = cand[0]
            if best is None or s < best[0]:
                best = (s, kind, i)
        if best is None:
            for i in range(pp):
                if nf[i] < m:
                    raise ScheduleError(i, nf[i], "F", schedule)
                if nb[i] < m:
                    raise ScheduleError(i, nb[i], "B", schedule)
            raise ScheduleError(-1, -1, "?", schedule)  # pragma: no cover
        s, kind, i = best
        if kind == "F":
            mb = nf[i]
            finish_f[i][nf[i]] = s + timings[i].fwd
            free[i] = finish_f[i][nf[i]]
            nf[i] += 1
        else:
            mb = nb[i]
            finish_b[i][nb[i]] = s + timings[i].bwd
            free[i] = finish_b[i][nb[i]]
            nb[i] += 1
        if trace is not None:
            trace.append(SimEvent(start=s, finish=free[i], stage=i, vs=i,
                                  microbatch=mb, dir=kind))
        done += 1

    end = max(max(r) for r in finish_b)
    busy = [m * (t.fwd + t.bwd) for t in timings]
    last_b = [finish_b[i][m - 1] for i in range(pp)]
    return _finish_report(end, busy, last_b, schedule, dp_allreduce,
                          overlap_dp)


def trace_peak_layers(trace: Sequence[SimEvent], pp: int,
                      virtual_layers: Sequence[int]) -> List[int]:
    """Per-physical-stage peak of LAYER-WEIGHTED in-flight chunk-forwards,
    accounted from an executed interleaved trace: +layers(vs) at each
    chunk-forward, -layers(vs) when its backward retires it, peak over the
    (start-ordered, backwards-first-on-ties) event sequence.

    This is the chunk-level activation accounting ``predictor.peak_memory``
    uses for interleaved plans: with ragged ``chunk_layers`` the in-flight
    MIX matters — a stage whose big chunk dominates the warmup ramp peaks
    strictly above the mean-chunk envelope (layers/vpp x in-flight count),
    which both under- and over-estimated depending on which chunks were in
    flight (ROADMAP: chunk-level memory accounting)."""
    per_stage: List[List[SimEvent]] = [[] for _ in range(pp)]
    for e in trace:
        per_stage[e.stage].append(e)
    peaks = []
    for evs in per_stage:
        evs.sort(key=lambda e: (e.start, e.dir == "F"))
        cur = peak = 0
        for e in evs:
            w = virtual_layers[e.vs]
            cur += w if e.dir == "F" else -w
            if cur > peak:
                peak = cur
        peaks.append(peak)
    return peaks


def peak_activation_microbatches(stage: int, pp: int, m: int,
                                 schedule: str = "1f1b",
                                 eager_slack: int = 2, vpp: int = 1) -> int:
    """Peak in-flight microbatches (activation memory) at a stage.

    For ``interleaved-1f1b`` the unit is microbatch-CHUNKS — each holds
    ~n_layers/vpp of the stage's layers — and the value is the enforced
    in-flight envelope (``interleaved_inflight_cap``), which the greedy
    schedule saturates whenever enough forwards are available
    (tests/test_schedules.py checks both against the oracle's trace)."""
    if schedule == "interleaved-1f1b":
        return interleaved_inflight_cap(stage, pp, m, vpp)
    if schedule == "gpipe":
        return m
    base = min(m, pp - stage)
    return base + (eager_slack if schedule == "1f1b-eager" else 0)
