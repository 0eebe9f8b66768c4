"""Fast pipeline-schedule simulator: the planner's scoring hot path.

The port's copy of ``repro/core/fastsim.py``: the same arithmetic in the
same order, held exactly equal to it by ``tests/test_torch_planner.py``.

Produces the same ``SimReport`` as :mod:`repro_torch.core.simulator` (the
event-driven reference oracle, which stays authoritative in tests) but
avoids the oracle's O(m·pp²) rescan loop:

  * ``gpipe``       all-forward-then-all-backward has a closed-form
                    longest-path recurrence per stage row; evaluated with
                    O(pp) numpy prefix scans over microbatch vectors.
  * ``1f1b``        the strict PipeDream op order is known a priori, so
                    finish times are the longest path through a *static*
                    DAG.  Evaluated as a slot-wavefront recurrence
                    vectorized over stages: 2m steps of O(pp) numpy work
                    (same-slot warmup/drain chains solved with a prefix
                    max-plus scan), O(pp·m) total.
  * ``1f1b-eager``  the op order is timing-dependent (that is the point of
                    eager overlap), so no static recurrence exists.
                    Simulated as a bounded-lookahead discrete-event loop:
                    each stage exposes at most its next forward and next
                    backward (lookahead 1, in-flight bounded by
                    ``pp - stage + slack``) through a heap —
                    O(pp·m·log pp) instead of the oracle's O(m·pp²).
  * ``interleaved-1f1b``  virtual pipeline stages (vpp chunks per physical
                    stage, ``timings`` in virtual order — see the oracle's
                    docstring).  Same bounded-lookahead heap loop
                    generalized to chunks: each physical stage exposes the
                    next forward and next backward of each of its vpp
                    chunks, in-flight chunk-forwards capped at the Megatron
                    warmup envelope — O(pp·vpp·m·(vpp + log pp)) vs the
                    oracle's O(m·vpp²·pp²) rescan.

Invariant — fastsim == oracle, exactly: every schedule here produces
identical op orders and start times as the event-driven oracle
(:mod:`repro_torch.core.simulator`) for strictly positive fwd/bwd durations
(ties across stages are then provably independent).  This is an equality,
not an approximation: the planner's scores, the predictor's trace-exact
peak-memory accounting, and the adaptation controller's expected-gain
gate all rest on it.  ``tests/test_fastsim.py`` and
``tests/test_schedules.py`` assert agreement on randomized timings across
schedules, m, vpp, and eager slack; ``lower_bound`` is asserted to never
exceed the simulated time (pruning soundness).
"""
from __future__ import annotations

import functools
import heapq
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core.simulator import (ScheduleError, SimEvent, SimReport,
                                  StageTiming, interleaved_inflight_cap)


def _chain_max(d: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Solve G[i] = max(G[i-1] + c[i], d[i]) with G[-1] = -inf.

    Max-plus prefix scan: G[i] = S[i] + max_{k<=i}(d[k] - S[k]) with
    S = cumsum(c)."""
    S = np.cumsum(c)
    return S + np.maximum.accumulate(d - S)


def _runs(mask: np.ndarray) -> List[Tuple[int, int]]:
    """Maximal runs of True in ``mask`` as inclusive (start, end) pairs."""
    idx = np.flatnonzero(mask)
    if idx.size == 0:
        return []
    cuts = np.flatnonzero(np.diff(idx) > 1) + 1
    return [(int(seg[0]), int(seg[-1])) for seg in np.split(idx, cuts)]


# ------------------------------------------------------------------ gpipe --
def _gpipe(f: np.ndarray, b: np.ndarray, send: np.ndarray, m: int
           ) -> Tuple[np.ndarray, np.ndarray]:
    pp = len(f)
    F = np.empty((pp, m))
    B = np.empty((pp, m))
    dep = np.zeros(m)
    for i in range(pp):
        F[i] = _chain_max(dep + f[i], np.full(m, f[i]))
        dep = F[i] + send[i]
    for i in range(pp - 1, -1, -1):
        d = (F[i] if i == pp - 1 else B[i + 1] + send[i]) + b[i]
        # the stage is busy with forwards until F[i][m-1]
        d[0] = max(d[0], F[i, m - 1] + b[i])
        B[i] = _chain_max(d, np.full(m, b[i]))
    return F, B


# ------------------------------------------------------------ strict 1f1b --
def _1f1b_strict(f: np.ndarray, b: np.ndarray, send: np.ndarray, m: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Slot-wavefront evaluation of the static strict-1F1B DAG.

    Stage i's op sequence is fixed: w = min(m, pp-1-i) warmup forwards,
    steady F/B pairs, backward drain.  Slot s holds exactly one op per
    stage; all cross-stage dependencies point to the same or an earlier
    slot, with same-slot chains only along warmup forwards (descending
    stages) and drain backwards (ascending stages) — both contiguous, both
    solved with the max-plus scan.

    Below ``_SCALAR_PP`` stages the identical recurrence runs on python
    floats (``_1f1b_strict_scalar``): numpy per-call overhead exceeds the
    arithmetic for the short stage vectors real plans have."""
    pp = len(f)
    stages = np.arange(pp)
    w = np.minimum(m, pp - 1 - stages)
    F = np.zeros((pp, m))
    B = np.zeros((pp, m))
    prev = np.zeros(pp)                       # finish of previous slot's op
    send_in = np.concatenate(([0.0], send[:-1]))   # send from stage i-1
    for s in range(2 * m):
        warm = s < w
        drain = s >= 2 * m - w
        steady_f = ~warm & ~drain & ((s - w) % 2 == 0)
        is_f = warm | steady_f
        j = np.where(warm, s,
                     np.where(drain, s - m,
                              np.where(steady_f, (s + w) // 2,
                                       (s - w - 1) // 2)))
        dur = np.where(is_f, f, b)
        # external dependencies (valid wherever the dep is not same-slot)
        ext = np.empty(pp)
        ext[0] = 0.0
        if pp > 1:
            ext[1:] = F[stages[:-1], j[1:]] + send[:-1]
        dep_b = np.empty(pp)
        if pp > 1:
            dep_b[:-1] = B[stages[1:], j[:-1]] + send[:-1]
        dep_b[pp - 1] = F[pp - 1, j[pp - 1]]
        ext = np.where(is_f, ext, dep_b)
        # same-slot chains
        cf = np.zeros(pp, bool)
        cb = np.zeros(pp, bool)
        if pp > 1:
            cf[1:] = is_f[1:] & is_f[:-1] & (j[1:] == j[:-1])
            cb[:-1] = ~is_f[:-1] & ~is_f[1:] & (j[:-1] == j[1:])
        H = np.empty(pp)
        un = ~(cf | cb)
        H[un] = np.maximum(prev[un], ext[un]) + dur[un]
        for a, z in _runs(cf):      # warmup forwards: chain head at a-1
            sl = slice(a, z + 1)
            c = send_in[sl] + f[sl]
            d = prev[sl] + f[sl]
            d[0] = max(d[0], H[a - 1] + send_in[a] + f[a])
            H[sl] = _chain_max(d, c)
        for a, z in _runs(cb):      # drain backwards: chain head at z+1
            idx = np.arange(z, a - 1, -1)
            c = send[idx] + b[idx]
            d = prev[idx] + b[idx]
            d[0] = max(d[0], H[z + 1] + send[z] + b[z])
            H[idx] = _chain_max(d, c)
        F[stages[is_f], j[is_f]] = H[is_f]
        B[stages[~is_f], j[~is_f]] = H[~is_f]
        prev = H
    return F, B


_SCALAR_PP = 64


@functools.lru_cache(maxsize=32)
def _strict_ops(pp: int, m: int):
    """Per-slot op lists for the strict schedule (timing-independent):
    forwards in increasing-stage order, backwards in decreasing order —
    exactly the evaluation order same-slot chains require."""
    fo: List[List[Tuple[int, int]]] = [[] for _ in range(2 * m)]
    bo: List[List[Tuple[int, int]]] = [[] for _ in range(2 * m)]
    for i in range(pp):
        w = min(m, pp - 1 - i)
        for j in range(m):
            fo[j if j < w else 2 * j - w].append((i, j))
            bo[w + 2 * j + 1 if j < m - w else m + j].append((i, j))
    for ops in bo:
        ops.reverse()
    return fo, bo


def _1f1b_strict_scalar(fa: np.ndarray, ba: np.ndarray, sa: np.ndarray,
                        m: int) -> Tuple[np.ndarray, np.ndarray]:
    """Same slot-wavefront recurrence as ``_1f1b_strict`` on python floats.

    Per slot: one increasing-stage pass computes the forwards (same-slot F
    chains descend), one decreasing-stage pass the backwards (same-slot B
    chains ascend); F and B never depend on each other within a slot."""
    f = fa.tolist()
    b = ba.tolist()
    send = sa.tolist()
    pp = len(f)
    F = [[0.0] * m for _ in range(pp)]
    B = [[0.0] * m for _ in range(pp)]
    free = [0.0] * pp
    last = pp - 1
    fo, bo = _strict_ops(pp, m)
    for s in range(2 * m):
        for i, j in fo[s]:
            dep = 0.0 if i == 0 else F[i - 1][j] + send[i - 1]
            p = free[i]
            F[i][j] = free[i] = (p if p > dep else dep) + f[i]
        for i, j in bo[s]:
            dep = F[i][j] if i == last else B[i + 1][j] + send[i]
            p = free[i]
            B[i][j] = free[i] = (p if p > dep else dep) + b[i]
    return np.array(F), np.array(B)


# -------------------------------------------------------------- 1f1b-eager --
def _1f1b_eager(fa: np.ndarray, ba: np.ndarray, sa: np.ndarray, m: int,
                slack: int) -> Tuple[np.ndarray, np.ndarray]:
    """Bounded-lookahead discrete-event replay of the oracle's greedy
    eager policy: per stage only the next F and next B are candidates
    (lookahead 1), in-flight forwards capped at min(m, pp-i) + slack,
    start-time ties prefer B.  An executed op re-enqueues its own stage
    and the (at most one) neighbor whose next op it just enabled, so the
    heap sees O(pp·m) pushes total."""
    f = fa.tolist()
    b = ba.tolist()
    send = sa.tolist()
    pp = len(f)
    F = [[0.0] * m for _ in range(pp)]
    B = [[0.0] * m for _ in range(pp)]
    nf = [0] * pp
    nb = [0] * pp
    free = [0.0] * pp
    cap = [min(m, pp - i) + slack for i in range(pp)]
    ver = [0] * pp
    heap: list = []
    push = heapq.heappush

    def enqueue(i: int) -> None:
        ver[i] += 1
        best = None
        jb = nb[i]
        if jb < m:
            if i == pp - 1:
                d = F[i][jb] if jb < nf[i] else None
            else:
                d = B[i + 1][jb] + send[i] if jb < nb[i + 1] else None
            if d is not None:
                fr = free[i]
                best = (fr if fr > d else d, 0)      # 0: B wins start ties
        jf = nf[i]
        if jf < m and jf - jb < cap[i]:
            if i == 0:
                d = 0.0
            else:
                d = F[i - 1][jf] + send[i - 1] if jf < nf[i - 1] else None
            if d is not None:
                fr = free[i]
                cand = (fr if fr > d else d, 1)
                if best is None or cand < best:
                    best = cand
        if best is not None:
            push(heap, (best[0], best[1], i, ver[i]))

    for i in range(pp):
        enqueue(i)
    done = 0
    total = 2 * m * pp
    while done < total:
        if not heap:  # pragma: no cover - dependency bug guard
            stuck = next(i for i in range(pp) if nf[i] < m or nb[i] < m)
            raise ScheduleError(stuck, min(nf[stuck], nb[stuck]),
                                "F" if nf[stuck] < m else "B", "1f1b-eager")
        start, kind, i, v = heapq.heappop(heap)
        if v != ver[i]:
            continue
        if kind == 1:
            j = nf[i]
            F[i][j] = free[i] = start + f[i]
            nf[i] = j + 1
            enqueue(i)
            # F(i,j) enables F(i+1,j) iff that is exactly the next forward
            if i + 1 < pp and nf[i + 1] == j:
                enqueue(i + 1)
        else:
            j = nb[i]
            B[i][j] = free[i] = start + b[i]
            nb[i] = j + 1
            enqueue(i)
            # B(i,j) enables B(i-1,j) iff that is exactly the next backward
            if i > 0 and nb[i - 1] == j:
                enqueue(i - 1)
        done += 1
    return np.array(F), np.array(B)


# --------------------------------------------------------- interleaved-1f1b --
def _interleaved(fa: List[float], ba: List[float], sa: List[float], m: int,
                 vpp: int, inflight_cap,
                 trace=None) -> Tuple[np.ndarray, list]:
    """Bounded-lookahead heap DES replaying the oracle's greedy interleaved
    policy over V = pp*vpp virtual stages (timings in virtual order).

    Per physical stage the candidates are the heads of its Megatron fwd /
    bwd streams (``simulator.interleaved_streams``) — lookahead 1 per
    direction; earliest start wins, ties prefer backward — byte-identical
    policy to simulator._simulate_interleaved.  An executed op re-enqueues
    its own stage plus the (at most one) neighbor stage whose stream-head
    op it just enabled, so the heap sees O(V·m) pushes instead of the
    oracle's O(m²·vpp²·pp²) rescans."""
    from repro_torch.core.simulator import interleaved_streams

    V = len(fa)
    pp = V // vpp
    done_f = [[False] * m for _ in range(V)]
    done_b = [[False] * m for _ in range(V)]
    F = [[0.0] * m for _ in range(V)]
    B = [[0.0] * m for _ in range(V)]
    fseq, bseq = interleaved_streams(pp, vpp, m)
    n_ops = m * vpp
    pf = [0] * pp
    pb = [0] * pp
    free = [0.0] * pp
    inflight = [0] * pp
    cap = [interleaved_inflight_cap(i, pp, m, vpp) if inflight_cap is None
           else inflight_cap for i in range(pp)]
    ver = [0] * pp
    last = V - 1
    heap: list = []
    push = heapq.heappush

    def enqueue(i: int) -> None:
        ver[i] += 1
        fr = free[i]
        best = None
        if pb[i] < n_ops:
            c, j = bseq[pb[i]]
            vs = c * pp + i
            if vs == last:
                d = F[vs][j] if done_f[vs][j] else None
            else:
                d = B[vs + 1][j] + sa[vs] if done_b[vs + 1][j] else None
            if d is not None:
                best = (fr if fr > d else d, 0, vs, j)
        if pf[i] < n_ops and inflight[i] < cap[i]:
            c, j = fseq[pf[i]]
            vs = c * pp + i
            if vs == 0:
                d = 0.0
            else:
                d = F[vs - 1][j] + sa[vs - 1] if done_f[vs - 1][j] else None
            if d is not None:
                cand = (fr if fr > d else d, 1, vs, j)
                if best is None or cand < best:
                    best = cand
        if best is not None:
            push(heap, best + (i, ver[i]))

    for i in range(pp):
        enqueue(i)
    done = 0
    total = 2 * m * V
    while done < total:
        if not heap:
            i = next(k for k in range(pp)
                     if pf[k] < n_ops or pb[k] < n_ops)
            stuck_f = pf[i] < n_ops
            c, j = fseq[pf[i]] if stuck_f else bseq[pb[i]]
            raise ScheduleError(
                i, j, "F" if stuck_f else "B", "interleaved-1f1b",
                f"chunk {c} " + (f"forward blocked (in-flight cap {cap[i]})"
                                 if stuck_f
                                 else "backward dependency never satisfied"))
        start, dir_key, vs, j, i, v = heapq.heappop(heap)
        if v != ver[i]:
            continue
        if dir_key == 1:
            F[vs][j] = free[i] = start + fa[vs]
            done_f[vs][j] = True
            pf[i] += 1
            inflight[i] += 1
            if trace is not None:
                trace.append(SimEvent(start=start, finish=free[i], stage=i,
                                      vs=vs, microbatch=j, dir="F"))
            enqueue(i)
            # F(vs,j) enables F(vs+1,j) / B(V-1,j) iff it is the head of
            # the neighbor's stream (same-stage heads covered by enqueue(i))
            if vs < last:
                ni = (vs + 1) % pp
                if ni != i and pf[ni] < n_ops and \
                        fseq[pf[ni]] == ((vs + 1) // pp, j):
                    enqueue(ni)
        else:
            B[vs][j] = free[i] = start + ba[vs]
            done_b[vs][j] = True
            pb[i] += 1
            inflight[i] -= 1
            if trace is not None:
                trace.append(SimEvent(start=start, finish=free[i], stage=i,
                                      vs=vs, microbatch=j, dir="B"))
            enqueue(i)
            # B(vs,j) enables B(vs-1,j) iff it heads the neighbor's stream
            if vs > 0:
                ni = (vs - 1) % pp
                if ni != i and pb[ni] < n_ops and \
                        bseq[pb[ni]] == ((vs - 1) // pp, j):
                    enqueue(ni)
        done += 1
    # per-physical-stage last backward (its bwd stream's tail)
    last_b = np.array([max(B[c * pp + i][m - 1] for c in range(vpp))
                       for i in range(pp)])
    return last_b, [m * sum(fa[c * pp + i] + ba[c * pp + i]
                            for c in range(vpp)) for i in range(pp)]


# ---------------------------------------------------------------- frontend --
def lower_bound(timings: Sequence[StageTiming], m: int,
                dp_allreduce: float = 0.0, vpp: int = 1) -> float:
    """Schedule-independent iteration-time lower bound.

    For every stage i (any of 1f1b / 1f1b-eager / gpipe / interleaved):
      * its first op cannot start before the forward dependency chain
        into its first (virtual) stage: sum_{k<i}(fwd_k + send_k);
      * its 2m ops are serial: m·(fwd_i + bwd_i) of busy time — under
        interleaving a PHYSICAL stage serializes all its chunks,
        m·sum_c(fwd_c + bwd_c);
      * its last op is a B(m-1) whose backward chain to (virtual) stage 0
        still costs sum_{k<i}(bwd_k + send_k) — eager overlap reorders work
        around the sends, it never removes them from these two chains.
    So iter_time >= max_i [chain_in(i) + m·busy_i + chain_out(i)], and with
    an overlapped gradient all-reduce >= max_i [chain_in(i) + m·busy_i] +
    dp_allreduce.  With ``vpp > 1`` (timings in virtual order) both the
    per-physical-stage and per-virtual-stage variants of the bound apply;
    the max of all is returned.  Tight enough (it includes warmup+drain)
    that the planner's best-first loop prunes most non-winning candidates
    unscored."""
    V = len(timings)
    if vpp == 1:
        pf = pb = 0.0
        lb = lb_dp = 0.0
        for t in timings:
            serial = m * (t.fwd + t.bwd)
            lb = max(lb, pf + serial + pb)
            lb_dp = max(lb_dp, pf + serial)
            pf += t.fwd + t.send
            pb += t.bwd + t.send
        return max(lb, lb_dp + dp_allreduce)
    pp = V // vpp
    chain_in = [0.0] * V
    chain_out = [0.0] * V
    cin = cout = 0.0
    for vs, t in enumerate(timings):
        chain_in[vs] = cin
        chain_out[vs] = cout
        cin += t.fwd + t.send
        cout += t.bwd + t.send
    lb = lb_dp = 0.0
    for vs, t in enumerate(timings):       # per-virtual-stage serial bound
        serial = m * (t.fwd + t.bwd)
        lb = max(lb, chain_in[vs] + serial + chain_out[vs])
        lb_dp = max(lb_dp, chain_in[vs] + serial)
    for i in range(pp):                    # per-physical-stage serial bound
        serial = m * sum(timings[c * pp + i].fwd + timings[c * pp + i].bwd
                         for c in range(vpp))
        lb = max(lb, chain_in[i] + serial + chain_out[i])
        lb_dp = max(lb_dp, chain_in[i] + serial)
    return max(lb, lb_dp + dp_allreduce)


def simulate(timings: Sequence[StageTiming], m: int,
             schedule: str = "1f1b-eager", dp_allreduce: float = 0.0,
             overlap_dp: bool = True, eager_slack: int = 2, vpp: int = 1,
             inflight_cap=None, trace=None) -> SimReport:
    """Drop-in fast equivalent of ``simulator.simulate`` (``vpp`` /
    ``inflight_cap`` apply to interleaved-1f1b only; ``timings`` are then
    pp*vpp entries in virtual order).  ``trace`` is appended with the
    executed ``SimEvent`` list — op-for-op equal to the oracle's for
    interleaved-1f1b; the non-interleaved recurrences never materialise
    per-op events, so a traced non-interleaved call delegates to the
    oracle (trace requests come from plan-adoption rendering in
    the JAX package's observability, never from the planner's hot
    path)."""
    if trace is not None and schedule != "interleaved-1f1b":
        from repro_torch.core import simulator
        return simulator.simulate(timings, m, schedule, dp_allreduce,
                                  overlap_dp, eager_slack, vpp,
                                  inflight_cap, trace)
    pp = len(timings)
    f = [t.fwd for t in timings]
    b = [t.bwd for t in timings]
    send = [t.send for t in timings]
    if schedule == "interleaved-1f1b":
        if vpp < 1 or pp % vpp:
            raise ValueError(
                f"interleaved-1f1b needs len(timings) divisible by vpp; "
                f"got {pp} timings, vpp={vpp}")
        last_b, busy = _interleaved(f, b, send, m, vpp, inflight_cap, trace)
        end = float(last_b.max())
        if dp_allreduce > 0.0:
            if overlap_dp:
                end = max(end, float(last_b.max() + dp_allreduce))
            else:
                end += dp_allreduce
        bubble = 1.0 - sum(x / end for x in busy) / len(busy)
        return SimReport(iter_time=end, stage_busy=tuple(busy),
                         bubble_frac=bubble, schedule=schedule)
    if vpp != 1:
        raise ValueError(f"schedule {schedule!r} does not take vpp={vpp}")
    f = np.asarray(f)
    b = np.asarray(b)
    send = np.asarray(send)
    if schedule == "gpipe":
        _, B = _gpipe(f, b, send, m)
    elif schedule == "1f1b":
        strict = _1f1b_strict_scalar if pp < _SCALAR_PP else _1f1b_strict
        _, B = strict(f, b, send, m)
    elif schedule == "1f1b-eager":
        _, B = _1f1b_eager(f, b, send, m, eager_slack)
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    last_b = B[:, m - 1]
    end = float(last_b.max())
    busy = tuple(m * (t.fwd + t.bwd) for t in timings)
    if dp_allreduce > 0.0:
        if overlap_dp:
            end = max(end, float(last_b.max() + dp_allreduce))
        else:
            end += dp_allreduce
    bubble = 1.0 - sum(x / end for x in busy) / pp
    return SimReport(iter_time=end, stage_busy=busy, bubble_frac=bubble,
                     schedule=schedule)
