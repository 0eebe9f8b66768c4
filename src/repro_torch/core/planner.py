"""Automatic parallel planner (paper §3.3).

The port's copy of ``repro/core/planner.py``: the same arithmetic in the
same order, held exactly equal to it by ``tests/test_torch_planner.py``.

Three-level search tree, DFS-traversed:
  level 1: pipeline degree PP + contiguous assignment of stages to node
           groups + (non-)uniform layer segmentation   [heterogeneous]
  level 2: uniform DP inside each homogeneous group    [homogeneous nodes]
  level 3: TP width per island — uniform inside a group, asymmetric
           across islands (HexiScale-style); boundary hops whose (tp, dp)
           disagree are charged the predictor's reshard cost [accelerators]

Rules guiding the DFS (paper):
  1. load balance — layers ∝ per-stage effective speed;  the fast engine
     derives per-stage per-layer times from the active ``CostSource`` (so
     a measured profile drives the split, not nameplate TFLOPs) and adds
     ``segmentation.dp_split`` — the exact min-bottleneck assignment
     including boundary P2P sends — next to the proportional+rebalance
     heuristic;
  2. minimum end-to-end time — every leaf is scored by the distributed
     performance predictor (workload simulator), lowest wins.  With
     ``schedule="auto"`` each surviving split is scored under strict
     ``1f1b``, ``1f1b-eager`` across a small eager-slack sweep, ``gpipe``,
     and ``interleaved-1f1b`` with vpp ∈ ``vpp_options`` (each vpp gets
     its own chunk-granular dp_split over the pp*vpp virtual stages); the
     winning schedule (+ slack / vpp / chunk layers) is recorded in the
     plan.  Level 1 additionally explores non-contiguous stage→group
     orders (fast islands at the pipeline ends), and ``require_fit``
     searches derive per-stage ``max_layers`` caps from HBM limits so
     infeasible splits are pruned at segmentation time.

Engines:
  * ``fast``       (default) memoized cost-source reads, cached per-stage
    linear timing coefficients, vectorized fastsim scoring, schedule
    sweep.  ~10-100x faster per search than reference.
  * ``reference``  the pre-fastsim planner, verbatim: event-driven
    simulator, uncached cost reads, single schedule, TFLOPs-derived
    non-uniform heuristic only.  Kept as the baseline/oracle for
    ``benchmarks/bench_planner.py`` and equivalence tests.

The planner doubles as the fault-tolerance brain: on node loss, re-run
``search`` on the surviving ClusterSpec and reshard (train/trainer.py) —
autonomously, when the adaptation controller (the JAX package's
``repro/adapt/``; the port's is ROADMAP queue A) is driving.

Invariants (locked by tests/test_fastsim.py, tests/test_schedules.py,
tests/test_adapt.py):
  * the fast engine's winner is never predicted worse than the reference
    engine's on the same inputs, and lower-bound pruning never discards a
    candidate that could beat the incumbent best (the bound is a true
    lower bound on simulated iter_time);
  * with ``baseline_plan`` given, the incumbent is scored under the SAME
    cost source as every candidate, the winner's iter_time is <= the
    incumbent's whenever the incumbent is feasible, and
    ``PlannerResult.baseline_time`` / ``.expected_gain`` expose the
    margin — the quantity a replan policy gates live migrations on;
  * every leaf is scored by simulation (fastsim == event-driven oracle,
    op-for-op), never by a closed-form approximation.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core import costmodel, fastsim, segmentation, simulator
from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.plan import (ParallelPlan, ServingPlan, ServingSLO,
                             StagePlacement, TrafficProfile)
from repro_torch.core.predictor import (GBPS, PerformancePredictor, Prediction,
                                  ServeLoad)
from repro_torch.models.config import ModelConfig

DEFAULT_EAGER_SLACKS = (1, 2, 4)


@dataclasses.dataclass(frozen=True)
class PlannerResult:
    plan: ParallelPlan
    prediction: Prediction
    evaluated: int
    log: Tuple[Tuple[str, float], ...]  # (plan description, iter_time)
    pruned: int = 0   # candidates skipped by the lower-bound cutoff
    # incumbent's (``baseline_plan``) predicted iter_time under the SAME
    # cost source as the winner, when one was scored AND adoptable (an
    # incumbent failing require_fit records no baseline: nothing to stay
    # put on) — the expected-gain accounting a replan policy gates
    # migrations on (migrations aren't free, so the winner must beat the
    # incumbent by a margin)
    baseline_time: Optional[float] = None

    @property
    def expected_gain(self) -> Optional[float]:
        """Predicted fractional iter-time improvement of the winning plan
        over the scored incumbent: ``1 - winner/incumbent``.  None when no
        adoptable incumbent was scored (fresh search, the baseline no
        longer maps onto the cluster, or it fails require_fit); <= 0
        means the search predicts staying put is
        at least as fast (the winner IS the incumbent, or ties it)."""
        if self.baseline_time is None or self.baseline_time <= 0.0:
            return None
        return 1.0 - self.prediction.iter_time / self.baseline_time


def _stage_group_orders(cluster: ClusterSpec, pp: int,
                        explore: bool = True) -> List[List[int]]:
    """Candidate stage→group assignments for a pipeline of pp stages.

    Always contains the contiguous assignment (``_stage_groups``).  With
    ``explore`` and a heterogeneous cluster it adds non-contiguous orders
    (ROADMAP: non-contiguous stage-to-group assignment): the reversed
    island order, and the fastest island split across both pipeline ends —
    end stages carry the least warmup/drain exposure under 1F1B, so fast
    islands there can absorb more layers before becoming the bottleneck.
    Extra orders cost extra boundary P2P hops; the schedule sweep decides
    per candidate whether that trade wins (cheap now that the best-first
    loop prunes by lower bound)."""
    base = _stage_groups(cluster, pp)
    if base is None:
        return []
    orders = [base]
    if explore and len(cluster.groups) > 1:
        orders.append(list(reversed(base)))
        fastest = max(range(len(cluster.groups)),
                      key=lambda g: cluster.groups[g].device.effective_tflops)
        cf = base.count(fastest)
        if cf > 1:
            front = (cf + 1) // 2
            mid = [g for g in base if g != fastest]
            orders.append([fastest] * front + mid
                          + [fastest] * (cf - front))
        seen = set()
        uniq = []
        for o in orders:
            t = tuple(o)
            if t not in seen:
                seen.add(t)
                uniq.append(o)
        orders = uniq
    return orders


def _stage_groups(cluster: ClusterSpec, pp: int) -> Optional[List[int]]:
    """Contiguously assign pp stages to groups ∝ accelerator counts.
    Returns group index per stage, or None if a group would get 0 stages
    or a non-integer accelerator share."""
    total = cluster.n_accel
    counts = []
    for g in cluster.groups:
        c = round(pp * g.n_accel / total)
        counts.append(c)
    # fix rounding to sum exactly pp
    while sum(counts) > pp:
        counts[counts.index(max(counts))] -= 1
    while sum(counts) < pp:
        counts[counts.index(min(counts))] += 1
    if any(c <= 0 for c in counts):
        return None
    out: List[int] = []
    for gi, c in enumerate(counts):
        out += [gi] * c
    return out


def _candidate_pps(cluster: ClusterSpec, n_layers: int,
                   pp_options: Optional[Sequence[int]]) -> Iterable[int]:
    if pp_options:
        return [p for p in pp_options if p <= n_layers]
    ng = len(cluster.groups)
    base = max(ng, 2)
    opts = {p for p in (2, 4, 6, 8, 10, 12, 16, 20, 24, 32)
            if base <= p <= n_layers}
    return sorted(opts)


def _group_dp(cluster: ClusterSpec, groups: List[int], tp
              ) -> Optional[List[int]]:
    """Level 2: uniform DP inside each group (groups may differ:
    microbatch sizes scale so token flow stays 1:1 per tick).

    ``tp`` is either one global width or a per-group sequence.  Only the
    (group, tp) pairs of THIS assignment are checked — an indivisible
    pair rejects this assignment alone, not the whole sweep level, so a
    cluster mixing accel_per_node=6 and =8 islands can still run tp=8 on
    the 8-accel island under a per-group assignment."""
    tps = ([tp] * len(cluster.groups) if isinstance(tp, int)
           else list(tp))
    dp_g = []
    for gi, g in enumerate(cluster.groups):
        if g.accel_per_node % tps[gi]:
            return None
        denom = tps[gi] * groups.count(gi)
        if g.n_accel % denom:
            return None
        dp_g.append(g.n_accel // denom)
    return dp_g


def _tp_assignments(cluster: ClusterSpec, tp_options: Sequence[int],
                    asymmetric: bool) -> List[Tuple[int, ...]]:
    """Level 3 candidates: one tp width per ISLAND (all stages of a group
    share it — tp lives inside a node, and a group's nodes are identical).

    ``asymmetric`` sweeps the cross product of each group's feasible
    widths (``accel_per_node`` divisibility prunes per pair); False keeps
    the legacy uniform sweep — one global width per candidate — reachable
    for A/B runs (benchmarks/bench_planner.py --asymmetric)."""
    ng = len(cluster.groups)
    if not asymmetric or ng == 1:
        return [(t,) * ng for t in tp_options]
    per_group = [[t for t in tp_options if g.accel_per_node % t == 0]
                 for g in cluster.groups]
    if any(not c for c in per_group):
        return []
    out = [()]
    for cands in per_group:
        out = [a + (t,) for a in out for t in cands]
    return out


def search(cluster: ClusterSpec, cfg: ModelConfig, *, global_batch: int,
           seq_len: int, pp_options: Optional[Sequence[int]] = None,
           tp_options: Sequence[int] = (1, 2, 4, 8),
           micro_bs_options: Sequence[int] = (1, 2),
           nonuniform: bool = True, schedule: str = "auto",
           eager_slack_options: Sequence[int] = DEFAULT_EAGER_SLACKS,
           vpp_options: Sequence[int] = (2, 3, 4),
           cp_options: Sequence[int] = (1,),
           explore_orders: bool = True, asymmetric: bool = True,
           calibration: float = 1.0, require_fit: bool = True,
           include_tp_comm: bool = True,
           cost_source: Optional[costmodel.CostSource] = None,
           baseline_plan: Optional[ParallelPlan] = None,
           engine: str = "fast") -> PlannerResult:
    """DFS over the three-level tree; returns the min-iter-time plan.

    ``cost_source`` routes every leaf's scoring through measured costs
    (repro_torch.profile.model.ProfiledCostModel) instead of the analytic
    model; None keeps the analytic default.

    ``schedule="auto"`` scores each split under strict 1f1b, 1f1b-eager
    (sweeping ``eager_slack_options``), gpipe, and interleaved-1f1b with
    vpp ∈ ``vpp_options`` — interleaved candidates get their own
    chunk-granular dp_split over pp*vpp virtual stages — and bakes the
    winner (schedule, slack, vpp, chunk layers) into the returned plan;
    pass an explicit schedule name to pin it.

    ``explore_orders`` also tries non-contiguous stage→group orders
    (fast islands at the pipeline ends); ``require_fit`` derives
    HBM-based ``max_layers`` caps from ``predictor.stage_max_layers`` so
    infeasible splits are pruned at segmentation time.

    ``asymmetric`` (fast engine only) sweeps a tp width PER ISLAND
    (HexiScale-style): each group's candidates are the ``tp_options``
    its ``accel_per_node`` divides by, stages inherit their island's
    width, and hops whose (tp, dp) disagree are charged the predictor's
    boundary-reshard cost.  False restores the legacy one-global-tp
    sweep (the uniform A/B baseline).

    ``cp_options`` (fast engine only) additionally sweeps context
    parallelism: for each cp > 1 that divides every stage's DP (and
    seq_len >= cp), candidates splitting each microbatch's sequence over
    a cp-rank ring are priced against the tp/dp/pp alternatives — with
    ``segmentation.cp_split``'s causal-triangle-balanced UNEQUAL chunk
    sizes baked into the plan.  The default ``(1,)`` adds no candidates,
    keeping the sweep (and its output) identical to a cp-less search.

    ``baseline_plan`` (fast engine only) scores an incumbent plan — e.g.
    the one currently executing — as an extra candidate under the SAME
    cost source, so a replan's winner is provably no worse than staying
    put; an incumbent that no longer maps onto the cluster (node loss
    removed its group) is skipped."""
    if engine == "reference":
        return _search_reference(
            cluster, cfg, global_batch=global_batch, seq_len=seq_len,
            pp_options=pp_options, tp_options=tp_options,
            micro_bs_options=micro_bs_options, nonuniform=nonuniform,
            schedule="1f1b" if schedule == "auto" else schedule,
            calibration=calibration, require_fit=require_fit,
            include_tp_comm=include_tp_comm, cost_source=cost_source)
    if engine != "fast":
        raise ValueError(f"unknown planner engine {engine!r}")

    src = costmodel.MemoizedCostSource(
        cost_source or costmodel.AnalyticCostSource())
    pred = PerformancePredictor(cluster, cfg, calibration,
                                include_tp_comm=include_tp_comm,
                                cost_source=src, sim_engine="fast")
    if schedule == "auto":
        scheds: List[Tuple[str, int]] = [("1f1b", 2)]
        scheds += [("1f1b-eager", k) for k in eager_slack_options]
        scheds.append(("gpipe", 2))
        vpps: Sequence[int] = vpp_options
    elif schedule == "1f1b-eager":
        # schedule pinned, slack still swept — slack is a tuning knob of
        # the eager schedule, not a different schedule
        scheds = [("1f1b-eager", k) for k in eager_slack_options]
        vpps = ()
    elif schedule == "interleaved-1f1b":
        # vpp swept for the same reason slack is for eager
        scheds = []
        vpps = vpp_options
    else:
        scheds = [(schedule, 2)]
        vpps = ()
    L = cfg.num_layers

    # ---- phase 1: enumerate candidate (placement, split) leaves cheaply,
    # with a schedule-independent lower bound each (no simulation yet).
    # Entries: (lb, tag, micro_bs, vpp, chunk_layers, stages, timings,
    # cp, cp_chunks); vpp == 1 entries are scored under ``scheds``,
    # vpp > 1 entries under interleaved-1f1b with their own chunk-granular
    # split.  cp > 1 entries carry cp-adjusted timings (bottleneck-rank
    # compute share + ring-hop cost) and their unequal chunk assignment.
    cands: List[tuple] = []
    tp_assigns = _tp_assignments(cluster, tp_options, asymmetric)
    for pp in _candidate_pps(cluster, L, pp_options):                # level 1
        for groups in _stage_group_orders(cluster, pp, explore_orders):
            for tp_g in tp_assigns:                                  # level 3
                dp_g = _group_dp(cluster, groups, tp_g)              # level 2
                if dp_g is None:
                    continue
                dp_st = [dp_g[groups[i]] for i in range(pp)]
                tp_st = [tp_g[groups[i]] for i in range(pp)]
                for micro_bs in micro_bs_options:
                    # probe plan: tick/microbatch algebra lives in ONE
                    # place (ParallelPlan); layer counts do not enter it
                    probe = ParallelPlan(
                        stages=tuple(
                            StagePlacement(group=groups[i], n_layers=1,
                                           dp=dp_st[i], tp=tp_st[i],
                                           is_last=(i == pp - 1))
                            for i in range(pp)),
                        micro_bs=micro_bs, global_batch=global_batch,
                        seq_len=seq_len)
                    if global_batch % probe.tokens_per_tick:
                        continue
                    m = probe.micro_batches
                    mbs_st = [probe.stage_micro_bs(i) for i in range(pp)]
                    coeffs = [pred.stage_coeffs(
                        groups[i], mbs_st[i], tp_st[i], dp_st[i],
                        i == pp - 1,
                        groups[i + 1] if i + 1 < pp else None, seq_len)
                        for i in range(pp)]
                    t_pl = [c.fwd_per_layer + c.bwd_per_layer
                            for c in coeffs]
                    # per-hop (tp, dp) boundary-reshard extras (zero on
                    # uniform assignments) — same layer-independent hop
                    # slot as the P2P send; last entry is the wrap hop
                    ext = pred.boundary_reshard(probe)
                    resharded = any(x > 0.0 for x in ext)
                    # HBM-derived segmentation caps (1f1b is the least
                    # memory-hungry schedule in the sweep, so its caps
                    # never exclude a split some schedule could fit;
                    # p.fits stays authoritative per schedule)
                    caps = None
                    if require_fit:
                        caps = [pred.stage_max_layers(
                            groups[i], mbs_st[i], tp_st[i], dp_st[i],
                            i, pp, m, seq_len) for i in range(pp)]
                        if min(caps) < 1 or sum(
                                min(c, L) for c in caps) < L:
                            continue     # no split of L layers can fit
                    # candidate splits (deduped; first tag wins).  With the
                    # schedule pinned to interleaved-1f1b, scheds is empty
                    # and vpp==1 candidates could never be scored — skip
                    # generating them
                    splits: Dict[Tuple[int, ...], str] = {}
                    if nonuniform and scheds:
                        # rule 1 on cost-source-derived per-stage
                        # per-layer times: with a profile these are
                        # measured, closing the nameplate-TFLOPs gap
                        offs = [c.fwd_const + c.bwd_const + c.send
                                + (ext[i] if i < pp - 1 else 0.0)
                                for i, c in enumerate(coeffs)]
                        splits[tuple(segmentation.dp_split(
                            L, t_pl, offs, max_layers=caps))] = "dp"
                        prop = segmentation.nonuniform_split(
                            L, [1.0 / t for t in t_pl])
                        prop = segmentation.rebalance(
                            prop, [t * n for t, n in zip(t_pl, prop)])
                        splits.setdefault(tuple(prop), "nonuniform")
                    if scheds:
                        splits.setdefault(
                            tuple(segmentation.uniform_split(L, pp)),
                            "uniform")
                    for split, tag in splits.items():
                        stages = tuple(
                            StagePlacement(group=groups[i],
                                           n_layers=split[i],
                                           dp=dp_st[i], tp=tp_st[i],
                                           is_last=(i == pp - 1))
                            for i in range(pp))
                        timings = [c.timing(n)
                                   for c, n in zip(coeffs, split)]
                        if resharded:
                            timings = [
                                simulator.StageTiming(
                                    fwd=t.fwd, bwd=t.bwd,
                                    send=t.send
                                    + (ext[i] if i < pp - 1 else 0.0))
                                for i, t in enumerate(timings)]
                        base = ParallelPlan(
                            stages=stages, micro_bs=micro_bs,
                            global_batch=global_batch, seq_len=seq_len)
                        lb = fastsim.lower_bound(
                            timings, m, pred.dp_allreduce_time(base))
                        cands.append((lb, tag, micro_bs, 1, None,
                                      stages, timings, 1, None))
                    # interleaved-1f1b: chunk-granular min-bottleneck
                    # split over pp*vpp virtual stages (its own layer
                    # assignment — finer chunks re-balance differently)
                    for vpp in vpps:
                        cand = _interleaved_candidate(
                            pred, cluster, cfg, groups, dp_st, tp_st,
                            micro_bs, m, mbs_st, coeffs, t_pl, ext,
                            caps, L, vpp, global_batch, seq_len)
                        if cand is not None:
                            cands.append(cand)
                    # context parallelism: a cp-rank ring per data group
                    # splits each microbatch's sequence into unequal
                    # chunks; own probe algebra (micro_batches grows
                    # x cp) and cp-adjusted timings
                    if scheds:
                        for cp in cp_options:
                            if cp > 1:
                                cands += _cp_candidates(
                                    pred, cfg, groups, dp_st, tp_st,
                                    micro_bs, L, cp, global_batch,
                                    seq_len, nonuniform, require_fit)

    # ---- phase 2: best-first scoring with lower-bound pruning — sorting
    # by bound finds a near-optimal plan early, after which candidates
    # whose *bound* already exceeds it are provably non-winners
    cands.sort(key=lambda c: c[0])
    best: Optional[Tuple[Prediction, ParallelPlan]] = None
    log: List[Tuple[str, float]] = []
    evaluated = 0
    pruned = 0
    baseline_time: Optional[float] = None
    if baseline_plan is not None:
        try:
            p = pred.predict(baseline_plan)
        except (IndexError, ValueError):
            p = None   # incumbent doesn't map onto this cluster anymore
        if p is not None:
            evaluated += 1
            log.append((f"baseline {baseline_plan.describe()}", p.iter_time))
            # an incumbent that fails require_fit is not a plan anyone can
            # stay on: score it for the log, but record no baseline_time —
            # expected_gain stays None and the min-gain gate passes (there
            # is nothing to stay put on), instead of an infeasible
            # incumbent's time blocking the migration away from itself
            if not (require_fit and not p.fits):
                baseline_time = p.iter_time
                best = (p, baseline_plan)   # also seeds the pruning cutoff
    for (lb, tag, micro_bs, vpp, chunk_layers, stages, timings,
         cp, cp_chunks) in cands:
        if best is not None and lb >= best[0].iter_time:
            pruned += 1
            continue
        cand_scheds = (scheds if vpp == 1
                       else [("interleaved-1f1b", 2)])
        for sched, slack in cand_scheds:
            if best is not None and lb >= best[0].iter_time:
                break
            plan = ParallelPlan(stages=stages, micro_bs=micro_bs,
                                global_batch=global_batch, seq_len=seq_len,
                                schedule=sched, eager_slack=slack,
                                vpp=vpp, chunk_layers=chunk_layers,
                                cp=cp, cp_chunks=cp_chunks)
            p = pred.predict(plan, timings=timings)
            evaluated += 1
            log.append((f"{tag} {plan.describe()}", p.iter_time))
            if require_fit and not p.fits:
                continue
            if best is None or p.iter_time < best[0].iter_time:
                best = (p, plan)

    if best is None:
        raise RuntimeError("planner found no feasible plan (memory/divisibility)")
    return PlannerResult(plan=best[1], prediction=best[0],
                         evaluated=evaluated, log=tuple(log),
                         pruned=pruned, baseline_time=baseline_time)


def _interleaved_candidate(pred: PerformancePredictor, cluster: ClusterSpec,
                           cfg: ModelConfig, groups: List[int],
                           dp_st: List[int], tp_st: List[int],
                           micro_bs: int, m: int,
                           mbs_st: List[int], coeffs, t_pl: List[float],
                           ext: List[float],
                           caps: Optional[List[int]], L: int, vpp: int,
                           global_batch: int, seq_len: int
                           ) -> Optional[tuple]:
    """One interleaved-1f1b phase-1 candidate: chunk-granular dp_split
    over the pp*vpp virtual stages (per-chunk per-layer time = the host
    stage's; offsets = per-hop P2P sends incl. the pp-1 -> 0 wrap, the
    per-hop boundary-reshard extras ``ext``, and the final chunk's
    unembedding), virtual timings, and its lower bound.
    Returns None when vpp doesn't fit (L < pp*vpp, or the HBM caps admit
    no chunk split)."""
    pp = len(groups)
    V = pp * vpp
    if L < V:
        return None
    caps_int = None
    if caps is not None:
        # per-stage caps under the interleaved memory envelope, applied
        # per chunk (loose: the binding constraint is the per-stage sum,
        # which p.fits enforces post-scoring)
        caps_int = [pred.stage_max_layers(
            groups[i], mbs_st[i], tp_st[i], dp_st[i], i, pp, m, seq_len,
            schedule="interleaved-1f1b", vpp=vpp) for i in range(pp)]
        if min(caps_int) < 1 or sum(
                min(c * vpp, L) for c in caps_int) < L:
            return None
    wrap = (pred.p2p_time(groups[-1], groups[0], mbs_st[-1], seq_len)
            if pp > 1 else 0.0)
    t_v = [t_pl[i] for c in range(vpp) for i in range(pp)]
    off_v = []
    for vs in range(V):
        i = vs % pp
        if vs == V - 1:
            off_v.append(coeffs[i].fwd_const + coeffs[i].bwd_const)
        elif i == pp - 1:
            off_v.append(wrap + ext[i])
        else:
            off_v.append(coeffs[i].send + ext[i])
    caps_v = ([caps_int[vs % pp] for vs in range(V)]
              if caps_int is not None else None)
    chunk = segmentation.dp_split(L, t_v, off_v, max_layers=caps_v)
    split = [sum(chunk[c * pp + i] for c in range(vpp))
             for i in range(pp)]
    stages = tuple(
        StagePlacement(group=groups[i], n_layers=split[i], dp=dp_st[i],
                       tp=tp_st[i], is_last=(i == pp - 1))
        for i in range(pp))
    plan = ParallelPlan(stages=stages, micro_bs=micro_bs,
                        global_batch=global_batch, seq_len=seq_len,
                        schedule="interleaved-1f1b", vpp=vpp,
                        chunk_layers=tuple(chunk))
    timings = pred.virtual_timings(plan, coeffs)
    lb = fastsim.lower_bound(timings, m, pred.dp_allreduce_time(plan),
                             vpp=vpp)
    return (lb, f"dp-vpp{vpp}", micro_bs, vpp, tuple(chunk), stages,
            timings, 1, None)


def _cp_candidates(pred: PerformancePredictor, cfg: ModelConfig,
                   groups: List[int], dp_st: List[int], tp_st: List[int],
                   micro_bs: int, L: int, cp: int, global_batch: int,
                   seq_len: int, nonuniform: bool, require_fit: bool
                   ) -> List[tuple]:
    """Phase-1 candidates for one cp width on one placement: each data
    group's DP splits into (dp/cp) groups of cp-rank rings, a ring
    collectively consuming one microbatch split on the sequence axis into
    ``segmentation.cp_split``'s causal-triangle-balanced unequal chunks.
    The tick algebra changes (micro_batches grows x cp), so the probe,
    per-stage microbatch sizes, memory caps, and layer split are all
    re-derived here rather than reusing the cp=1 loop's; timings go
    through the predictor's ``_cp_adjust`` seam — the same pricing
    ``predict`` applies — so the lower bound stays a true bound on the
    simulated time.  Empty when cp doesn't divide every stage's DP, the
    tick doesn't divide the batch, or no split fits."""
    pp = len(groups)
    if seq_len < cp or any(d % cp for d in dp_st):
        return []
    attn_f = costmodel.attention_flops_fraction(cfg, seq_len)
    # per-token objective: lin + attn * prefix_end, with the attention
    # share growing along the causal triangle (cp_split docstring)
    chunks = tuple(segmentation.cp_split(
        seq_len, cp, attn=attn_f / seq_len, lin=1.0 - attn_f))
    probe = ParallelPlan(
        stages=tuple(
            StagePlacement(group=groups[i], n_layers=1, dp=dp_st[i],
                           tp=tp_st[i], is_last=(i == pp - 1))
            for i in range(pp)),
        micro_bs=micro_bs, global_batch=global_batch, seq_len=seq_len,
        cp=cp, cp_chunks=chunks)
    if global_batch % probe.tokens_per_tick:
        return []
    m = probe.micro_batches
    mbs_st = [probe.stage_micro_bs(i) for i in range(pp)]
    coeffs = [pred.stage_coeffs(
        groups[i], mbs_st[i], tp_st[i], dp_st[i], i == pp - 1,
        groups[i + 1] if i + 1 < pp else None, seq_len)
        for i in range(pp)]
    adj = [pred._cp_adjust(coeffs[i], probe, i) for i in range(pp)]
    ext = pred.boundary_reshard(probe)
    resharded = any(x > 0.0 for x in ext)
    caps = None
    if require_fit:
        # activation residency scales with the longest RESIDENT chunk,
        # not the full sequence — cap layers at the cp-effective length
        # (loose either way: p.fits stays authoritative per schedule)
        eff_seq = max(chunks)
        caps = [pred.stage_max_layers(
            groups[i], mbs_st[i], tp_st[i], dp_st[i], i, pp, m, eff_seq)
            for i in range(pp)]
        if min(caps) < 1 or sum(min(c, L) for c in caps) < L:
            return []
    t_pl = [c.fwd_per_layer + c.bwd_per_layer for c in adj]
    splits: Dict[Tuple[int, ...], str] = {}
    if nonuniform:
        offs = [c.fwd_const + c.bwd_const + c.send
                + (ext[i] if i < pp - 1 else 0.0)
                for i, c in enumerate(adj)]
        splits[tuple(segmentation.dp_split(
            L, t_pl, offs, max_layers=caps))] = f"dp-cp{cp}"
    splits.setdefault(tuple(segmentation.uniform_split(L, pp)),
                      f"uniform-cp{cp}")
    out: List[tuple] = []
    for split, tag in splits.items():
        stages = tuple(
            StagePlacement(group=groups[i], n_layers=split[i],
                           dp=dp_st[i], tp=tp_st[i],
                           is_last=(i == pp - 1))
            for i in range(pp))
        timings = [c.timing(n) for c, n in zip(adj, split)]
        if resharded:
            timings = [
                simulator.StageTiming(
                    fwd=t.fwd, bwd=t.bwd,
                    send=t.send + (ext[i] if i < pp - 1 else 0.0))
                for i, t in enumerate(timings)]
        base = ParallelPlan(stages=stages, micro_bs=micro_bs,
                            global_batch=global_batch, seq_len=seq_len,
                            cp=cp, cp_chunks=chunks)
        lb = fastsim.lower_bound(timings, m, pred.dp_allreduce_time(base))
        out.append((lb, tag, micro_bs, 1, None, stages, timings,
                    cp, chunks))
    return out


# ---------------------------------------------------------------------------
# Reference engine: the pre-fastsim planner, kept verbatim as the baseline
# for benchmarks/bench_planner.py and the fast-vs-reference equivalence
# tests.  Event-driven simulator, uncached cost reads, one schedule, and
# the nameplate-TFLOPs non-uniform heuristic.
# ---------------------------------------------------------------------------
def _search_reference(cluster: ClusterSpec, cfg: ModelConfig, *,
                      global_batch: int, seq_len: int,
                      pp_options: Optional[Sequence[int]],
                      tp_options: Sequence[int],
                      micro_bs_options: Sequence[int],
                      nonuniform: bool, schedule: str,
                      calibration: float, require_fit: bool,
                      include_tp_comm: bool,
                      cost_source: Optional[costmodel.CostSource]
                      ) -> PlannerResult:
    pred = PerformancePredictor(cluster, cfg, calibration,
                                include_tp_comm=include_tp_comm,
                                cost_source=cost_source,
                                sim_engine="reference")
    best: Optional[Tuple[Prediction, ParallelPlan]] = None
    log: List[Tuple[str, float]] = []
    evaluated = 0

    for pp in _candidate_pps(cluster, cfg.num_layers, pp_options):  # level 1
        groups = _stage_groups(cluster, pp)
        if groups is None:
            continue
        for tp in tp_options:                                        # level 3
            dp_g = _group_dp(cluster, groups, tp)                    # level 2
            if dp_g is None:
                continue
            for micro_bs in micro_bs_options:
                lcm = 1
                for d in dp_g:
                    lcm = math.lcm(lcm, d)
                tick = micro_bs * lcm
                if global_batch % tick:
                    continue

                def eval_split(split: List[int], tag: str):
                    nonlocal best, evaluated
                    stages = tuple(
                        StagePlacement(group=groups[i], n_layers=split[i],
                                       dp=dp_g[groups[i]], tp=tp,
                                       is_last=(i == pp - 1))
                        for i in range(pp))
                    plan = ParallelPlan(stages=stages, micro_bs=micro_bs,
                                        global_batch=global_batch,
                                        seq_len=seq_len, schedule=schedule)
                    p = pred.predict(plan)
                    evaluated += 1
                    log.append((f"{tag} {plan.describe()}", p.iter_time))
                    if require_fit and not p.fits:
                        return
                    if best is None or p.iter_time < best[0].iter_time:
                        best = (p, plan)

                eval_split(segmentation.uniform_split(cfg.num_layers, pp),
                           "uniform")
                if nonuniform:
                    # per-stage speed = dp * per-accel effective TFLOPs
                    # (stage microbatch shrinks with dp, so both count)
                    speeds = [dp_g[groups[i]]
                              * cluster.groups[groups[i]].device.effective_tflops
                              for i in range(pp)]
                    split = segmentation.nonuniform_split(cfg.num_layers,
                                                          speeds)
                    # rule 1 refinement against simulated per-layer times
                    per_layer_t = [1.0 / s for s in speeds]
                    split = segmentation.rebalance(
                        split, [t * l for t, l in zip(per_layer_t, split)])
                    eval_split(split, "nonuniform")

    if best is None:
        raise RuntimeError("planner found no feasible plan (memory/divisibility)")
    return PlannerResult(plan=best[1], prediction=best[0],
                         evaluated=evaluated, log=tuple(log))


# ----------------------------------------------------------- serving -------
@dataclasses.dataclass(frozen=True)
class ServingPrediction:
    """What the serving planner expects of a placement: first-token and
    per-output-token latencies, the sustainable request rate, per-role
    peak memory, and the normalized SLO score max(ttft/slo, tpot/slo)
    (<= 1 means both budgets are met)."""
    ttft_s: float
    tpot_s: float
    request_capacity: float    # req/s the placement sustains
    slo_score: float
    prefill_mem_gb: float
    decode_mem_gb: float
    fits: bool

    def to_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class ServingPlanResult:
    plan: ServingPlan
    predicted: ServingPrediction
    evaluated: int
    log: Tuple[Tuple[str, float], ...]  # (plan description, slo_score)


def _decode_step_time(pred: PerformancePredictor, group: int, cfg: ModelConfig,
                      batch: int, tp: int, max_len: int) -> float:
    """One continuous-batching decode step on ``group``: the max of the
    compute roofline (1 token x batch through the stack, CostSource-aware
    via stage_coeffs at seq_len=1) and the HBM roofline — decode streams
    the whole parameter set plus the live KV/state cache every step, which
    is what makes a memory-bandwidth-rich island win the decode role."""
    c = pred.stage_coeffs(group, batch, tp, 1, True, None, 1)
    compute = c.fwd_per_layer * cfg.num_layers + c.fwd_const
    lc = pred.src.layer_cost(cfg, max_len)
    # cache occupancy averages half max_len over a sequence's lifetime
    kv = costmodel.kv_cache_bytes(cfg, batch, max_len) / 2.0
    stream_bytes = (lc.param_bytes * cfg.num_layers + kv) / tp
    hbm_bw = pred.cluster.groups[group].device.hbm_gbps * 1e9
    return max(compute, stream_bytes / hbm_bw)


def plan_serving(cluster: ClusterSpec, cfg: ModelConfig, *,
                 slo: ServingSLO, traffic: TrafficProfile,
                 max_len: Optional[int] = None,
                 tp_options: Sequence[int] = (1, 2, 4, 8),
                 decode_batch_options: Sequence[int] = (4, 8, 16, 32, 64),
                 calibration: float = 1.0, include_tp_comm: bool = True,
                 cost_source: Optional[costmodel.CostSource] = None,
                 require_fit: bool = True,
                 transport: str = "gpu") -> ServingPlanResult:
    """Search disaggregated prefill/decode placements under the latency
    SLO — the serving analogue of ``search``.

    Candidates assign the prefill role to one island and the decode role
    to another (or the same — colocated), sweeping per-role tp and the
    continuous-batching slot count.  Prefill time reuses the training
    predictor's ``stage_coeffs`` (so a ``ProfiledCostModel``'s measured
    per-layer wall times drive it); decode steps are scored on the HBM
    roofline (``_decode_step_time``).  Disaggregated candidates pay the
    prompt KV-cache transfer over the boundary link inside TTFT;
    colocated candidates pay a prefill-interference duty cycle on TPOT.
    Feasibility = per-role ``peak_memory(serve=...)`` fit (when
    ``require_fit``) + request-rate capacity >= the traffic's offered
    rate.  The winner minimizes (SLO violated?, slo_score, -capacity):
    every SLO-meeting plan beats every violating one, then the lowest
    normalized latency wins, capacity breaking ties."""
    if max_len is None:
        max_len = traffic.prompt_len + traffic.gen_len
    if traffic.prompt_len + traffic.gen_len > max_len:
        raise ValueError(
            f"max_len={max_len} < prompt_len + gen_len = "
            f"{traffic.prompt_len + traffic.gen_len}")
    src = costmodel.MemoizedCostSource(
        cost_source or costmodel.AnalyticCostSource())
    pred = PerformancePredictor(cluster, cfg, calibration=calibration,
                                include_tp_comm=include_tp_comm,
                                cost_source=src, sim_engine="fast")
    P, G = traffic.prompt_len, traffic.gen_len
    best = None
    evaluated = 0
    log: List[Tuple[str, float]] = []
    for pg, pgroup in enumerate(cluster.groups):
        for tp_p in tp_options:
            if pgroup.accel_per_node % tp_p or tp_p > pgroup.n_accel:
                continue
            c = pred.stage_coeffs(pg, 1, tp_p, 1, True, None, P)
            t_prefill = c.fwd_per_layer * cfg.num_layers + c.fwd_const
            n_prefill = pgroup.n_accel // tp_p
            mem_p = pred.peak_memory(
                ParallelPlan(stages=(StagePlacement(
                    pg, cfg.num_layers, 1, tp_p, is_last=True),),
                    micro_bs=1, global_batch=1, seq_len=P,
                    transport=transport),
                serve=ServeLoad(batch=1, max_len=P, act_tokens=P))[0]
            fits_p = mem_p < pgroup.device.hbm_gb
            for dg, dgroup in enumerate(cluster.groups):
                for tp_d in tp_options:
                    if dgroup.accel_per_node % tp_d or tp_d > dgroup.n_accel:
                        continue
                    for B in decode_batch_options:
                        evaluated += 1
                        t_step = _decode_step_time(pred, dg, cfg, B, tp_d,
                                                   max_len)
                        mem_d = pred.peak_memory(
                            ParallelPlan(stages=(StagePlacement(
                                dg, cfg.num_layers, 1, tp_d, is_last=True),),
                                micro_bs=1, global_batch=1, seq_len=max_len,
                                transport=transport),
                            serve=ServeLoad(batch=B, max_len=max_len,
                                            act_tokens=B))[0]
                        fits = fits_p and mem_d < dgroup.device.hbm_gb
                        if pg == dg:
                            # colocated: the island time-shares both roles;
                            # prefill steals a duty-cycle fraction of
                            # decode throughput and first tokens queue
                            # behind the running decode step
                            n_rep = dgroup.n_accel // max(tp_p, tp_d)
                            duty = min(traffic.request_rate * t_prefill
                                       / max(n_rep, 1), 0.95)
                            ttft = t_prefill + t_step
                            tpot = t_step / (1.0 - duty)
                            cap_pf = n_rep / t_prefill
                            cap_dec = n_rep * B / (t_step * G) * (1.0 - duty)
                        else:
                            # disaggregated: prompt KV migrates over the
                            # boundary link into the decode island's cache
                            n_dec = dgroup.n_accel // tp_d
                            kv_prompt = costmodel.kv_cache_bytes(
                                cfg, 1, min(P, max_len))
                            bw = src.link_gbps(cluster, pg, dg, transport)
                            ttft = (t_prefill
                                    + kv_prompt / (bw * GBPS))
                            tpot = t_step
                            cap_pf = n_prefill / t_prefill
                            cap_dec = n_dec * B / (t_step * G)
                        capacity = min(cap_pf, cap_dec)
                        slo_score = max(ttft / slo.ttft_s, tpot / slo.tpot_s)
                        plan = ServingPlan(
                            prefill_group=pg, prefill_tp=tp_p,
                            decode_group=dg, decode_tp=tp_d,
                            decode_batch=B, max_len=max_len,
                            transport=transport)
                        log.append((plan.describe(), slo_score))
                        if require_fit and not fits:
                            continue
                        if capacity < traffic.request_rate:
                            continue
                        p = ServingPrediction(
                            ttft_s=ttft, tpot_s=tpot,
                            request_capacity=capacity,
                            slo_score=slo_score,
                            prefill_mem_gb=mem_p, decode_mem_gb=mem_d,
                            fits=fits)
                        key = (slo_score > 1.0, slo_score, -capacity)
                        if best is None or key < best[0]:
                            best = (key, plan, p)
    if best is None:
        raise RuntimeError(
            "plan_serving found no feasible placement (memory fit or "
            "request-rate capacity); relax the SLO, shrink the traffic "
            "profile, or disable require_fit")
    return ServingPlanResult(plan=best[1], predicted=best[2],
                             evaluated=evaluated, log=tuple(log))
