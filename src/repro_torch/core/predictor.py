"""Distributed performance predictor (paper §3.2).

The port's copy of ``repro/core/predictor.py``: the same arithmetic in the
same order, held exactly equal to it by ``tests/test_torch_planner.py``.

Combines a cost source (analytic by default, or a measured profile via
repro_torch.profile.model.ProfiledCostModel) with the ICCL transport models and
the workload simulator to predict iteration time, throughput (Eq.1 TGS),
MFU (Eq.2) and peak memory for a candidate ParallelPlan on a ClusterSpec —
without touching the cluster.

Every stage's fwd/bwd time is *linear in its layer count*: measured
per-layer wall time (or analytic per-layer FLOPs / effective TFLOP/s, plus
per-layer TP all-reduce) times n_layers, plus a constant (last stage's
unembedding); the boundary P2P send is layer-independent (paper Eq.3).
``stage_coeffs`` exposes that linear form directly — the planner scores a
new layer split as pp multiply-adds instead of re-deriving costs — and is
cached per (group, micro_bs, tp, dp, is_last, next_group): the planner's
leaves repeat a handful of such keys thousands of times.

``sim_engine`` picks the pipeline simulator: "fast" routes through the
vectorized recurrences in repro_torch.core.fastsim, "reference" replays the
event-driven oracle in repro_torch.core.simulator (exact but O(m·pp²);
kept for benchmarks and equivalence tests).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core import costmodel, fastsim, simulator
from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.plan import ParallelPlan
from repro_torch.models.config import ModelConfig

GBPS = 1e9 / 8.0  # Gb/s -> bytes/s


@dataclasses.dataclass(frozen=True)
class StageCoeffs:
    """fwd = fwd_per_layer * n_layers + fwd_const (bwd likewise); ``send``
    is the boundary P2P time to the next stage (0 for the last)."""
    fwd_per_layer: float
    fwd_const: float
    bwd_per_layer: float
    bwd_const: float
    send: float

    def timing(self, n_layers: int) -> simulator.StageTiming:
        return simulator.StageTiming(
            fwd=self.fwd_per_layer * n_layers + self.fwd_const,
            bwd=self.bwd_per_layer * n_layers + self.bwd_const,
            send=self.send)


@dataclasses.dataclass(frozen=True)
class ServeLoad:
    """Inference-time memory load for ``peak_memory(serve=...)``:
    ``batch`` concurrent sequences of up to ``max_len`` tokens resident in
    the decode cache, plus ``act_tokens`` live forward tokens (the prompt
    length for a prefill stage, the decode batch for a decode stage)."""
    batch: int
    max_len: int
    act_tokens: int


@dataclasses.dataclass(frozen=True)
class Prediction:
    iter_time: float
    tgs: float                 # tokens / accelerator / second (paper Eq.1)
    mfu: float                 # paper Eq.2 against mean peak TFLOPs
    theoretical_mfu: float     # cluster upper bound (Fig.7 definition)
    bubble_frac: float
    stage_times_fwd: Tuple[float, ...]
    peak_mem_gb: Tuple[float, ...]
    fits: bool
    schedule: str = "1f1b"
    eager_slack: int = 2
    vpp: int = 1             # virtual stages per physical stage (interleaved)

    @property
    def mfu_of_bound(self) -> float:
        return self.mfu / self.theoretical_mfu


class PerformancePredictor:
    """include_tp_comm=False when DeviceType.mfu is calibrated from
    *achieved* homogeneous throughput (paper Fig.6/7/8): the measured MFU
    already absorbs intra-node TP overhead, so the simulator only adds the
    overheads heterogeneity introduces (bubble, inter-stage P2P, DP).

    ``cost_source`` decides where layer costs, comm volumes and link
    bandwidths come from: the analytic model (default) or a measured
    profile.  When the source serves a measured per-layer wall time for a
    stage's device, that time is used directly (it already includes TP
    overhead and kernel-fusion effects); otherwise FLOPs are divided by
    effective TFLOP/s as before."""

    def __init__(self, cluster: ClusterSpec, cfg: ModelConfig,
                 calibration: float = 1.0, include_tp_comm: bool = True,
                 cost_source: Optional[costmodel.CostSource] = None,
                 sim_engine: str = "fast"):
        if sim_engine not in ("fast", "reference"):
            raise ValueError(f"unknown sim_engine {sim_engine!r}")
        self.cluster = cluster
        self.cfg = cfg
        self.calibration = calibration
        self.include_tp_comm = include_tp_comm
        self.src = cost_source or costmodel.AnalyticCostSource()
        self.sim_engine = sim_engine
        # reference mode re-derives every leaf from the cost source, like
        # the pre-fastsim planner did — no coefficient caching
        self._memo = sim_engine == "fast"
        self._coeffs: Dict[tuple, StageCoeffs] = {}
        self._dp_coeffs: Dict[tuple, float] = {}

    # ---------------------------------------------------------- pieces ----
    def stage_coeffs(self, group: int, mbs: int, tp: int, dp: int,
                     is_last: bool, next_group: Optional[int],
                     seq_len: int, transport: str = "gpu") -> StageCoeffs:
        key = (group, mbs, tp, dp, is_last, next_group, seq_len, transport)
        if self._memo:
            hit = self._coeffs.get(key)
            if hit is not None:
                return hit
        g = self.cluster.groups[group]
        tokens = mbs * seq_len
        eff = g.device.effective_tflops * 1e12 * tp
        measured = self.src.layer_time(g.device.name, self.cfg,
                                       seq_len, mbs, tp)
        if measured is not None:
            # profiled path: wall time per layer already includes TP comm
            f_pl, b_pl = measured
            f_c = b_c = 0.0
            if is_last:
                emb = self.src.embedding_flops(self.cfg) * tokens / eff
                f_c, b_c = emb, 2.0 * emb
        else:
            lc = self.src.layer_cost(self.cfg, seq_len)
            # HLO-derived flops already embed the remat/redundancy factor
            # the scalar knob models — never apply both
            cal = (1.0 if self.src.flops_calibrated(self.cfg, seq_len)
                   else self.calibration)
            f_pl = cal * lc.flops_fwd * tokens / eff
            # TP all-reduce: 2/layer fwd, ring factor 2(tp-1)/tp, NVLink-class
            if tp > 1 and self.include_tp_comm:
                vol = self.src.comm_volume(self.cfg, mbs, seq_len,
                                           1, dp).tp_per_layer
                ring = 2.0 * (tp - 1) / tp
                f_pl += 2 * vol * ring / (g.intra_node_gbps * GBPS)
            f_c = (cal * self.src.embedding_flops(self.cfg) * tokens / eff
                   if is_last else 0.0)
            b_pl, b_c = 2.0 * f_pl, 2.0 * f_c
        # P2P send to next stage (paper Eq.3 volume over the boundary link)
        if next_group is not None:
            bw = self.src.link_gbps(self.cluster, group, next_group,
                                    transport)
            vol = self.src.comm_volume(self.cfg, mbs, seq_len, 1, dp).pp_p2p
            send = vol / (bw * GBPS)
        else:
            send = 0.0
        out = StageCoeffs(fwd_per_layer=f_pl, fwd_const=f_c,
                          bwd_per_layer=b_pl, bwd_const=b_c, send=send)
        if self._memo:
            self._coeffs[key] = out
        return out

    def plan_coeffs(self, plan: ParallelPlan) -> List[StageCoeffs]:
        return [self._cp_adjust(self.stage_coeffs(
            st.group, plan.stage_micro_bs(i), st.tp, st.dp, st.is_last,
            plan.stages[i + 1].group if i + 1 < plan.pp else None,
            plan.seq_len, plan.transport), plan, i)
            for i, st in enumerate(plan.stages)]

    # ------------------------------------------------ context parallelism --
    def cp_scales(self, plan: ParallelPlan) -> Tuple[float, float]:
        """(compute, linear) bottleneck-rank fractions of a stage's
        cp-ring: ring rank r holds ``c_r`` tokens and — under causal ring
        attention — attends to the ``b_r``-token prefix ending at its
        chunk, so its share of the stage's per-layer work is

            (1 - attn_f) * c_r / S  +  attn_f * c_r * b_r / sum(c_j * b_j)

        with ``attn_f`` the KV-scaling FLOPs fraction
        (``costmodel.attention_flops_fraction``).  The stage's per-layer
        wall time is the max over ranks (everyone waits for the ring's
        bottleneck).  The linear scale ``max_r c_r / S`` prices per-token
        work that does not ride the ring (unembedding, boundary send).
        Exactly (1.0, 1.0) at cp=1, keeping cp=1 plans byte-identical."""
        if plan.cp == 1:
            return 1.0, 1.0
        key = ("cps", plan.seq_len, plan.cp, plan.cp_chunk_sizes)
        if self._memo:
            hit = self._dp_coeffs.get(key)
            if hit is not None:
                return hit
        chunks = plan.cp_chunk_sizes
        S = float(plan.seq_len)
        attn_f = costmodel.attention_flops_fraction(self.cfg, plan.seq_len)
        ends, b = [], 0
        for c in chunks:
            b += c
            ends.append(float(b))
        denom = sum(c * e for c, e in zip(chunks, ends))
        s_comp = max((1.0 - attn_f) * c / S + attn_f * c * e / denom
                     for c, e in zip(chunks, ends))
        s_lin = max(chunks) / S
        out = (s_comp, s_lin)
        if self._memo:
            self._dp_coeffs[key] = out
        return out

    def ring_hop_time(self, plan: ParallelPlan, i: int) -> float:
        """Per-layer FORWARD ring-communication seconds of stage i's
        cp-ring: cp-1 KV-block collective-permutes per attention layer,
        each carrying the padded max chunk's K+V bytes (the backward pass
        re-streams KV and returns dKV — charged 2x by the caller).  Zero
        at cp=1."""
        if plan.cp == 1:
            return 0.0
        st = plan.stages[i]
        kinds = self.cfg.layer_kinds()
        attn_layers = sum(k == "attn" for k in kinds) / len(kinds)
        if attn_layers == 0.0:
            return 0.0
        vol = costmodel.ring_hop_bytes(self.cfg, plan.stage_micro_bs(i),
                                       max(plan.cp_chunk_sizes))
        bw = self.src.ring_hop_gbps(self.cluster, st.group)
        return attn_layers * (plan.cp - 1) * vol / (bw * GBPS)

    def _cp_adjust(self, c: StageCoeffs, plan: ParallelPlan,
                   i: int) -> StageCoeffs:
        """Project a stage's cp=1 linear coefficients onto its cp-ring:
        per-layer compute scales to the bottleneck rank's share, constants
        and the boundary send to the largest chunk's token fraction, and
        every attention layer pays the ring's KV-permute hops.  Identity
        at cp=1 (the same ``StageCoeffs`` object — bit-for-bit timings)."""
        if plan.cp == 1:
            return c
        s_comp, s_lin = self.cp_scales(plan)
        hop = self.ring_hop_time(plan, i)
        return StageCoeffs(
            fwd_per_layer=c.fwd_per_layer * s_comp + hop,
            fwd_const=c.fwd_const * s_lin,
            bwd_per_layer=c.bwd_per_layer * s_comp + 2.0 * hop,
            bwd_const=c.bwd_const * s_lin,
            send=c.send * s_lin)

    def p2p_time(self, ga: int, gb: int, mbs: int, seq_len: int,
                 transport: str = "gpu") -> float:
        """One microbatch's activation P2P time between node groups —
        the same Eq.3 volume/bandwidth the stage coefficients use; needed
        separately for interleaving's pp-1 -> 0 wrap-around hop."""
        key = ("p2p", ga, gb, mbs, seq_len, transport)
        if self._memo:
            hit = self._dp_coeffs.get(key)
            if hit is not None:
                return hit
        bw = self.src.link_gbps(self.cluster, ga, gb, transport)
        vol = self.src.comm_volume(self.cfg, mbs, seq_len, 1, 1).pp_p2p
        out = vol / (bw * GBPS)
        if self._memo:
            self._dp_coeffs[key] = out
        return out

    def reshard_time(self, ga: int, gb: int, mbs_a: int, mbs_b: int,
                     tp_a: int, tp_b: int, dp_a: int, dp_b: int,
                     seq_len: int, transport: str = "gpu") -> float:
        """Boundary resharding seconds when adjacent stages disagree on
        (tp, dp) — the cost of the all-gather + re-split the pipeline
        inserts on the pod edge (parallel/pipeline.py).  Zero when the
        placements match, so uniform plans keep their committed timings.

        tp mismatch: the sending stage all-gathers the model-sharded
        activation over its intra-node link (ring factor (tp_a-1)/tp_a of
        its microbatch volume) and the receiving stage re-splits over its
        own ((tp_b-1)/tp_b).  dp mismatch: per-replica microbatch sizes
        differ across the edge, so activations take one extra pass over
        the boundary link to regroup onto the new replica width."""
        if tp_a == tp_b and dp_a == dp_b:
            return 0.0
        key = ("reshard", ga, gb, mbs_a, mbs_b, tp_a, tp_b, dp_a, dp_b,
               seq_len, transport)
        if self._memo:
            hit = self._dp_coeffs.get(key)
            if hit is not None:
                return hit
        out = 0.0
        if tp_a != tp_b:
            vol_a = self.src.comm_volume(self.cfg, mbs_a, seq_len,
                                         1, 1).pp_p2p
            vol_b = self.src.comm_volume(self.cfg, mbs_b, seq_len,
                                         1, 1).pp_p2p
            bw_a = self.cluster.groups[ga].intra_node_gbps * GBPS
            bw_b = self.cluster.groups[gb].intra_node_gbps * GBPS
            out += (vol_a * (tp_a - 1) / tp_a / bw_a
                    + vol_b * (tp_b - 1) / tp_b / bw_b)
        if dp_a != dp_b:
            bw = self.src.link_gbps(self.cluster, ga, gb, transport)
            vol = self.src.comm_volume(self.cfg, max(mbs_a, mbs_b),
                                       seq_len, 1, 1).pp_p2p
            out += vol / (bw * GBPS)
        if self._memo:
            self._dp_coeffs[key] = out
        return out

    def boundary_reshard(self, plan: ParallelPlan) -> List[float]:
        """Per-hop resharding extras for a plan, added on top of each
        stage's P2P ``send``.  Entry i is the hop OUT of physical stage i:
        to stage i+1 for i < pp-1, and the pp-1 -> 0 wrap for the last
        entry (charged only where a wrap hop exists, i.e. interleaved
        plans).  All-zero for uniform (tp, dp) plans."""
        pp = plan.pp
        out = []
        for i in range(pp):
            j = (i + 1) % pp
            if pp == 1:
                out.append(0.0)
                continue
            a, b = plan.stages[i], plan.stages[j]
            out.append(self.reshard_time(
                a.group, b.group, plan.stage_micro_bs(i),
                plan.stage_micro_bs(j), a.tp, b.tp, a.dp, b.dp,
                plan.seq_len, plan.transport))
        return out

    def virtual_timings(self, plan: ParallelPlan,
                        coeffs: Optional[List[StageCoeffs]] = None
                        ) -> List[simulator.StageTiming]:
        """Per-VIRTUAL-stage timings for interleaved-1f1b, in virtual order
        (chunk c of stage i at index c*pp + i — the convention
        simulator/fastsim expect).  Chunk times follow the stage's linear
        coefficients on its chunk layer count; the last-stage unembedding
        constant lands on the final chunk only; sends between passes wrap
        from physical stage pp-1 back to stage 0."""
        pp = plan.pp
        vpp = plan.vpp
        V = pp * vpp
        if coeffs is None:
            coeffs = self.plan_coeffs(plan)
        vl = plan.virtual_layers
        wrap = 0.0
        if vpp > 1 and pp > 1:
            wrap = self.p2p_time(
                plan.stages[-1].group, plan.stages[0].group,
                plan.stage_micro_bs(pp - 1), plan.seq_len, plan.transport)
            if plan.cp > 1:
                # each ring rank wraps only its own chunk's activations
                wrap *= self.cp_scales(plan)[1]
        # per-hop (tp, dp) boundary resharding rides the same hop as the
        # P2P send (zero on uniform plans)
        resh = self.boundary_reshard(plan)
        out = []
        for vs in range(V):
            i = vs % pp
            c = coeffs[i]
            n = vl[vs]
            fwd = c.fwd_per_layer * n
            bwd = c.bwd_per_layer * n
            if vs == V - 1:
                fwd += c.fwd_const
                bwd += c.bwd_const
                send = 0.0
            elif i == pp - 1:
                send = wrap + resh[i]
            else:
                send = c.send + resh[i]
            out.append(simulator.StageTiming(fwd=fwd, bwd=bwd, send=send))
        return out

    def stage_timing(self, plan: ParallelPlan, i: int) -> simulator.StageTiming:
        st = plan.stages[i]
        t = self._cp_adjust(self.stage_coeffs(
            st.group, plan.stage_micro_bs(i), st.tp, st.dp, st.is_last,
            plan.stages[i + 1].group if i + 1 < plan.pp else None,
            plan.seq_len, plan.transport), plan, i).timing(st.n_layers)
        if i + 1 < plan.pp:
            nx = plan.stages[i + 1]
            extra = self.reshard_time(
                st.group, nx.group, plan.stage_micro_bs(i),
                plan.stage_micro_bs(i + 1), st.tp, nx.tp, st.dp, nx.dp,
                plan.seq_len, plan.transport)
            if extra:
                t = simulator.StageTiming(fwd=t.fwd, bwd=t.bwd,
                                          send=t.send + extra)
        return t

    def _dp_coeff(self, group: int, tp: int, dp: int,
                  seq_len: int, transport: str) -> float:
        """Per-layer gradient all-reduce seconds for a stage placement."""
        key = (group, tp, dp, seq_len, transport)
        if self._memo:
            hit = self._dp_coeffs.get(key)
            if hit is not None:
                return hit
        lc = self.src.layer_cost(self.cfg, seq_len)
        bw = self.src.link_gbps(self.cluster, group, group, transport)
        out = (lc.param_bytes / tp) * 2.0 * (dp - 1) / dp / (bw * GBPS)
        if self._memo:
            self._dp_coeffs[key] = out
        return out

    def dp_allreduce_time(self, plan: ParallelPlan) -> float:
        if plan.dp <= 1:
            return 0.0
        return max(self._dp_coeff(st.group, st.tp, st.dp, plan.seq_len,
                                  plan.transport) * st.n_layers
                   for st in plan.stages)

    def interleaved_peak_layers(self, plan: ParallelPlan,
                                trace: Optional[List[simulator.SimEvent]]
                                = None) -> List[int]:
        """Per-physical-stage peak of layer-weighted in-flight
        chunk-forwards for an interleaved plan — trace-EXACT: accounted
        from the executed schedule's event trace under this predictor's
        own timings (``trace`` reuses one already recorded by ``predict``;
        otherwise the fast DES replays the plan here).  Replaces the
        mean-chunk envelope, which mis-sized ragged ``chunk_layers``
        splits in both directions."""
        key = ("peakL", plan.stages, plan.micro_bs, plan.global_batch,
               plan.seq_len, plan.transport, plan.vpp, plan.virtual_layers,
               plan.cp, plan.cp_chunk_sizes)
        if self._memo and trace is None:
            hit = self._dp_coeffs.get(key)
            if hit is not None:
                return hit
        if trace is None:
            trace = []
            sim = (fastsim.simulate if self.sim_engine == "fast"
                   else simulator.simulate)
            sim(self.virtual_timings(plan), plan.micro_batches,
                "interleaved-1f1b", vpp=plan.vpp, trace=trace)
        out = simulator.trace_peak_layers(trace, plan.pp,
                                          plan.virtual_layers)
        if self._memo:
            self._dp_coeffs[key] = out
        return out

    def peak_memory(self, plan: ParallelPlan,
                    schedule: Optional[str] = None,
                    eager_slack: Optional[int] = None,
                    trace: Optional[List[simulator.SimEvent]] = None,
                    serve: Optional[ServeLoad] = None
                    ) -> Tuple[float, ...]:
        schedule = schedule if schedule is not None else plan.schedule
        eager_slack = (eager_slack if eager_slack is not None
                       else plan.eager_slack)
        lc = self.src.layer_cost(self.cfg, plan.seq_len)
        if serve is not None:
            # inference accounting: no optimizer states, no in-flight
            # microbatch pipeline — params + the decode KV/state cache
            # (validated bytes-exact against the registry's real cache
            # shapes, tests/test_serve.py) + live forward activations
            kv_per_layer = costmodel.kv_cache_bytes(
                self.cfg, serve.batch, serve.max_len) / self.cfg.num_layers
            return tuple(
                (lc.param_bytes * st.n_layers / st.tp
                 + kv_per_layer * st.n_layers / st.tp
                 + lc.act_bytes_per_token * serve.act_tokens / st.tp) / 1e9
                for st in plan.stages)
        # interleaved: chunk-level accounting from the executed schedule's
        # trace — the actual per-chunk in-flight mix, exact for ragged
        # chunk_layers splits (no mean-chunk approximation)
        peak_l = (self.interleaved_peak_layers(plan, trace)
                  if schedule == "interleaved-1f1b" else None)
        # context parallelism: each ring rank holds only its own chunk's
        # activations (ragged rings size for the LARGEST chunk) plus one
        # in-flight + one resident KV ring block per live attention layer
        eff_seq = (max(plan.cp_chunk_sizes) if plan.cp > 1
                   else plan.seq_len)
        out = []
        for i, st in enumerate(plan.stages):
            params = lc.param_bytes * st.n_layers / st.tp
            opt = params * (6.0 + 2.0 / st.dp)  # fp32 master+m+v ZeRO-1-ish
            per_tok = (lc.act_bytes_per_token * plan.stage_micro_bs(i)
                       * eff_seq / st.tp)
            if peak_l is not None:
                acts = per_tok * peak_l[i]
            else:
                n_mb = simulator.peak_activation_microbatches(
                    i, plan.pp, plan.micro_batches, schedule, eager_slack)
                acts = per_tok * st.n_layers * n_mb
            ring = (2.0 * costmodel.ring_hop_bytes(
                self.cfg, plan.stage_micro_bs(i), eff_seq) / st.tp
                if plan.cp > 1 else 0.0)
            out.append((params + opt + acts + ring) / 1e9)
        return tuple(out)

    def stage_max_layers(self, group: int, mbs: int, tp: int, dp: int,
                         stage: int, pp: int, m: int, seq_len: int,
                         schedule: str = "1f1b", eager_slack: int = 2,
                         vpp: int = 1) -> int:
        """Most layers a stage placement can hold inside its device HBM —
        the inverse of ``peak_memory``'s linear-in-layers model.  The
        planner feeds these as ``dp_split``/chunk-split ``max_layers`` caps
        so require_fit searches prune infeasible splits at segmentation
        time instead of post-scoring (ROADMAP: dp_split memory caps).  May
        return 0: no layer count fits."""
        lc = self.src.layer_cost(self.cfg, seq_len)
        n_mb = simulator.peak_activation_microbatches(
            stage, pp, m, schedule, eager_slack, vpp)
        per_layer = (lc.param_bytes / tp * (7.0 + 2.0 / dp)
                     + lc.act_bytes_per_token * mbs * seq_len / tp
                     * (n_mb / vpp))
        hbm = self.cluster.groups[group].device.hbm_gb * 1e9
        return int(hbm / per_layer)

    # ----------------------------------------------------------- predict --
    def predict(self, plan: ParallelPlan, schedule: Optional[str] = None,
                overlap_dp: bool = True,
                eager_slack: Optional[int] = None,
                timings: Optional[List[simulator.StageTiming]] = None
                ) -> Prediction:
        """``schedule``/``eager_slack`` default to the plan's own; pass
        ``timings`` (from ``plan_coeffs``) to skip rebuilding them when
        scoring one split under several schedules — for interleaved-1f1b
        they must be the pp*vpp VIRTUAL timings (``virtual_timings``)."""
        schedule = schedule if schedule is not None else plan.schedule
        eager_slack = (eager_slack if eager_slack is not None
                       else plan.eager_slack)
        vpp = plan.vpp if schedule == "interleaved-1f1b" else 1
        if timings is None:
            if schedule == "interleaved-1f1b":
                timings = self.virtual_timings(plan)
            else:
                timings = [self.stage_timing(plan, i)
                           for i in range(plan.pp)]
        sim = (fastsim.simulate if self.sim_engine == "fast"
               else simulator.simulate)
        # interleaved: record the executed trace during scoring and reuse
        # it for the chunk-level peak-memory accounting (one DES per leaf)
        trace = [] if schedule == "interleaved-1f1b" else None
        rep = sim(timings, plan.micro_batches, schedule,
                  dp_allreduce=self.dp_allreduce_time(plan),
                  overlap_dp=overlap_dp, eager_slack=eager_slack, vpp=vpp,
                  trace=trace)
        S = plan.n_accel
        tokens = plan.global_batch * plan.seq_len
        tgs = tokens / (S * rep.iter_time)               # Eq.1
        model_flops = self.cfg.flops_per_token(plan.seq_len) * 3.0  # fwd+bwd
        tested_tflops = tokens * model_flops / (rep.iter_time * S) / 1e12
        mfu = tested_tflops / self.cluster.peak_tflops_mean   # Eq.2
        mems = self.peak_memory(plan, schedule, eager_slack, trace=trace)
        fits = all(m < self.cluster.groups[st.group].device.hbm_gb
                   for m, st in zip(mems, plan.stages))
        return Prediction(iter_time=rep.iter_time, tgs=tgs, mfu=mfu,
                          theoretical_mfu=self.cluster.theoretical_mfu,
                          bubble_frac=rep.bubble_frac,
                          stage_times_fwd=tuple(t.fwd for t in timings),
                          peak_mem_gb=mems, fits=fits,
                          schedule=schedule, eager_slack=eager_slack,
                          vpp=vpp)
