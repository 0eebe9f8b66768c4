"""The port's planner core against the JAX package's, exactly.

``repro_torch.core`` (cluster, costmodel, segmentation, simulator,
fastsim, predictor, planner, the plan classes) and
``repro_torch.configs.llama2_paper`` are copies of the JAX package's
modules doing the same arithmetic in the same order, so every case here
builds the same inputs in both packages and holds the outputs equal with
``==``: floats, plans (``to_dict``), predictions and simulator reports,
with no tolerance.  Any difference is a fault of the copy.

The inputs are the paper presets (``paper_hetero_cluster``,
``paper_cluster_of_size``), the paper figures' arguments
(``benchmarks/fig6a_segmentation.py``, ``fig6bf_scaling.py``,
``fig7_mfu.py``, ``fig8_e2e.py``), the cp corpus of
``tests/test_schedules.py`` and the serving cluster of
``tests/test_serve.py``, plus seeded random timings and splits.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import llama2_paper as j_paper  # noqa: E402
from repro.core import cluster as j_cluster  # noqa: E402
from repro.core import costmodel as j_costmodel  # noqa: E402
from repro.core import fastsim as j_fastsim  # noqa: E402
from repro.core import plan as j_plan  # noqa: E402
from repro.core import planner as j_planner  # noqa: E402
from repro.core import predictor as j_predictor  # noqa: E402
from repro.core import segmentation as j_segmentation  # noqa: E402
from repro.core import simulator as j_simulator  # noqa: E402
from repro.models import registry as j_registry  # noqa: E402
from repro_torch.configs import llama2_paper as t_paper  # noqa: E402
from repro_torch.core import cluster as t_cluster  # noqa: E402
from repro_torch.core import costmodel as t_costmodel  # noqa: E402
from repro_torch.core import fastsim as t_fastsim  # noqa: E402
from repro_torch.core import plan as t_plan  # noqa: E402
from repro_torch.core import planner as t_planner  # noqa: E402
from repro_torch.core import predictor as t_predictor  # noqa: E402
from repro_torch.core import segmentation as t_segmentation  # noqa: E402
from repro_torch.core import simulator as t_simulator  # noqa: E402
from repro_torch.models import registry as t_registry  # noqa: E402

JAX = types.SimpleNamespace(
    paper=j_paper, cluster=j_cluster, costmodel=j_costmodel,
    fastsim=j_fastsim, plan=j_plan, planner=j_planner,
    predictor=j_predictor, segmentation=j_segmentation,
    simulator=j_simulator, registry=j_registry)
PORT = types.SimpleNamespace(
    paper=t_paper, cluster=t_cluster, costmodel=t_costmodel,
    fastsim=t_fastsim, plan=t_plan, planner=t_planner,
    predictor=t_predictor, segmentation=t_segmentation,
    simulator=t_simulator, registry=t_registry)

SEQ = 4096
CONFIGS = ("llama3-8b", "falcon-mamba-7b", "llama2-7b", "llama2-70b",
           "llama2-140b")
SCHEDULES = ("1f1b", "1f1b-eager", "gpipe", "interleaved-1f1b")


def plain(x):
    """A value both packages' results reduce to, for ``==``: dataclasses
    become (class name, fields), numpy values Python values."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: plain(getattr(x, f.name))
                 for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def same(build):
    """``build(ns)`` on the JAX package and on the port; asserts the two
    results equal and returns the port's."""
    want, got = build(JAX), build(PORT)
    assert plain(got) == plain(want)
    return got


def config(ns, name: str):
    if name in ns.paper.PAPER_MODELS:
        return ns.paper.PAPER_MODELS[name]
    return ns.registry.get_config(name)


# the paper's achieved-throughput presets of the Fig. 6/8 benchmarks
# (benchmarks/_paper.py: AMD 93.81, GPU-A 48.08 TFLOP/s a card)
def hetero_cluster(ns, n_nodes: int):
    C = ns.cluster
    amd = C.DeviceType("amd", peak_tflops=383.0, mfu=93.81 / 383.0,
                       hbm_gb=64)
    gpua = C.DeviceType("gpu-a", peak_tflops=280.0, mfu=48.08 / 280.0,
                        hbm_gb=64)
    return C.ClusterSpec(groups=(C.NodeGroup(amd, n_nodes // 6),
                                 C.NodeGroup(gpua, n_nodes - n_nodes // 6)))


def fig7_combos(ns):
    """fig7_mfu.py's three clusters and global batches."""
    C = ns.cluster
    return {
        "nvidia+A": (C.ClusterSpec(groups=(C.NodeGroup(C.NVIDIA, 6),
                                           C.NodeGroup(C.GPU_A, 6))), 640),
        "amd+B": (C.ClusterSpec(groups=(C.NodeGroup(C.AMD, 6),
                                        C.NodeGroup(C.GPU_B, 6))), 640),
        "amd+C": (C.ClusterSpec(groups=(C.NodeGroup(C.AMD, 20),
                                        C.NodeGroup(C.GPU_C, 100))), 6400),
    }


# ---------------------------------------------------------------- cluster --
@pytest.mark.parametrize("n", [None, 12, 24, 48, 96])
def test_paper_clusters(n):
    def build(ns):
        C = ns.cluster
        cl = (C.paper_hetero_cluster() if n is None
              else C.paper_cluster_of_size(n))
        links = {(a, b, t): cl.link_gbps(a, b, t) for a in range(2)
                 for b in range(2) for t in ("gpu", "cpu")}
        return (cl, cl.n_accel, cl.peak_tflops_mean, cl.theoretical_mfu,
                links)
    same(build)


def test_cluster_edits_round_trip():
    def build(ns):
        C = ns.cluster
        cl = C.paper_cluster_of_size(12)
        deg = cl.degrade("amd", 2.0).degrade("amd", 1.5)
        dev = deg.groups[0].device
        gone = deg.remove_group("amd")
        back = gone.add_group(deg.groups[0].healthy)
        node = C.NodeGroup.from_dict(deg.groups[0].to_dict())
        with pytest.raises(ValueError):
            cl.degrade("tpu", 2.0)
        with pytest.raises(ValueError):
            gone.remove_group("gpu-a")
        with pytest.raises(ValueError):
            cl.link_gbps(0, 1, "ib")
        return (deg, dev.slowdown, dev.healthy_mfu, dev.effective_tflops,
                gone, back, back.theoretical_mfu, node,
                C.DeviceType.from_dict(dev.to_dict()),
                cl.add_group(C.NodeGroup(C.NVIDIA, 3)).theoretical_mfu)
    same(build)


def test_h100_preset_is_the_ports_own():
    C = t_cluster
    assert C.H100.peak_tflops == C.NVIDIA.peak_tflops == 989.0
    assert (C.H100.hbm_gb, C.H100.hbm_gbps) == (80.0, 3350.0)
    assert 0.0 < C.H100.mfu < 1.0
    cl = C.homogeneous_cluster(C.H100, 2)
    assert cl.theoretical_mfu == pytest.approx(C.H100.mfu)
    assert not hasattr(C, "TPU_V5E")
    assert not hasattr(C, "tpu_multipod_cluster")


# -------------------------------------------------------------- costmodel --
@pytest.mark.parametrize("name", CONFIGS)
def test_costmodel_functions(name):
    def build(ns):
        cm, cfg = ns.costmodel, config(ns, name)
        cl = ns.cluster.paper_cluster_of_size(12)
        src = cm.AnalyticCostSource()
        memo = cm.MemoizedCostSource(src)
        out = []
        for seq in (1, 512, SEQ):
            out += [cm.layer_cost(cfg, seq),
                    cm.attention_flops_fraction(cfg, seq),
                    cm.comm_volume(cfg, 2, seq, 5, 4),
                    cm.calibrate(cfg, seq, None),
                    cm.calibrate(cfg, seq, 1e9),
                    cm.calibrate(cfg, seq, 1e9, allow_speedup=True),
                    memo.layer_cost(cfg, seq), memo.layer_cost(cfg, seq)]
        out += [cm.embedding_flops(cfg), cm.ring_hop_bytes(cfg, 2, 1383),
                cm.kv_cache_bytes(cfg, 8, 2048),
                src.link_gbps(cl, 0, 1, "cpu"), src.ring_hop_gbps(cl, 1),
                memo.link_gbps(cl, 0, 0), memo.ring_hop_gbps(cl, 0),
                src.layer_time("amd", cfg, SEQ, 1, 8),
                src.flops_calibrated(cfg, SEQ), memo.embedding_flops(cfg),
                memo.comm_volume(cfg, 1, SEQ, 2, 8)]
        return out
    same(build)


# ----------------------------------------------------------- segmentation --
@pytest.mark.parametrize("seed", range(4))
def test_segmentation_seeded(seed):
    rng = np.random.default_rng(seed)
    pp = int(rng.integers(2, 9))
    n = int(rng.integers(pp, 81))
    speeds = rng.uniform(0.5, 4.0, pp).tolist()
    per_layer = rng.uniform(0.1, 2.0, pp).tolist()
    caps = [n] * pp
    caps[int(rng.integers(pp))] = max(1, n // pp)
    times = rng.uniform(1.0, 5.0, pp).tolist()
    rates = rng.uniform(0.5, 2.0, 4).tolist()
    S = int(rng.integers(64, 8193))

    def build(ns):
        sg = ns.segmentation
        return [sg.uniform_split(n, pp), sg.nonuniform_split(n, speeds),
                sg.dp_split(n, per_layer), sg.dp_split(n, per_layer,
                                                       max_layers=caps),
                sg.rebalance(sg.uniform_split(n, pp), times),
                sg.cp_split(S, 4, attn=1.0 / S, lin=0.5),
                sg.cp_split(S, 4, attn=0.3 / S, lin=0.7, rates=rates),
                sg.cp_split(S, 3, attn=1.0 / S, lin=0.5, causal=False)]
    same(build)


def test_cp_split_of_the_training_slice():
    """The cp = 4 chunks the port's cp training route runs at seq 4096."""
    want = [1383, 1057, 884, 772]
    assert j_segmentation.cp_split(4096, 4, attn=1 / 4096, lin=0.5) == want
    assert t_segmentation.cp_split(4096, 4, attn=1 / 4096, lin=0.5) == want


# ------------------------------------------------------------- simulators --
def _timings(ns, rng_seed: int, n: int):
    rng = np.random.default_rng(rng_seed)
    f, b, s = (rng.uniform(0.5, 2.0, n), rng.uniform(1.0, 4.0, n),
               rng.uniform(0.0, 0.3, n))
    return [ns.simulator.StageTiming(fwd=float(f[i]), bwd=float(b[i]),
                                     send=float(s[i])) for i in range(n)]


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("seed", range(2))
def test_simulators_on_seeded_timings(schedule, seed):
    pp = 3 + seed
    vpp = 2 if schedule == "interleaved-1f1b" else 1
    m = 8

    def build(ns):
        t = _timings(ns, seed, pp * vpp)
        out = []
        for sim in (ns.simulator.simulate, ns.fastsim.simulate):
            trace = []
            out.append(sim(t, m, schedule, dp_allreduce=0.7, eager_slack=2,
                           vpp=vpp, trace=trace))
            out.append(trace)
            out.append(sim(t, m, schedule, dp_allreduce=0.7,
                           overlap_dp=False, vpp=vpp))
        out.append(ns.fastsim.lower_bound(t, m, 0.7, vpp=vpp))
        out.append([ns.simulator.peak_activation_microbatches(
            i, pp, m, schedule, 2, vpp) for i in range(pp)])
        if vpp > 1:
            out.append(ns.simulator.trace_peak_layers(
                out[1], pp, [2] * (pp * vpp)))
        return out
    same(build)


# ------------------------------------------------------------- predictor --
def _fig6a_plans(ns):
    """fig6a_segmentation.py's plans: llama2-7b on 6 nodes, every (pp, tp)
    and uniform / non-uniform split it scores."""
    cl, cfg = hetero_cluster(ns, 6), ns.paper.LLAMA2_7B
    P = ns.plan
    plans = []
    for pp, tp in ((2, 8), (4, 8), (6, 8), (8, 4), (12, 4)):
        groups = ns.planner._stage_groups(cl, pp)
        if groups is None:
            continue
        dpg = [cl.groups[g].n_accel // (tp * groups.count(g))
               if cl.groups[g].n_accel % (tp * groups.count(g)) == 0 else 0
               for g in range(2)]
        if 0 in dpg:
            continue
        speeds = [dpg[groups[i]] * cl.groups[groups[i]].device.effective_tflops
                  for i in range(pp)]
        for split in (ns.segmentation.uniform_split(cfg.num_layers, pp),
                      ns.segmentation.nonuniform_split(cfg.num_layers,
                                                       speeds)):
            plans.append(P.ParallelPlan(stages=tuple(
                P.StagePlacement(group=groups[i], n_layers=split[i],
                                 dp=dpg[groups[i]], tp=tp,
                                 is_last=(i == pp - 1))
                for i in range(pp)), micro_bs=1, global_batch=960,
                seq_len=SEQ))
    return cl, cfg, plans


def _fig8_plan(ns):
    """fig8_e2e.py's uniform pp 10 plan of llama2-70b on 96 nodes."""
    cl, P = hetero_cluster(ns, 96), ns.plan
    groups = ns.planner._stage_groups(cl, 10)
    dpg = [cl.groups[g].n_accel // (8 * groups.count(g)) for g in range(2)]
    split = ns.segmentation.uniform_split(80, 10)
    return cl, ns.paper.LLAMA2_70B, P.ParallelPlan(stages=tuple(
        P.StagePlacement(group=groups[i], n_layers=n, dp=dpg[groups[i]],
                         tp=8, is_last=(i == 9))
        for i, n in enumerate(split)), micro_bs=1, global_batch=1920,
        seq_len=SEQ)


def test_predictor_on_fig6a_plans():
    def build(ns):
        cl, cfg, plans = _fig6a_plans(ns)
        pred = ns.predictor.PerformancePredictor(cl, cfg,
                                                 include_tp_comm=False)
        out = []
        for plan in plans:
            out += [plan.to_dict(), pred.predict(plan, "1f1b-eager"),
                    pred.peak_memory(plan, "1f1b-eager"),
                    pred.plan_coeffs(plan)]
        return out
    same(build)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_predictor_on_fig8_plan(schedule):
    def build(ns):
        cl, cfg, plan = _fig8_plan(ns)
        plan = dataclasses.replace(plan, schedule=schedule,
                                   vpp=2 if "interleaved" in schedule else 1)
        out = []
        for engine in ("fast", "reference"):
            pred = ns.predictor.PerformancePredictor(
                cl, cfg, include_tp_comm=False, sim_engine=engine)
            out += [pred.predict(plan), pred.peak_memory(plan),
                    pred.dp_allreduce_time(plan),
                    pred.stage_max_layers(0, 1, 8, 16, 0, 10, 96,
                                          SEQ, schedule, 2, plan.vpp),
                    pred.peak_memory(plan, serve=ns.predictor.ServeLoad(
                        batch=8, max_len=2048, act_tokens=2048))]
        return out
    same(build)


def test_predictor_on_the_cp_corpus():
    """test_schedules.py's cp corpus: llama2-70b and -140b on the paper's
    96N768D cluster, pp 10/12, cp 2/4 with cp_split's unequal chunks."""
    def build(ns):
        cl = ns.cluster.paper_cluster_of_size(96)
        P, sg, out = ns.plan, ns.segmentation, []
        for cfg in (ns.paper.LLAMA2_70B, ns.paper.LLAMA2_140B):
            pred = ns.predictor.PerformancePredictor(cl, cfg,
                                                     include_tp_comm=False)
            attn_f = ns.costmodel.attention_flops_fraction(cfg, SEQ)
            for pp in (10, 12):
                groups = ns.planner._stage_groups(cl, pp)
                dpg = [cl.groups[g].n_accel // (8 * groups.count(g))
                       for g in range(len(cl.groups))]
                split = sg.uniform_split(cfg.num_layers, pp)
                stages = tuple(P.StagePlacement(
                    group=groups[i], n_layers=split[i], dp=dpg[groups[i]],
                    tp=8, is_last=(i == pp - 1)) for i in range(pp))
                for cp in (2, 4):
                    if any(s.dp % cp for s in stages):
                        continue
                    chunks = tuple(sg.cp_split(SEQ, cp, attn=attn_f / SEQ,
                                               lin=1.0 - attn_f))
                    for sch, vpp in (("1f1b", 1), ("interleaved-1f1b", 2)):
                        plan = P.ParallelPlan(
                            stages=stages, micro_bs=1, global_batch=960,
                            seq_len=SEQ, schedule=sch, vpp=vpp, cp=cp,
                            cp_chunks=chunks)
                        out += [plan.to_dict(), pred.predict(plan),
                                pred.cp_scales(plan),
                                pred.ring_hop_time(plan, 0)]
        assert len(out) >= 32
        return out
    same(build)


# --------------------------------------------------------------- planner --
def _result(res):
    return (res.plan.to_dict(), res.prediction, res.evaluated, res.log,
            res.pruned, res.baseline_time)


@pytest.mark.parametrize("combo", ["nvidia+A", "amd+B", "amd+C"])
def test_planner_fig7(combo):
    """fig7_mfu.py's searches: llama2-70b, the same arguments."""
    def build(ns):
        cl, G = fig7_combos(ns)[combo]
        res = ns.planner.search(
            cl, ns.paper.LLAMA2_70B, global_batch=G, seq_len=SEQ,
            pp_options=[2, 4, 6, 10, 12], tp_options=[8],
            micro_bs_options=[1], require_fit=False,
            schedule="1f1b-eager", include_tp_comm=False)
        return _result(res) + (res.prediction.mfu_of_bound,
                               res.plan.describe())
    same(build)


@pytest.mark.parametrize("name", ["llama2-7b", "llama2-70b"])
def test_planner_fig6bf_12_nodes(name):
    """fig6bf_scaling.py's search on its 12N hetero cluster."""
    def build(ns):
        res = ns.planner.search(
            hetero_cluster(ns, 12), config(ns, name), global_batch=320,
            seq_len=SEQ, pp_options=[6, 12], tp_options=[4, 8],
            micro_bs_options=[1], require_fit=False,
            schedule="1f1b-eager", include_tp_comm=False)
        return _result(res)
    same(build)


def test_planner_auto_schedule_with_fit():
    """The default search (schedule "auto": strict, eager slacks, gpipe,
    interleaved vpp) with the memory caps, on the paper's 12N cluster."""
    def build(ns):
        res = ns.planner.search(
            ns.cluster.paper_cluster_of_size(12), ns.paper.LLAMA2_70B,
            global_batch=96, seq_len=SEQ, pp_options=[4, 6],
            tp_options=[4, 8], micro_bs_options=[1, 2])
        return _result(res)
    same(build)


def test_planner_cp_sweep_on_the_cp_corpus():
    """cp_options (1, 2, 4): the 96N cluster of the cp corpus, and the
    tp-capped island at 32k tokens where the planner picks cp > 1."""
    def build(ns):
        a = ns.planner.search(
            ns.cluster.paper_cluster_of_size(96), ns.paper.LLAMA2_70B,
            global_batch=960, seq_len=SEQ, pp_options=[10, 12],
            tp_options=[8], micro_bs_options=[1], require_fit=False,
            schedule="1f1b", include_tp_comm=False, cp_options=(1, 2, 4))
        b = ns.planner.search(
            ns.cluster.homogeneous_cluster(ns.cluster.GPU_A, 8),
            ns.registry.get_config("llama3-8b"), global_batch=8,
            seq_len=32768, pp_options=[2, 4], tp_options=(1, 2),
            micro_bs_options=(1,), vpp_options=(2,), cp_options=(1, 2, 4))
        assert b.plan.cp > 1
        return _result(a) + _result(b)
    same(build)


def test_planner_reference_engine():
    """``_search_reference`` with test_fastsim.py's arguments."""
    def build(ns):
        res = ns.planner.search(
            ns.cluster.paper_cluster_of_size(12), ns.paper.LLAMA2_70B,
            global_batch=320, seq_len=SEQ, pp_options=[10, 12],
            tp_options=[8], micro_bs_options=[1], require_fit=False,
            schedule="1f1b", include_tp_comm=False, engine="reference")
        return _result(res)
    same(build)


def test_planner_baseline_plan():
    def build(ns):
        cl, cfg, plan = _fig8_plan(ns)
        res = ns.planner.search(
            cl, cfg, global_batch=1920, seq_len=SEQ, pp_options=[10],
            tp_options=[8], micro_bs_options=[1], require_fit=False,
            schedule="1f1b-eager", include_tp_comm=False,
            baseline_plan=plan)
        return _result(res) + (res.expected_gain,)
    same(build)


# ------------------------------------------------------------- serving --
def _serve_cluster(ns):
    """test_serve.py's asymmetric cluster: a compute-rich and a
    memory-bandwidth-rich island."""
    C = ns.cluster
    compute = C.DeviceType("compute-rich", peak_tflops=989.0, mfu=0.55,
                           hbm_gb=80.0, hbm_gbps=400.0)
    membw = C.DeviceType("membw-rich", peak_tflops=300.0, mfu=0.45,
                         hbm_gb=96.0, hbm_gbps=3200.0)
    return C.ClusterSpec(groups=(C.NodeGroup(compute, 2),
                                 C.NodeGroup(membw, 2)),
                         eth_gbps=400.0, eth_eff=0.9)


@pytest.mark.parametrize("traffic", [(2048, 256, 4.0), (1024, 128, 2.0)])
def test_plan_serving(traffic):
    def build(ns):
        P = ns.plan
        res = ns.planner.plan_serving(
            _serve_cluster(ns), ns.registry.get_config("llama3-8b"),
            slo=P.ServingSLO(ttft_s=0.5, tpot_s=0.05),
            traffic=P.TrafficProfile(*traffic))
        plan = res.plan
        assert P.ServingPlan.from_dict(plan.to_dict()) == plan
        return (plan.to_dict(), plan.describe(), plan.disaggregated,
                res.predicted, res.evaluated, res.log)
    same(build)


def test_serving_classes():
    def build(ns):
        P = ns.plan
        t = P.TrafficProfile(prompt_len=1000, gen_len=64, request_rate=2.5)
        with pytest.raises(ValueError):
            P.ServingPlan(0, 1, 1, 1, 8, 2048, transport="ib")
        return (P.ServingSLO(0.5, 0.05).to_dict(), t.to_dict(),
                t.prefill_decode_ratio,
                P.ServingPlan(0, 2, 1, 1, 8, 2048, "cpu").describe())
    same(build)
