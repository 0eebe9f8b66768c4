"""The port's closed loop (``repro_torch.telemetry``, the ``Trainer``'s
control plane, ``parallel/migrate.py``, the train CLI's ``--degrade``)
against the JAX package's pieces, on the CPU.

The JAX ``Trainer`` itself fails under this jax (ROADMAP.md queue C), so
the port is held against the pieces the JAX trainer composes:

  * ``StageTelemetry`` against ``repro.telemetry.StageTelemetry`` on one
    scripted clock: complete, torn and dropped-first sequences, timer
    buckets, ``MAX_FRESH``, and ``fold_into`` into the port's and JAX's
    ``ProfileStore`` (entries ``==``), over pp, vpp, m and the durations
    (hypothesis);
  * the pipeline loss's tick marks: in order, once a forward, none in the
    backward under remat, at vpp 1 and 2, the loss bit for bit the same;
  * a SMOKE 6-layer pp ``Trainer`` on the JAX e2e's cluster and (3, 3)
    plan (``tests/test_replan.py:477-511``): its store equal to JAX's
    recorder and store fed the port's durations under the JAX trainer's
    keys; ``schedule_health``'s predicted bubble, ``profiled_cost_source``
    and ``replan``'s plan and log equal to JAX's predictor, cost model and
    search; ``migrate="memory"`` and ``"checkpoint"`` bit for bit, with
    equal next losses and parameters; the straggler callback;
    ``inject_degrade``'s errors and ``obs_scale`` tags;
  * on gloo ranks (``run_ranks``): ``migrate.redistribute`` bit for bit
    against ``split_state_for_rank`` of the whole state and against
    ``restore_rank`` of a ``save_rank`` checkpoint, for (3, 1) -> (1, 3),
    pp 2 x dp 2 ZeRO-1 to another segmentation and to pp 1 x dp 4, vpp 2
    -> vpp 1 and pp 2 x tp 2; the trainer's replan on ranks, its next
    loss equal to a fresh rank trainer's on the gathered state, every
    rank's store equal, the ICCL notes unchanged, and a plan that does
    not fit the ranks present refused naming them;
  * the CLI's ``--degrade`` in one process and under ``torchrun``, and
    ``degrade_spec`` against JAX's.
"""
import argparse
import json
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import cluster as JC  # noqa: E402
from repro.core import planner as jplanner  # noqa: E402
from repro.core.plan import ParallelPlan as JPlan  # noqa: E402
from repro.core.plan import StagePlacement as JStage  # noqa: E402
from repro.core.predictor import PerformancePredictor as JPredictor  # noqa
from repro.launch import train as jtrain_cli  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.profile.model import ProfiledCostModel as JCostModel  # noqa
from repro.profile.store import ProfileStore as JStore  # noqa: E402
from repro.telemetry import recorder as jrec  # noqa: E402
from repro_torch.core import cluster as C  # noqa: E402
from repro_torch.core.plan import ParallelPlan, StagePlacement  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.parallel import pipeline as tpp  # noqa: E402
from repro_torch.parallel import rank_programs  # noqa: E402
from repro_torch.parallel.launch import run_ranks  # noqa: E402
from repro_torch.parallel.sharding import ShardingRules  # noqa: E402
from repro_torch.profile.model import ProfiledCostModel  # noqa: E402
from repro_torch.profile.store import ProfileStore  # noqa: E402
from repro_torch.telemetry import recorder as trec  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 120
F32_TOL = 2e-5
SEARCH_KW = dict(pp_options=[2], tp_options=[1], micro_bs_options=[1, 2],
                 require_fit=False, include_tp_comm=False)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's in-process port code (SMOKE
    sizes gain nothing from more), so that test workers running side by
    side do not oversubscribe the host's cores; restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------- the recorder ----
def _entries(store):
    """(device kind, op, shape, value, trust meta) of every entry: what
    two stores must agree on (the timestamp and framework stamps differ)."""
    return sorted(
        (e.device_kind, e.op, json.dumps(e.shape, sort_keys=True),
         json.dumps(e.value, sort_keys=True),
         e.meta.get("telemetry"), e.meta.get("provenance"))
        for e in store.entries())


def _fold_kw(pp, vpp, m, rng):
    V = pp * vpp
    vl = [int(x) for x in rng.integers(0, 4, V)]
    lmax = max(max(vl), 1)
    return dict(arch="a", seq_len=32, tp=1, schedule="1f1b",
                layers_per_vstage=vl, padded_per_stage=[vpp * lmax] * pp,
                micro_bs_per_stage=[int(x) for x in rng.integers(1, 3, pp)],
                stage_scale=[float(x) for x in rng.uniform(0.5, 4, pp)],
                stage_obs_scale=[float(x) for x in rng.uniform(1, 4, pp)])


def _drive(rec, script, via_now):
    """Feed ``rec`` the (tick, time) marks of ``script``: JAX's reads the
    scripted host clock; the port's takes them as ``now`` (the card's
    path) or from the same scripted clock."""
    for t, now in script:
        if via_now:
            rec.on_tick(t, now=now)
        else:
            with mock.patch.object(jrec.time, "perf_counter",
                                   return_value=now):
                rec.on_tick(t)


def _script(n_ticks, durs, tear=None):
    """One step's marks: tick t ends at the running sum of ``durs``;
    ``tear`` drops that tick's mark (a torn sequence)."""
    out, now = [], 100.0
    for t in range(n_ticks + 1):
        now += durs[t % len(durs)]
        if t != tear:
            out.append((t, now))
    return out


@settings(max_examples=40, deadline=None)
@given(pp=st.integers(1, 4), vpp=st.integers(1, 3), m=st.integers(1, 8),
       seed=st.integers(0, 2 ** 31 - 1), via_now=st.booleans())
def test_stage_telemetry_matches_jax(pp, vpp, m, seed, via_now):
    """Complete steps, a torn one and the dropped first: the port's
    observations, ``to_dict`` and folds equal JAX's on one clock."""
    rng = np.random.default_rng(seed)
    kw = dict(pp=pp, vpp=vpp, m=m, mode="callback")
    ours, theirs = trec.StageTelemetry(**kw), jrec.StageTelemetry(**kw)
    n = ours.n_ticks
    for step in range(4):
        durs = [float(x) for x in rng.uniform(1e-4, 5e-2, n + 1)]
        tear = int(rng.integers(1, n + 1)) if step == 2 and n > 1 else None
        script = _script(n, durs, tear)
        _drive(ours, script, via_now)
        _drive(theirs, script, False)
        assert ours.to_dict() == theirs.to_dict()
        assert ours._fresh == theirs._fresh
    assert ours.stage_ticks() == theirs.stage_ticks()
    assert ours.bubble() == theirs.bubble()
    fk = _fold_kw(pp, vpp, m, rng)
    kinds = [f"k{i % 2}" for i in range(pp)]
    a, b = ProfileStore(), JStore()
    assert ours.fold_into(a, kinds, **fk) == theirs.fold_into(b, kinds, **fk)
    assert _entries(a) == _entries(b) and _entries(a)


@settings(max_examples=25, deadline=None)
@given(pp=st.integers(1, 4), vpp=st.integers(1, 2), m=st.integers(1, 6),
       bucket=st.integers(1, 3), seed=st.integers(0, 2 ** 31 - 1))
def test_timer_buckets_match_jax(pp, vpp, m, bucket, seed):
    """Timer mode: bucketed step times spread over the ticks, marks
    ignored, ``bucketed`` provenance; folds ``==`` JAX's."""
    rng = np.random.default_rng(seed)
    kw = dict(pp=pp, vpp=vpp, m=m, mode="timer", bucket_steps=bucket)
    ours, theirs = trec.StageTelemetry(**kw), jrec.StageTelemetry(**kw)
    for dt in rng.uniform(0.01, 1.0, 7):
        ours.on_tick(0, now=1.0)            # ignored outside callback mode
        ours.observe_step(float(dt))
        theirs.observe_step(float(dt))
        assert ours.to_dict() == theirs.to_dict()
    fk = _fold_kw(pp, vpp, m, rng)
    a, b = ProfileStore(), JStore()
    ours.fold_into(a, ["x"] * pp, **fk)
    theirs.fold_into(b, ["x"] * pp, **fk)
    assert _entries(a) == _entries(b)
    assert {e.meta["provenance"] for e in a.entries()} <= {"bucketed"}


def test_max_fresh_and_modes_match_jax():
    ours = trec.StageTelemetry(2, 1, 2, mode="timer", drop_first=False)
    theirs = jrec.StageTelemetry(2, 1, 2, mode="timer", drop_first=False)
    for i in range(ours.MAX_FRESH + 7):
        ours.observe_step(0.1 + i * 1e-3)
        theirs.observe_step(0.1 + i * 1e-3)
    assert ours.MAX_FRESH == theirs.MAX_FRESH == 256
    assert ours._fresh == theirs._fresh and len(ours._fresh) == 256
    assert ours.steps == theirs.steps == 263
    assert trec.MODES == jrec.MODES
    for bad in (dict(mode="tick"), dict(pp=0)):
        args = dict(dict(pp=2, vpp=1, m=2), **bad)
        with pytest.raises(ValueError) as e1:
            trec.StageTelemetry(**args)
        with pytest.raises(ValueError) as e2:
            jrec.StageTelemetry(**args)
        assert str(e1.value) == str(e2.value)


def test_dump_and_to_dict(tmp_path):
    ours = trec.StageTelemetry(2, 1, 3)
    for step in range(2):
        _drive(ours, _script(ours.n_ticks, [0.01, 0.02]), True)
    got = json.loads(ours.dump(tmp_path / "t" / "tel.json").read_text())
    assert got == ours.to_dict() and got["steps"] == 1


def test_rank_telemetry_records_every_stage_and_the_simulators_bubble():
    """The rank recorder: per virtual slot chunk c's forward seconds a
    microbatch on stage s (each stage's ranks averaged), the bubble
    1 - mean over stages of busy / span, JAX's fold keys and meta."""
    rec = trec.RankTelemetry(2, 2, 4, drop_first=False)
    ops = [(("F", 0, 0), 0.4), (("F", 1, 0), 0.8), (("B", 0, 0), 1.0)]
    r0 = rec.report(0, (ops, 4.0))
    assert r0 == {"stage": 0, "fwd": [0.1, 0.2], "busy": 2.2, "span": 4.0}
    r1 = {"stage": 1, "fwd": [0.3, 0.5], "busy": 3.0, "span": 4.0}
    r1b = dict(r1, fwd=[0.5, 0.7], busy=1.0)
    rec.observe([r0, r1, r1b])
    assert rec.stage_ticks() == [0.1, 0.4, 0.2, 0.6]
    assert rec.bubble() == pytest.approx(1 - (2.2 / 4 + 0.5) / 2)
    store = ProfileStore()
    rec.fold_into(store, ["cpu", "cpu"], arch="a", seq_len=8, tp=1,
                  schedule="interleaved-1f1b", layers_per_vstage=[1, 2, 1, 0],
                  padded_per_stage=[2, 2], micro_bs_per_stage=[1, 1])
    ticks = sorted((e.shape["stage"], e.value["tick_s"], e.meta["provenance"],
                    e.meta["telemetry"])
                   for e in store.entries(op="observed_stage_tick"))
    assert ticks == [(0, pytest.approx(0.3), "exact", "callback"),
                     (1, pytest.approx(1.0), "exact", "callback")]
    with pytest.raises(ValueError, match=r"no report of stages \[1\]"):
        rec.observe([r0])


# ---------------------------------------------------- the tick marks ----
class _Marks(list):
    def mark(self, t, like):
        self.append(int(t))


@pytest.mark.parametrize("vpp,layers", [(1, [3, 1]), (2, [2, 1, 1, 0])],
                         ids=["vpp1", "vpp2"])
def test_pp_loss_marks_each_tick_once_forward_only(vpp, layers):
    """m + V marks in order during the forward, none in the backward's
    recomputation (remat), and the loss and its gradients bit for bit
    those of the loss without marks."""
    cfg = treg.get_config("llama3-8b", smoke=True, num_layers=4, remat=True)
    bundle = treg.bundle_for(cfg)
    m = 3
    params = bundle.init(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (m, 2, 16), generator=gen)
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, -1)}
    marks = _Marks()
    outs = []
    for tel in (None, marks):
        fn = tpp.make_pp_loss_fn(cfg, 2, m, layers_per_stage=layers, vpp=vpp,
                                 telemetry=tel)
        p = {k: v for k, v in params.items()}
        leaves = tree_leaves(p)
        for x in leaves:
            x.requires_grad_(True)
            x.grad = None
        loss, _ = fn(p, batch)
        n_fwd = len(marks)
        loss.backward()
        assert len(marks) == n_fwd       # the backward marks nothing
        outs.append((loss.detach(), [x.grad.clone() for x in leaves]))
    V = 2 * vpp
    assert marks == list(range(m + V))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))


def test_stage_telemetry_keeps_the_pp_loss_ticks_on_the_cpu():
    """A real recorder on the CPU pipeline loss: the first step dropped,
    the second kept with m + V - 1 tick times."""
    cfg = treg.get_config("llama3-8b", smoke=True, num_layers=4)
    bundle = treg.bundle_for(cfg)
    rec = trec.StageTelemetry(2, 1, 2)
    fn = tpp.make_pp_loss_fn(cfg, 2, 2, layers_per_stage=[3, 1],
                             telemetry=rec)
    params = bundle.init(cfg, seed=0, device="cpu")
    tok = torch.zeros((2, 1, 8), dtype=torch.long)
    for _ in range(2):
        with torch.no_grad():
            fn(params, {"tokens": tok, "labels": tok})
        rec.resolve()                       # nothing to resolve on the CPU
    assert rec.steps == 1 and len(rec._fresh[0]) == rec.n_ticks == 3
    assert all(d > 0 for d in rec._fresh[0])


# ------------------------------------------- the one-process trainer ----
E2E_GB, E2E_SEQ = 8, 32


def _e2e_plans():
    stages = ((0, 3, 1, 1, False), (1, 3, 1, 1, True))
    kw = dict(micro_bs=2, global_batch=E2E_GB, seq_len=E2E_SEQ)
    return (ParallelPlan(stages=tuple(StagePlacement(*s) for s in stages),
                         **kw),
            JPlan(stages=tuple(JStage(*s) for s in stages), **kw))


def _clusters():
    return (C.ClusterSpec(groups=(C.NodeGroup(C.AMD, 1, accel_per_node=1),
                                  C.NodeGroup(C.GPU_A, 1, accel_per_node=1))),
            JC.ClusterSpec(groups=(JC.NodeGroup(JC.AMD, 1, accel_per_node=1),
                                   JC.NodeGroup(JC.GPU_A, 1,
                                                accel_per_node=1))))


def _e2e_trainer(ckpt_dir=None, min_obs=4.0, **cfg_kw):
    plan, _ = _e2e_plans()
    cl, _ = _clusters()
    cfg_kw.setdefault("ckpt_every", 100)
    return Trainer(treg.get_bundle("llama3-8b", smoke=True, num_layers=6),
                   TrainerConfig(global_batch=E2E_GB, seq_len=E2E_SEQ,
                                 ckpt_dir=ckpt_dir,
                                 replan_profile_min_obs=min_obs, **cfg_kw),
                   plan=plan, device="cpu", cluster=cl,
                   profile_store=ProfileStore())


def _jax_replay(durs, dts, obs_scales, stage_scales=None):
    """The JAX trainer's ``_refine_profile`` / ``_fold_telemetry`` on a JAX
    recorder and store, fed the port's kept durations ``durs`` and folded
    step times ``dts`` (one each a step after the first)."""
    _, jplan = _e2e_plans()
    cfg = jreg.get_bundle("llama3-8b", smoke=True, num_layers=6).cfg
    store = JStore()
    tel = jrec.StageTelemetry(2, 1, jplan.micro_batches, drop_first=False)
    vl = list(jplan.virtual_layers)
    for d, dt in zip(durs, dts):
        shape = {"arch": cfg.name, "seq_len": E2E_SEQ,
                 "global_batch": E2E_GB, "tp": 1}
        store.fold("cpu", "observed_step", shape, "time_s", dt)
        store.fold("cpu", "observed_layer_step",
                   {"arch": cfg.name, "seq_len": E2E_SEQ, "tp": 1},
                   "per_seq_s", dt / (cfg.num_layers * E2E_GB),
                   also={"obs_scale": 1.0})
        tel._record(d)
        tel.fold_into(store, ["cpu", "cpu"], arch=cfg.name,
                      seq_len=E2E_SEQ, tp=1, schedule=jplan.schedule,
                      layers_per_vstage=vl,
                      padded_per_stage=[jplan.vpp * max(vl)] * 2,
                      micro_bs_per_stage=[jplan.stage_micro_bs(i)
                                          for i in range(2)],
                      stage_scale=stage_scales, stage_obs_scale=obs_scales)
    return store


def _to_jax_store(store):
    out = JStore()
    for e in store.entries():
        out.put(e.device_kind, e.op, e.shape, e.value, dict(e.meta))
    return out


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """The JAX e2e's scenario on the port: 4 steps of the (3, 3) plan with
    telemetry into a store (gpu-a injected 2x after the second), then
    the replan off gpu-a degraded 4x; a twin trainer migrates through the
    checkpoint instead."""
    tmp = tmp_path_factory.mktemp("e2e")
    t = _e2e_trainer(str(tmp / "mem"))
    kept = []
    t.telemetry.sink = lambda step, start, durs: kept.append(list(durs))
    r1 = t.run(2)
    t.inject_degrade("gpu-a", 2.0)
    r1b = t.run(2)
    entries_before = _entries(t.profile_store)
    health = t.schedule_health()
    cl2 = t.cluster.degrade("gpu-a", 4.0)
    src = t.profiled_cost_source(cl2)
    old_plan = t.plan
    res = t.replan(cl2, global_batch=E2E_GB, seq_len=E2E_SEQ, **SEARCH_KW)
    twin = _e2e_trainer(str(tmp / "ckpt"))
    twin.run(2)
    twin.inject_degrade("gpu-a", 2.0)
    twin.run(2)
    twin.replan(cl2, global_batch=E2E_GB, seq_len=E2E_SEQ,
                migrate="checkpoint", **SEARCH_KW)
    return dict(t=t, twin=twin, kept=kept, dts=(r1["step_s"]
                                                + r1b["step_s"])[1:],
                entries=entries_before, health=health, src=src, res=res,
                cl2=cl2, old_plan=old_plan)


def test_e2e_store_equals_jax_recorder_and_store(e2e):
    """The store the port's trainer folded equals a JAX recorder and store
    fed the same durations under the JAX trainer's keys: two healthy
    steps, then two with gpu-a's stage injected 2x (``stage_scale`` and
    ``obs_scale`` 2 on stage 1)."""
    kept, dts = e2e["kept"], e2e["dts"]
    assert len(kept) == len(dts) == 3
    want = _jax_replay(kept[:1], dts[:1], [1.0, 1.0])
    # the injected steps continue the same store
    _, jplan = _e2e_plans()
    assert jplan.stages[1].group == 1      # stage 1 on gpu-a
    full = _jax_replay(kept[:1], dts[:1], [1.0, 1.0])
    cfg = jreg.get_bundle("llama3-8b", smoke=True, num_layers=6).cfg
    tel = jrec.StageTelemetry(2, 1, jplan.micro_batches, drop_first=False)
    vl = list(jplan.virtual_layers)
    for d, dt in zip(kept[1:], dts[1:]):
        full.fold("cpu", "observed_step",
                  {"arch": cfg.name, "seq_len": E2E_SEQ,
                   "global_batch": E2E_GB, "tp": 1}, "time_s", dt)
        full.fold("cpu", "observed_layer_step",
                  {"arch": cfg.name, "seq_len": E2E_SEQ, "tp": 1},
                  "per_seq_s", dt / (cfg.num_layers * E2E_GB),
                  also={"obs_scale": 1.0})
        tel._record(d)
        tel.fold_into(full, ["cpu", "cpu"], arch=cfg.name, seq_len=E2E_SEQ,
                      tp=1, schedule=jplan.schedule, layers_per_vstage=vl,
                      padded_per_stage=[max(vl)] * 2,
                      micro_bs_per_stage=[2, 2], stage_scale=[1.0, 2.0],
                      stage_obs_scale=[1.0, 2.0])
    assert e2e["entries"] == _entries(full)
    assert e2e["entries"] != _entries(want)
    obs = {e.shape["stage"]: e.value["obs_scale"]
           for e in e2e["t"].profile_store.entries(op="observed_stage_tick")
           if e.shape["stage"] in (0, 1) and e.shape["layers"] == 3}
    assert obs[0] == 1.0 and obs[1] == pytest.approx((1 + 2 + 2) / 3)


def test_e2e_schedule_health_predicts_jaxs_bubble(e2e):
    _, jplan = _e2e_plans()
    _, jcl = _clusters()
    cfg = jreg.get_bundle("llama3-8b", smoke=True, num_layers=6).cfg
    want = JPredictor(jcl, cfg, include_tp_comm=False).predict(
        jplan).bubble_frac
    h = e2e["health"]
    assert h["predicted_bubble"] == want
    assert 0.0 <= h["observed_bubble"] < 1.0
    assert h["ratio"] == h["observed_bubble"] / want


def test_e2e_profiled_cost_source_matches_jaxs(e2e):
    """None below ``replan_profile_min_obs``; above it a cost model equal
    to JAX's on the same entries: its maps, and the predictor's step time
    of both plans through it."""
    t, src, cl2 = e2e["t"], e2e["src"], e2e["cl2"]
    assert _e2e_trainer(min_obs=1e9).profiled_cost_source(cl2) is None
    assert isinstance(src, ProfiledCostModel)
    assert src.time_scale == {"gpu-a": 4.0}
    assert src.device_map == {"amd": "cpu", "gpu-a": "cpu"}
    _, jcl = _clusters()
    jcl2 = jcl.degrade("gpu-a", 4.0)
    jsrc = JCostModel(_to_jax_store(src.store), device_map=src.device_map,
                      time_scale=src.time_scale)
    tcfg = treg.get_config("llama3-8b", smoke=True, num_layers=6)
    jcfg = jreg.get_bundle("llama3-8b", smoke=True, num_layers=6).cfg
    from repro_torch.core.predictor import PerformancePredictor
    for plan in (e2e["old_plan"], e2e["res"].plan):
        jp = JPlan.from_dict(plan.to_dict())
        got = PerformancePredictor(cl2, tcfg, include_tp_comm=False,
                                   cost_source=src).predict(plan)
        want = JPredictor(jcl2, jcfg, include_tp_comm=False,
                          cost_source=jsrc).predict(jp)
        assert got.iter_time == want.iter_time
        assert got.bubble_frac == want.bubble_frac


def test_e2e_replan_equals_jax_search(e2e):
    """The plan and every logged score equal JAX's ``planner.search`` with
    the same cost source and baseline, and JAX's e2e invariants hold."""
    res, src, old = e2e["res"], e2e["src"], e2e["old_plan"]
    _, jcl = _clusters()
    jsrc = JCostModel(_to_jax_store(src.store), device_map=src.device_map,
                      time_scale=src.time_scale)
    jcfg = jreg.get_bundle("llama3-8b", smoke=True, num_layers=6).cfg
    want = jplanner.search(jcl.degrade("gpu-a", 4.0), jcfg,
                           global_batch=E2E_GB, seq_len=E2E_SEQ,
                           cost_source=jsrc,
                           baseline_plan=JPlan.from_dict(old.to_dict()),
                           **SEARCH_KW)
    assert res.plan.to_dict() == want.plan.to_dict()
    assert [tuple(x) for x in res.log] == [tuple(x) for x in want.log]
    assert res.prediction.iter_time == want.prediction.iter_time

    def on_gpu_a(plan):
        return sum(s.n_layers for s in plan.stages if s.group == 1)

    assert on_gpu_a(res.plan) < on_gpu_a(old)
    assert res.prediction.iter_time < dict(res.log)[
        f"baseline {old.describe()}"]
    t = e2e["t"]
    assert t.plan is res.plan and t.replans == 1
    assert t.migrations == {"memory": 1, "checkpoint": 0}
    assert t._ewma is None and t.telemetry.steps == 0


def test_e2e_memory_and_checkpoint_migrations_agree_bit_for_bit(e2e):
    t, twin = e2e["t"], e2e["twin"]
    assert twin.migrations == {"memory": 0, "checkpoint": 1}
    assert twin.plan.to_dict() == t.plan.to_dict()
    assert t.step == twin.step == 4
    for a, b in zip(tree_leaves(t.state), tree_leaves(twin.state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    ra, rb = t.run(1), twin.run(1)
    assert ra["losses"] == rb["losses"] and np.isfinite(ra["losses"][0])
    for a, b in zip(tree_leaves(t.state), tree_leaves(twin.state)):
        assert torch.equal(a, b)


def test_adopt_uses_a_checkpoint_of_this_step_and_refuses_bad_modes(
        tmp_path):
    """``_adopt`` writes the checkpoint of this step only when there is
    none; ``migrate="checkpoint"`` needs ``ckpt_dir``; unknown modes
    raise as in JAX; a failed move without a checkpoint raises."""
    t = _e2e_trainer(str(tmp_path), ckpt_every=2)
    t.run(2)
    d = tmp_path / "step_00000002"
    before = d.stat().st_mtime_ns
    cl2 = t.cluster.degrade("gpu-a", 4.0)
    t.replan(cl2, global_batch=E2E_GB, seq_len=E2E_SEQ, **SEARCH_KW)
    assert d.stat().st_mtime_ns == before
    assert t.last_migration["memory"] and t.last_migration["ckpt_s"] >= 0
    with pytest.raises(ValueError, match="unknown migrate mode 'disk'"):
        t.replan(cl2, global_batch=E2E_GB, seq_len=E2E_SEQ,
                 migrate="disk", **SEARCH_KW)
    bare = _e2e_trainer()
    with pytest.raises(ValueError, match="set TrainerConfig.ckpt_dir"):
        bare.replan(cl2, global_batch=E2E_GB, seq_len=E2E_SEQ,
                    migrate="checkpoint", **SEARCH_KW)


def test_straggler_callback_after_patience_slow_steps():
    """The EWMA detection: ``on_straggler`` once ``straggler_patience``
    steps in a row take over ``straggler_factor`` x the EWMA.  The
    trainer's clock is scripted (10 ms a step, 1 s from step 4 on): a
    host's own ~10 ms steps vary by more than the factor under load."""
    t = Trainer(treg.get_bundle("llama3-8b", smoke=True),
                TrainerConfig(global_batch=2, seq_len=16,
                              straggler_patience=2, straggler_factor=1.5),
                device="cpu")
    step, now = t.train_step, [100.0]

    def sleepy(state, batch):
        now[0] += 1.0 if t.step >= 4 else 0.01
        return step(state, batch)

    t.train_step = sleepy
    calls = []
    with mock.patch.object(ttrainer.time, "perf_counter",
                           lambda: now[0]):
        t.run(4, on_straggler=calls.append)
        assert calls == [] and t._slow == 0
        assert t._ewma == pytest.approx(0.01)
        t.run(1, on_straggler=calls.append)
        assert calls == [] and t._slow == 1
        t.run(1, on_straggler=calls.append)
    assert calls == [t] and t._slow == 0


def test_inject_degrade_errors_and_tags_as_jax():
    """JAX's messages (``repro/train/trainer.py:489-497,510-511``), and
    injections composing per kind into the folds' ``obs_scale``."""
    bare = Trainer(treg.get_bundle("llama3-8b", smoke=True),
                   TrainerConfig(global_batch=2, seq_len=16), device="cpu")
    with pytest.raises(ValueError, match=r"^inject_degrade needs a cluster "
                       r"\(stage -> device kind mapping\)$"):
        bare.inject_degrade("gpu-a", 2.0)
    t = _e2e_trainer()
    with pytest.raises(ValueError, match=r"^factor must be > 0, got 0.0$"):
        t.inject_degrade("gpu-a", 0.0)
    with pytest.raises(ValueError, match=r"^unknown device kind 'tpu'; "
                       r"cluster has \['amd', 'gpu-a'\]$"):
        t.inject_degrade("tpu", 2.0)
    with pytest.raises(ValueError, match=r"^factor must be > 0, got -1$"):
        t.inject_link_degrade(-1)
    t.inject_degrade("gpu-a", 2.0)
    t.inject_degrade("gpu-a", 1.5)
    assert t._stage_scales() == [1.0, 3.0]
    assert t._obs_scales() == {"gpu-a": 3.0}
    t.cluster = t.cluster.degrade("amd", 4.0)
    assert t._obs_scales() == {"gpu-a": 3.0, "amd": 4.0}
    assert t._model_scale("amd") == pytest.approx(4.0)
    t.inject_link_degrade(2.0)
    t.run(3)
    h = t.schedule_health()
    assert h["observed_bubble"] == 2.0 * t.telemetry.bubble()
    ticks = t._stage_tick_obs()
    raw = t.telemetry.stage_ticks()
    assert ticks == [raw[0], 3.0 * raw[1]]


def test_telemetry_modes_on_the_pipeline_route():
    t = _e2e_trainer(telemetry="timer")
    assert t.telemetry.mode == "timer"
    t.run(3)
    prov = {e.meta["provenance"]
            for e in t.profile_store.entries(op="observed_stage_tick")}
    assert prov == {"bucketed"}
    assert _e2e_trainer(telemetry="off").telemetry is None
    assert _e2e_trainer().telemetry.mode == "callback"
    with pytest.raises(ValueError, match="unknown telemetry mode 'tick'"):
        _e2e_trainer(telemetry="tick")


# ------------------------------------------------------------ the CLI ----
@pytest.mark.parametrize("spec", [
    "gpu-a:4@2", "gpu-a:8", "amd:1.5@0", "x:2@", "gpu-a", ":4", "gpu-a:",
    "gpu-a:abc", "gpu-a:4@x", "gpu-a:0", "gpu-a:-2", "gpu-a:inf",
    "gpu-a:nan", "gpu-a:4@-1"])
def test_degrade_spec_matches_jax(spec):
    def parse(fn):
        try:
            return ("ok", fn(spec))
        except argparse.ArgumentTypeError as e:
            return ("err", str(e))
    assert parse(train_cli.degrade_spec) == parse(jtrain_cli.degrade_spec)


CLI = ["--smoke", "--device", "cpu", "--pp", "2", "--layers", "4",
       "--global-batch", "4", "--seq", "16", "--steps", "4",
       "--degrade", "gpu-a:4@2"]


def _cli_checks(lines):
    first = [ln for ln in lines if ln.startswith("[train] plan: ")]
    assert first == ["[train] plan: pp=2 tp=1 dp=1 mbs=1 m=4 "
                     "sched=1f1b-eager+2 seg=22"]
    rep = [ln for ln in lines if ln.startswith("[train] degraded ")]
    assert len(rep) == 1 and rep[0].startswith(
        "[train] degraded gpu-a:4.0 -> replanned: pp=2 ")
    assert " seg=13 " in rep[0]
    assert rep[0].endswith("(migrations={'memory': 1, 'checkpoint': 0})")
    assert sum(ln.startswith("[train] bubble observed=") for ln in lines) \
        == 2
    summary = json.loads(lines[-1])
    assert summary["replans"] == 1
    assert summary["migrations"] == {"memory": 1, "checkpoint": 0}
    assert summary["steps"] == 4 and summary["pp"] == 2
    return summary


def test_cli_degrade_replans_in_one_process(capsys, tmp_path):
    train_cli.main(CLI + ["--ckpt-dir", str(tmp_path)])
    summary = _cli_checks(capsys.readouterr().out.strip().splitlines())
    assert summary["virtual_layers"] == [1, 3]      # gpu-a's stage first
    with pytest.raises(SystemExit):
        train_cli.main(["--smoke", "--device", "cpu", "--degrade",
                        "gpu-a:4"])
    assert "--degrade needs --pp" in capsys.readouterr().err


def test_cli_degrade_under_torchrun(capsys, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *CLI,
         "--ckpt-dir", str(tmp_path / "ranks")],
        cwd=str(ROOT), env=env, capture_output=True, text=True,
        timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr[-3000:]
    summary = _cli_checks(r.stdout.strip().splitlines())
    assert summary["world"] == 2 and summary["virtual_layers"] == [1, 3]
    assert summary["rank_losses"][0] == summary["rank_losses"][1]
    train_cli.main(CLI + ["--ckpt-dir", str(tmp_path / "one")])
    one = _cli_checks(capsys.readouterr().out.strip().splitlines())
    assert abs(summary["final_loss"] - one["final_loss"]) < F32_TOL


# ---------------------------------------------------------- the ranks ----
BF16 = dict(arch="llama3-8b", smoke=True, num_layers=4,
            param_dtype="bfloat16", dtype="bfloat16")


def _plan(layers, dp=1, tp=1, vpp=1, chunk_layers=None):
    pp = len(layers)
    return ParallelPlan(
        stages=tuple(StagePlacement(s, n, dp, tp, s == pp - 1)
                     for s, n in enumerate(layers)),
        micro_bs=1, global_batch=4 * dp, seq_len=16, transport="cpu",
        vpp=vpp, chunk_layers=chunk_layers,
        schedule="interleaved-1f1b" if vpp > 1 else "1f1b")


# (old plan, new plan) by world size
MOVES = {
    2: [("3-1 to 1-3", _plan([3, 1]), _plan([1, 3])),
        ("vpp2 to vpp1", _plan([3, 1], vpp=2, chunk_layers=(1, 1, 2, 0)),
         _plan([3, 1]))],
    4: [("pp2xdp2 3-1 to 1-3", _plan([3, 1], dp=2), _plan([1, 3], dp=2)),
        ("pp2xdp2 to pp1xdp4", _plan([3, 1], dp=2), _plan([4], dp=4)),
        ("pp2xdp2 vpp2 to another vpp2",
         _plan([3, 1], dp=2, vpp=2, chunk_layers=(1, 1, 2, 0)),
         _plan([1, 3], dp=2, vpp=2, chunk_layers=(1, 2, 0, 1))),
        ("pp2xtp2 3-1 to 1-3", _plan([3, 1], tp=2), _plan([1, 3], tp=2))],
}


def _whole_state():
    """A bf16 SMOKE train state whose every leaf is distinct random
    numbers (moments and master included), as numpy."""
    bundle = treg.get_bundle(**BF16)
    state = tsteps.init_train_state(bundle, device="cpu")
    gen = torch.Generator().manual_seed(3)
    from repro_torch.optim.adamw import tree_map
    state = tree_map(lambda t: (torch.randn(t.shape, generator=gen)
                                .to(t.dtype) if t.is_floating_point()
                                else t + 5), state)
    return state


@pytest.fixture(scope="module")
def moved(tmp_path_factory):
    state = _whole_state()
    from repro_torch.optim.adamw import tree_map
    whole_np = tree_map(lambda t: t.float().numpy() if t.dtype ==
                        torch.bfloat16 else t.numpy(), state)
    out = {}
    for world, cases in MOVES.items():
        d = tmp_path_factory.mktemp(f"moves{world}")
        res = run_ranks(rank_programs.migrate_cases, world, device="cpu",
                        timeout_s=TIMEOUT,
                        args=(BF16, whole_np,
                              [(o.to_dict(), n.to_dict()) for _, o, n in cases],
                              str(d)))
        for i, (name, old, new) in enumerate(cases):
            out[name] = (old, new, [r[i] for r in res])
    return state, out


@pytest.mark.parametrize("name", [n for c in MOVES.values() for n, _, _ in c])
def test_redistribute_equals_the_split_and_the_checkpoint(moved, name):
    """Each rank's moved state equals ``split_state_for_rank`` of the whole
    state under the new plan bit for bit, and its restore of the old
    plan's ``save_rank`` checkpoint; the bytes sent are the bytes
    received, and only elements whose writer moved travel."""
    state, cases = moved
    old, new, res = cases[name]
    cfg = treg.get_config(**BF16)
    rules = ShardingRules(cfg, tp=new.tps[0])
    from repro_torch.parallel.migrate import rank_coords
    for rank, r in enumerate(res):
        stage, replica, mr = rank_coords(new, rank)
        want = tpp.split_state_for_rank(state, new, stage, rules, mr,
                                        replica=replica)
        got = r["state"]
        assert r["unequal_to_checkpoint"] == []
        wl, gl = _leaves_by_path(want), _leaves_by_path(got)
        assert sorted(wl) == sorted(gl)
        for k in wl:
            w = wl[k].float() if wl[k].dtype == torch.bfloat16 else wl[k]
            assert np.array_equal(w.numpy(), gl[k]), (rank, k)
    assert sum(r["sent_bytes"] for r in res) == \
        sum(r["recv_bytes"] for r in res) > 0


def _leaves_by_path(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves_by_path(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = v
    return out


SMOKE4 = dict(arch="llama3-8b", smoke=True, num_layers=4)


@pytest.fixture(scope="module")
def rank_replan(tmp_path_factory):
    """``replan_cases`` on four gloo ranks: the searched (3, 1) plan of
    dp 1 widened to pp 2 x dp 2 (ZeRO-1), m 2."""
    d = tmp_path_factory.mktemp("replan")
    return run_ranks(rank_programs.replan_cases, 4, device="cpu",
                     timeout_s=TIMEOUT,
                     args=(SMOKE4, _plan([3, 1]).to_dict(), str(d)))


def test_rank_replan_next_loss_equals_a_fresh_trainers(rank_replan):
    """2 steps on (3, 1) widened to dp 2 with telemetry into a store, a
    replan off gpu-a at 4x (rank 0 searches and broadcasts), the move in
    memory (ZeRO-1 slices included), then a step on the new plan: its loss
    equals a fresh rank trainer's on the gathered state, and every rank
    adopted one plan; the old grid's groups are released, so the process
    groups alive after the replan are as many as before."""
    r0 = rank_replan[0]
    assert all(r["plan"] == r0["plan"] for r in rank_replan)
    assert r0["plan"].endswith("seg=13")
    assert r0["migrations"] == {"memory": 1, "checkpoint": 0}
    assert all(r["next_losses"] == r0["fresh_losses"] for r in rank_replan)
    assert np.isfinite(r0["next_losses"][0])
    for r in rank_replan:
        assert r["n_groups"][0] == r["n_groups"][1], r["n_groups"]


def test_rank_replan_predicts_the_bubble_of_the_plan_the_ranks_run(
        rank_replan):
    """``schedule_health`` on ranks predicts the bubble of the widened
    plan the ranks run (dp 2, m 2), not of the searched one (dp 1, m 4)."""
    from repro_torch.core.predictor import PerformancePredictor
    cfg = treg.get_config(**SMOKE4)
    pred = PerformancePredictor(C.cli_cluster(), cfg, include_tp_comm=False)
    for r in rank_replan:
        run = ParallelPlan.from_dict(r["run_plan"])
        assert run.dps == (2, 2) and run.micro_batches == 2
        want = pred.predict(run).bubble_frac
        assert r["health"]["predicted_bubble"] == want
        assert want != pred.predict(_plan([3, 1])).bubble_frac
        assert r["health"]["observed_bubble"] == r["bubble"]


def test_rank_replan_every_rank_folds_the_same_view(rank_replan):
    r0 = rank_replan[0]
    assert all(r["entries"] == r0["entries"] for r in rank_replan)
    ops = {e[1] for e in r0["entries"]}
    assert ops == {"observed_step", "observed_layer_step",
                   "observed_stage_tick", "observed_bubble"}
    ticks = [e for e in r0["entries"] if e[1] == "observed_stage_tick"]
    assert len(ticks) == 2 and {e[5] for e in ticks} == {"exact"}
    assert all(r["stage_ticks"] == r0["stage_ticks"] for r in rank_replan)
    assert 0.0 <= r0["bubble"] < 1.0


def test_rank_replan_leaves_the_iccl_notes_unchanged(rank_replan):
    """The per-step gather runs outside the ICCL tap: a rank's notes with
    telemetry and a store equal its notes with telemetry off."""
    for r in rank_replan:
        assert r["notes"] == r["notes_off"] and r["notes"]


def test_rank_replan_refuses_a_plan_that_changes_the_world(rank_replan):
    """A plan of 3 ranks cannot run on the 4 ranks present: every rank
    raises, naming them."""
    for r in rank_replan:
        assert "needs 3 ranks" in r["world_error"] and \
            "ranks present (4: [0, 1, 2, 3])" in r["world_error"]


@pytest.mark.parametrize("layers", [16, 32])
def test_rank_replan_on_cards_fits_the_card(layers):
    """The search of a replan on ranks on the cards (``fit_to_card``): the
    train CLI's llama3-8b plan at ``layers`` degraded off gpu-a at 4x,
    held to an 80 GB card.  At 32 layers the search without it puts 26
    layers on one stage, over the card by the predictor's memory (its
    first gradient norm ran out of memory on four H100s); with it every
    stage fits, and gpu-a still holds fewer layers than before."""
    from repro_torch.core import planner
    from repro_torch.train.trainer import fit_to_card
    cfg = treg.get_config("llama3-8b", num_layers=layers)
    old = train_cli.search_plan(cfg, 2, 8, 4096)
    degraded = C.cli_cluster().degrade("gpu-a", 4.0)
    kw = dict(global_batch=8, seq_len=4096, baseline_plan=old)
    free = planner.search(degraded, cfg, **kw, **C.cli_search_kw(2))
    card, fit_kw = fit_to_card(degraded, C.cli_search_kw(2), 80.0)
    fit = planner.search(card, cfg, **kw, **fit_kw)
    assert fit.prediction.fits and max(fit.prediction.peak_mem_gb) < 80.0

    def on_gpu_a(p):
        return sum(st.n_layers for st in p.stages
                   if degraded.groups[st.group].device.name == "gpu-a")

    assert on_gpu_a(fit.plan) < on_gpu_a(old)
    if layers == 16:        # the free search fits: the same plan
        assert fit.plan == free.plan
    else:
        assert max(free.prediction.peak_mem_gb) > 80.0
        assert fit.plan != free.plan
