"""The port's autonomous controller (``repro_torch.adapt``, the
``Trainer``'s adaptation loop) against the JAX package's pieces, on the
CPU.

The JAX ``Trainer`` fails under this jax (its e2e tests error with
``ShardingTypeError``), so the port is held against the pieces the JAX
controller composes:

  * ``ReplanPolicy``'s decisions, state and errors ``==`` JAX's on the same
    observation sequences (hypothesis over the bands, patience, cooldown,
    baseline, smoothing and trust buckets, with resets and rejects
    interleaved); ``AdaptEvent`` and its serializations ``==`` JAX's;
  * the aggregators: ``merge_stores``, ``LocalAggregator``,
    ``InMemoryFanIn``, ``MembershipView`` / ``ElectingFanIn`` ``==``
    JAX's; ``ProcessAllGatherAggregator``'s wire format (``_encode``,
    ``_merge_payloads``) byte for byte, and on 3 gloo ranks its gather
    equal to JAX's merge of the same payloads and its broadcast from a
    re-elected leader;
  * the controller on the one-process pp ``Trainer`` of JAX's e2e
    (``tests/test_adapt.py:348-365``, SMOKE 6 layers, (3, 3) on two
    islands): every policy call mirrored to a JAX policy with equal
    answers, the search's plan and scores ``==`` JAX's ``planner.search``
    on the same store and cluster, the ``adapt_log`` ``==`` the events
    built from JAX's answers, the state after the live migration equal
    bit for bit to a twin's that adopts the same plan through the
    checkpoint, the ε gate blocking a small gain, and a link degrade
    triggering ``replan-schedule`` on the unchanged cluster;
  * the train CLI's ``--adapt`` knobs against JAX's parser.
"""
import dataclasses
import json
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.adapt import aggregate as jagg  # noqa: E402
from repro.adapt import policy as jpol  # noqa: E402
from repro.core import cluster as JC  # noqa: E402
from repro.core import planner as jplanner  # noqa: E402
from repro.core.plan import ParallelPlan as JPlan  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.obs.runmeta import RunMeta as JRunMeta  # noqa: E402
from repro.profile.model import ProfiledCostModel as JCostModel  # noqa
from repro.profile.store import ProfileStore as JStore  # noqa: E402
from repro_torch.adapt import aggregate as agg  # noqa: E402
from repro_torch.adapt import policy as pol  # noqa: E402
from repro_torch.core import cluster as C  # noqa: E402
from repro_torch.core.plan import ParallelPlan, StagePlacement  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.obs.runmeta import RunMeta  # noqa: E402
from repro_torch.parallel import rank_programs  # noqa: E402
from repro_torch.parallel.launch import run_ranks  # noqa: E402
from repro_torch.profile.store import ProfileStore  # noqa: E402
from repro_torch.telemetry import recorder as trecorder  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

TIMEOUT = 120
GB, SEQ = 8, 32
# tests/test_adapt.py's search space (its SEARCH_KW without the workload)
ADAPT_SEARCH_KW = dict(pp_options=[2], tp_options=[1], micro_bs_options=[2],
                       require_fit=False, include_tp_comm=False,
                       schedule="1f1b", explore_orders=False)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's in-process trainers (SMOKE
    sizes gain nothing from more), so that test workers running side by
    side do not oversubscribe the host's cores; restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _asdict(x):
    return None if x is None else dataclasses.asdict(x)


# ------------------------------------------------------------ the policy --
def test_policy_module_is_jaxs():
    """The defaults, the config's errors and the decision types."""
    assert _asdict(pol.AdaptConfig()) == _asdict(jpol.AdaptConfig())
    for bad in (dict(straggler_enter=1.0, straggler_exit=1.3),
                dict(bubble_enter=1.1), dict(patience=0.5),
                dict(cooldown=-1), dict(baseline_steps=0), dict(ewma=0.0),
                dict(min_gain=1.0), dict(bucketed_weight=0.0)):
        with pytest.raises(ValueError) as a:
            pol.AdaptConfig(**bad)
        with pytest.raises(ValueError) as b:
            jpol.AdaptConfig(**bad)
        assert str(a.value) == str(b.value)
    assert [f.name for f in dataclasses.fields(pol.AdaptDecision)] == \
        [f.name for f in dataclasses.fields(jpol.AdaptDecision)]


def test_adapt_events_serialize_as_jaxs():
    """``to_dict``, ``format``, ``events_json`` and ``events_jsonl`` (with
    the run header) of the same events, byte for byte."""
    raw = [(3, "trigger", "stage 1 sustained 4.00x",
            {"action": "replan-straggler", "signal": 4.0, "stage": 1,
             "factor": 4.0}),
           (3, "replan", "searched 7 candidates",
            {"winner": "pp=2", "iter_time": 0.1, "baseline_time": 0.2,
             "expected_gain": 0.5}),
           (4, "node-lost", "island gpu-a left", {"kind": "gpu-a"})]
    ours = [pol.AdaptEvent(*r) for r in raw]
    theirs = [jpol.AdaptEvent(*r) for r in raw]
    assert [e.to_dict() for e in ours] == [e.to_dict() for e in theirs]
    assert [e.format() for e in ours] == [e.format() for e in theirs]
    assert pol.events_json(ours) == jpol.events_json(theirs)
    meta = dict(run_id="r1", plan_digest="abc", arch="a", created_unix=1.0)
    assert pol.events_jsonl(ours, run=RunMeta(**meta)) == \
        jpol.events_jsonl(theirs, run=JRunMeta(**meta))
    assert pol.events_jsonl(ours) == jpol.events_jsonl(theirs)


_obs = st.tuples(
    st.one_of(st.none(), st.lists(st.floats(0.01, 2.0), min_size=1,
                                  max_size=4)),
    st.one_of(st.none(), st.floats(0.1, 4.0)),
    st.sampled_from(["exact", "bucketed"]),
    st.sampled_from(["observe", "observe", "observe", "observe", "reset",
                     "reject"]))


@settings(max_examples=60, deadline=None)
@given(enter=st.floats(1.2, 4.0), gap=st.floats(0.05, 0.9),
       benter=st.floats(1.1, 3.0), bgap=st.floats(0.05, 0.9),
       patience=st.floats(1.0, 4.0), cooldown=st.integers(0, 5),
       baseline=st.integers(1, 3), ewma=st.floats(0.1, 1.0),
       bucketed=st.floats(0.1, 1.0), min_gain=st.floats(0.0, 0.9),
       pp=st.integers(1, 4), seq=st.lists(_obs, min_size=1, max_size=30))
def test_policy_decisions_equal_jaxs(enter, gap, benter, bgap, patience,
                                     cooldown, baseline, ewma, bucketed,
                                     min_gain, pp, seq):
    """One observation sequence (stage ticks of ``pp`` stages, a bubble
    ratio, a trust class; resets and rejects between) through the port's
    and JAX's policy: the same answers, cooldowns and gain gates."""
    kw = dict(straggler_enter=enter, straggler_exit=enter * (1 - gap / 2),
              bubble_enter=benter, bubble_exit=benter * (1 - bgap / 2),
              patience=patience, cooldown=cooldown, baseline_steps=baseline,
              ewma=ewma, bucketed_weight=bucketed, min_gain=min_gain)
    ours = pol.ReplanPolicy(pol.AdaptConfig(**kw))
    theirs = jpol.ReplanPolicy(jpol.AdaptConfig(**kw))
    for step, (ticks, ratio, prov, call) in enumerate(seq):
        if ticks is not None:
            ticks = (ticks * pp)[:pp]
        if call == "reset":
            ours.reset(step)
            theirs.reset(step)
        elif call == "reject":
            ours.reject(step)
            theirs.reject(step)
        else:
            a = ours.observe(step, ticks, bubble_ratio=ratio,
                             provenance=prov)
            b = theirs.observe(step, ticks, bubble_ratio=ratio,
                               provenance=prov)
            assert _asdict(a) == _asdict(b)
        assert ours.cooling == theirs.cooling
    for gain in (None, 0.0, min_gain, min_gain + 0.01, 0.99):
        res = type("R", (), {"expected_gain": gain})()
        assert ours.gain_ok(res) == theirs.gain_ok(res)


# ------------------------------------------------------- the aggregators --
def _stores(seed, n=3):
    """``n`` pairs of equal (port, JAX) stores of observed and calibration
    entries, with keys shared across them."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        a, b = ProfileStore(), JStore()
        for k in range(int(rng.integers(2, 6))):
            op = str(rng.choice(list(agg.OBSERVED_OPS) + ["layer_cost"]))
            shape = {"arch": "m", "stage": int(rng.integers(0, 3)),
                     "seq_len": 32}
            v = float(rng.uniform(0.01, 1.0))
            kind = str(rng.choice(["cpu", "gpu-a"]))
            n = float(rng.integers(1, 4))
            for s in (a, b):     # one meta: the wire carries it
                s.put(kind, op, shape, {"tick_s": v, "n": n},
                      meta={"telemetry": "callback", "schema": 1})
        out.append((a, b))
    return out


def _entries(store):
    return sorted((e.device_kind, e.op, json.dumps(e.shape, sort_keys=True),
                   json.dumps(e.value, sort_keys=True))
                  for e in store.entries())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merges_equal_jaxs(seed):
    pairs = _stores(seed)
    ours = [a for a, _ in pairs]
    theirs = [b for _, b in pairs]
    assert agg.OBSERVED_OPS == jagg.OBSERVED_OPS
    assert _entries(agg.merge_stores(ours)) == \
        _entries(jagg.merge_stores(theirs))
    assert _entries(agg.merge_stores(ours, ops=["observed_step"])) == \
        _entries(jagg.merge_stores(theirs, ops=["observed_step"]))
    assert agg.LocalAggregator().gather(ours[0]) is ours[0]
    fan, jfan = agg.InMemoryFanIn(ours[1:]), jagg.InMemoryFanIn(theirs[1:])
    assert _entries(fan.gather(ours[0])) == _entries(jfan.gather(theirs[0]))
    assert not agg.LocalAggregator.collective
    assert agg.ProcessAllGatherAggregator.collective


@pytest.mark.parametrize("seed", [0, 1])
def test_allgather_wire_format_is_jaxs_byte_for_byte(seed):
    """``_encode`` of equal stores gives JAX's bytes, and merging the same
    payloads gives JAX's view."""
    pairs = _stores(seed)
    ours, theirs = agg.ProcessAllGatherAggregator(), \
        jagg.ProcessAllGatherAggregator()
    wires = [ours._encode(a) for a, _ in pairs]
    assert wires == [theirs._encode(b) for _, b in pairs]
    got = ours._merge_payloads(pairs[0][0], wires[1:] + [b""])
    want = theirs._merge_payloads(pairs[0][1], wires[1:] + [b""])
    assert _entries(got) == _entries(want)


def test_membership_and_election_equal_jaxs():
    """The simulated protocol: leadership by the lowest surviving rank,
    the broadcast log replayed by followers, the errors."""
    v, jv = agg.MembershipView(3), jagg.MembershipView(3)
    a = [agg.ElectingFanIn(v, r) for r in range(3)]
    b = [jagg.ElectingFanIn(jv, r) for r in range(3)]
    for x, y in ((a, b),):
        assert [f.is_leader() for f in x] == [f.is_leader() for f in y]
    assert a[0].broadcast({"d": 1}) == b[0].broadcast({"d": 1})
    assert a[1].broadcast(None) == b[1].broadcast(None) == {"d": 1}
    a[1].lose_rank(0)
    b[1].lose_rank(0)
    assert v.leader() == jv.leader() == 1
    assert [f.is_leader() for f in a] == [f.is_leader() for f in b]
    assert a[1].broadcast({"e": (1, 2)}) == b[1].broadcast({"e": (1, 2)})
    assert a[2].broadcast(None) == b[2].broadcast(None)
    for bad in (lambda m: m.lose(0), lambda m: m.rejoin(5)):
        with pytest.raises(ValueError) as e1:
            bad(v)
        with pytest.raises(ValueError) as e2:
            bad(jv)
        assert str(e1.value) == str(e2.value)
    pa, pb = agg.ProcessAllGatherAggregator(), \
        jagg.ProcessAllGatherAggregator()
    for x in (pa, pb):
        x.lose_rank(0)
        x.lose_rank(2)
        x.rejoin_rank(2)
    # one process: rank 0 of 1, lost; JAX's raises alike
    with pytest.raises(RuntimeError, match="no surviving rank"):
        pa.leader_rank()
    with pytest.raises(RuntimeError, match="no surviving rank"):
        pb.leader_rank()
    assert isinstance(agg.default_aggregator(), agg.LocalAggregator)


def test_allgather_aggregator_on_gloo_ranks():
    """3 gloo ranks: each rank's gathered view equals JAX's merge of the
    same payloads, and a broadcast originates from whichever rank leads
    (rank 1 once rank 0 is lost) and reaches every rank."""
    entries = []
    for r in range(3):
        entries.append([("cpu", op, {"arch": "m", "stage": r % 2},
                         {"tick_s": 0.1 * (r + 1) + 0.01 * i, "n": r + 1.0},
                         {"telemetry": "callback"})
                        for i, op in enumerate(agg.OBSERVED_OPS)])
    res = run_ranks(rank_programs.aggregate_ranks, 3, timeout_s=TIMEOUT,
                    device="cpu", args=(entries,))
    j = jagg.ProcessAllGatherAggregator()
    stores = []
    for es in entries:
        s = JStore()
        for dev, op, shape, value, meta in es:
            s.put(dev, op, shape, value, meta=meta)
        stores.append(s)
    wires = [j._encode(s) for s in stores]
    for r, out in enumerate(res):
        assert out["wire"] == wires[r]
        want = j._merge_payloads(stores[r],
                                 [w for i, w in enumerate(wires) if i != r])
        assert out["entries"] == _entries(want)
        assert out["directives"] == [{"from": 0}, None, {"from": 1}]
        assert out["leaders"] == [0, 1]


# ---------------------------------------------- the controller, e2e ----
def _plan():
    return ParallelPlan(stages=(StagePlacement(0, 3, 1, 1, False),
                                StagePlacement(1, 3, 1, 1, True)),
                        micro_bs=2, global_batch=GB, seq_len=SEQ)


def _cluster():
    return C.ClusterSpec(groups=(C.NodeGroup(C.AMD, 1, accel_per_node=1),
                                 C.NodeGroup(C.GPU_A, 1, accel_per_node=1)))


def _jcluster():
    return JC.ClusterSpec(groups=(JC.NodeGroup(JC.AMD, 1, accel_per_node=1),
                                  JC.NodeGroup(JC.GPU_A, 1,
                                               accel_per_node=1)))


def _mk_trainer(tmp, policy=None, aggregator=None):
    """``tests/test_adapt.py``'s ``_mk_trainer`` on the port."""
    return Trainer(treg.get_bundle("llama3-8b", smoke=True, num_layers=6),
                   TrainerConfig(global_batch=GB, seq_len=SEQ,
                                 ckpt_dir=str(Path(tmp) / "ckpt"),
                                 ckpt_every=100, replan_profile_min_obs=4),
                   plan=_plan(), device="cpu", cluster=_cluster(),
                   profile_store=ProfileStore(), policy=policy,
                   aggregator=aggregator, adapt_search_kw=ADAPT_SEARCH_KW)


def _cfg(**kw):
    return pol.AdaptConfig(**kw)


class _Tee:
    """The port's policy, every call mirrored to a JAX policy of the same
    config; ``pairs`` holds both answers of every ``observe``."""

    def __init__(self, cfg_kw):
        self.ours = pol.ReplanPolicy(pol.AdaptConfig(**cfg_kw))
        self.theirs = jpol.ReplanPolicy(jpol.AdaptConfig(**cfg_kw))
        self.cfg = self.ours.cfg
        self.pairs, self.gains = [], []

    def observe(self, step, ticks, **kw):
        a = self.ours.observe(step, ticks, **kw)
        b = self.theirs.observe(step, ticks, **kw)
        self.pairs.append((step, _asdict(a), _asdict(b)))
        return a

    def reset(self, step=0):
        self.ours.reset(step)
        self.theirs.reset(step)

    def reject(self, step=0):
        self.ours.reject(step)
        self.theirs.reject(step)

    def gain_ok(self, result):
        a, b = self.ours.gain_ok(result), self.theirs.gain_ok(result)
        self.gains.append((a, b))
        return a


class _WatchSearch:
    """Record every ``planner.search`` the trainer runs: (cluster,
    keywords, result), the cost source and baseline included."""

    def __init__(self):
        self.seen = []
        self._patch = mock.patch.object(ttrainer.planner_mod, "search",
                                        self._search)
        self._real = ttrainer.planner_mod.search

    def _search(self, cluster, cfg, **kw):
        res = self._real(cluster, cfg, **kw)
        src = kw.get("cost_source")
        # the store goes on folding: keep its entries as the search saw them
        snap = None if src is None else [
            (e.device_kind, e.op, dict(e.shape), dict(e.value),
             dict(e.meta)) for e in src.store.entries()]
        self.seen.append((cluster, dict(kw, _entries=snap), res))
        return res

    def __enter__(self):
        self._patch.start()
        return self.seen

    def __exit__(self, *exc):
        self._patch.stop()


def _jax_search(cluster, kw, res):
    """JAX's ``planner.search`` on the JAX twin of ``cluster`` (the same
    degradations), with the port's profiled cost source rebuilt over the
    same entries."""
    jcl = _jcluster()
    for g in cluster.groups:
        if g.device.slowdown != 1.0:
            jcl = jcl.degrade(g.device.name, g.device.slowdown)
    kw = dict(kw)
    src = kw.pop("cost_source", None)
    entries = kw.pop("_entries")
    jkw = {k: v for k, v in kw.items()
           if k not in ("baseline_plan", "global_batch", "seq_len")}
    if "baseline_plan" in kw and kw["baseline_plan"] is not None:
        jkw["baseline_plan"] = JPlan.from_dict(kw["baseline_plan"].to_dict())
    if src is not None:
        store = JStore()
        for dev, op, shape, value, meta in entries:
            store.put(dev, op, shape, value, meta)
        jkw["cost_source"] = JCostModel(store, device_map=src.device_map,
                                        time_scale=src.time_scale)
    jcfg = jreg.get_bundle("llama3-8b", smoke=True, num_layers=6).cfg
    return jplanner.search(jcl, jcfg, global_batch=GB, seq_len=SEQ, **jkw)


@pytest.fixture(scope="module")
def auto(tmp_path_factory):
    """JAX's acceptance scenario (``auto_e2e``): healthy steps, an
    injected 8x on gpu-a, and the controller on its own.  The recorder's
    tick marks and the trainer's step times read a scripted clock, as in
    ``test_link_degrade_triggers_replan_schedule``: every healthy stage
    tick is the same, so only the injected 8x moves what the policy sees
    (with ``ewma`` 1.0 one slow baseline step on a loaded host would
    otherwise hide it)."""
    tee = _Tee(dict(patience=2, cooldown=4, baseline_steps=2, ewma=1.0,
                    min_gain=0.0))
    with mock.patch.object(trecorder, "time", _ScriptedTime(1e-3)), \
            mock.patch.object(ttrainer, "time", _ScriptedTime(1e-3)):
        t = _mk_trainer(tmp_path_factory.mktemp("auto"), policy=tee)
        with _WatchSearch() as seen:
            r1 = t.run(4)
            t.inject_degrade("gpu-a", 8.0)
            r2 = t.run(6)
    return dict(t=t, tee=tee, seen=seen, r1=r1, r2=r2)


def test_controller_replans_and_migrates_itself(auto):
    """JAX's invariants (``test_e2e_controller_replans_and_migrates_
    itself``)."""
    t = auto["t"]
    assert t.replans == 1 and t.migrations["memory"] == 1
    actions = [e.action for e in t.adapt_log]
    assert actions.count("trigger") == 1 and actions.count("migrate") == 1
    assert "skip" not in actions
    trig = next(e for e in t.adapt_log if e.action == "trigger")
    assert trig.detail["stage"] == 1 and trig.detail["factor"] >= 2.0
    rep = next(e for e in t.adapt_log if e.action == "replan")
    assert rep.detail["expected_gain"] > 0.0
    assert rep.detail["baseline_time"] > rep.detail["iter_time"]
    deg = sum(st.n_layers for st in t.plan.stages
              if t.cluster.groups[st.group].device.name == "gpu-a")
    assert deg < 3
    assert np.all(np.isfinite(auto["r2"]["losses"]))
    assert "expected_gain" in pol.events_json(t.adapt_log)


def test_controller_policy_answers_equal_jaxs(auto):
    """Every observation the trainer fed its policy got JAX's answer."""
    tee = auto["tee"]
    assert len(tee.pairs) >= 6
    for step, a, b in tee.pairs:
        assert a == b, step
    assert tee.gains and all(a == b for a, b in tee.gains)


def test_controller_search_and_log_equal_jaxs(auto):
    """The search the leader ran equals JAX's on the same store, cluster
    and baseline; the ``adapt_log`` equals the events JAX's policy answer
    and JAX's search give."""
    t, tee = auto["t"], auto["tee"]
    (cluster, kw, res), = auto["seen"]
    want = _jax_search(cluster, kw, res)
    assert res.plan.to_dict() == want.plan.to_dict()
    assert res.prediction.iter_time == want.prediction.iter_time
    assert res.baseline_time == want.baseline_time
    assert [list(x) for x in res.log] == [list(x) for x in want.log]
    step, fired, _ = next(p for p in tee.pairs if p[1] is not None)
    d = jpol.AdaptDecision(**fired)
    gain = want.expected_gain
    events = [
        jpol.AdaptEvent(step, "trigger", d.reason,
                        {"action": d.action, "signal": round(d.signal, 4),
                         "stage": d.stage, "factor": d.factor}),
        jpol.AdaptEvent(step, "replan",
                        f"searched {want.evaluated} candidates",
                        {"winner": want.plan.describe(),
                         "iter_time": want.prediction.iter_time,
                         "baseline_time": want.baseline_time,
                         "expected_gain": round(gain, 4)}),
        jpol.AdaptEvent(step, "migrate", "adopted the searched plan live",
                        {"plan": want.plan.describe(),
                         "migrations": {"memory": 1, "checkpoint": 0}})]
    assert [e.to_dict() for e in t.adapt_log] == \
        [e.to_dict() for e in events]
    assert cluster.groups[1].device.slowdown == pytest.approx(d.factor)


def test_controller_migration_equals_checkpoint_round_trip(auto,
                                                           tmp_path):
    """A twin without a policy takes the same steps and adopts the
    controller's plan at its step through the checkpoint: the states
    after the run are equal bit for bit."""
    t = auto["t"]
    trig = next(e for e in t.adapt_log if e.action == "trigger")
    m = _mk_trainer(tmp_path)
    m.run(4)
    m.inject_degrade("gpu-a", 8.0)
    m.run(trig.step - 4)
    m._adopt(ttrainer._AdoptedPlan(t.plan),
             m.cluster.degrade("gpu-a", trig.detail["factor"]),
             migrate="checkpoint")
    assert m.migrations == {"memory": 0, "checkpoint": 1}
    m.run(10 - trig.step)
    assert m.step == t.step == 10
    for path, a in _flat(t.state).items():
        b = _flat(m.state)[path]
        assert a.dtype == b.dtype and torch.equal(a, b), path


def _flat(tree, prefix=()):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
    else:
        out[prefix] = tree
    return out


def test_min_gain_gate_blocks_migration(tmp_path):
    """JAX's ``test_e2e_min_gain_gate_blocks_migration``: the search runs,
    the ε gate rejects, the state stays put."""
    policy = pol.ReplanPolicy(_cfg(patience=2, cooldown=4, baseline_steps=2,
                                   ewma=1.0, min_gain=0.95))
    t = _mk_trainer(tmp_path, policy=policy)
    t.run(4)
    t.inject_degrade("gpu-a", 8.0)
    t.run(8)    # JAX's 5, and 3 more for a noisy host clock
    actions = [e.action for e in t.adapt_log]
    assert "trigger" in actions and "skip" in actions
    assert "migrate" not in actions
    assert t.replans == 0 and t.migrations["memory"] == 0
    skip = next(e for e in t.adapt_log if e.action == "skip")
    assert skip.detail["expected_gain"] < 0.95
    assert t.plan.layers == (3, 3)


class _ScriptedTime:
    """A stand-in for the ``time`` module whose ``perf_counter`` advances
    by ``tick`` seconds a call, whatever the machine's load."""

    def __init__(self, tick: float):
        self.tick, self.t = tick, 0.0

    def perf_counter(self) -> float:
        self.t += self.tick
        return self.t


def test_link_degrade_triggers_replan_schedule(tmp_path, monkeypatch):
    """JAX's ``test_e2e_link_degrade_triggers_replan_schedule``: a slowed
    boundary link moves the bubble ratio alone, the decision is
    ``replan-schedule`` on the unchanged cluster.  The recorder's tick
    marks and the trainer's step times read a scripted clock (one fixed
    tick a reading), so every healthy stage tick is the same and only the
    injected link moves what the policy sees: with ``ewma`` 1.0 one slow
    step on a loaded host would otherwise name a stage."""
    monkeypatch.setattr(trecorder, "time", _ScriptedTime(1e-3))
    monkeypatch.setattr(ttrainer, "time", _ScriptedTime(1e-3))
    policy = pol.ReplanPolicy(_cfg(patience=2, cooldown=4, baseline_steps=2,
                                   ewma=1.0, min_gain=0.0))
    t = _mk_trainer(tmp_path, policy=policy)
    t.run(4)
    healthy = {g.device.name: g.device.effective_tflops
               for g in t.cluster.groups}
    h0 = t.schedule_health()
    assert h0 is not None and h0["ratio"] > 0.0
    t.inject_link_degrade(8.0 * policy.cfg.bubble_enter / h0["ratio"])
    assert t.schedule_health()["ratio"] > policy.cfg.bubble_enter
    r = t.run(6)
    trigs = [e for e in t.adapt_log if e.action == "trigger"]
    assert trigs and trigs[0].detail["action"] == "replan-schedule"
    assert all(e.detail["action"] == "replan-schedule" for e in trigs)
    assert "stage" not in trigs[0].detail
    assert {g.device.name: g.device.effective_tflops
            for g in t.cluster.groups} == healthy
    assert np.all(np.isfinite(r["losses"]))


def test_cadence_skips_off_steps_with_a_collective_aggregator(tmp_path):
    """With ``aggregate_every`` 3 and a collective aggregator, the gather
    and the decision run on steps 3 and 6 only, on every process alike."""
    calls = []

    class Counting(agg.ElectingFanIn):
        def gather(self, local):
            calls.append(("gather", t.step))
            return super().gather(local)

        def broadcast(self, obj):
            calls.append(("broadcast", t.step))
            return super().broadcast(obj)

    view = agg.MembershipView(1)
    policy = pol.ReplanPolicy(_cfg())
    t = Trainer(treg.get_bundle("llama3-8b", smoke=True, num_layers=6),
                TrainerConfig(global_batch=GB, seq_len=SEQ,
                              aggregate_every=3),
                plan=_plan(), device="cpu", cluster=_cluster(),
                profile_store=ProfileStore(), policy=policy,
                aggregator=Counting(view, 0),
                adapt_search_kw=ADAPT_SEARCH_KW)
    t.run(7)
    assert calls == [("gather", 3), ("broadcast", 3), ("gather", 6),
                     ("broadcast", 6)]


def test_adapt_flags_parse_as_jaxs():
    """The ``--adapt*`` knobs: JAX's defaults and derived exit band."""
    from repro.launch import train as jcli
    from repro_torch.launch import train as cli
    with pytest.raises(SystemExit):
        cli.main(["--help"])
    assert cli.membership_spec("gpu-a@6") == jcli.membership_spec("gpu-a@6")
    for bad in ("gpu-a", "gpu-a@x", "@3", "gpu-a@-1"):
        with pytest.raises(Exception) as a:
            cli.membership_spec(bad)
        with pytest.raises(Exception) as b:
            jcli.membership_spec(bad)
        assert str(a.value) == str(b.value)
    args = type("A", (), dict(pp=2, adapt=True, adapt_min_gain=0.05,
                              adapt_enter=3.0, adapt_exit=0.0,
                              adapt_patience=2.0, adapt_cooldown=8,
                              lose=[], join=[]))()
    policy, aggregator, kw = cli._controller(args)
    assert policy.cfg.straggler_exit == pytest.approx(
        3.0 * jpol.AdaptConfig.straggler_exit / jpol.AdaptConfig.straggler_enter)
    assert isinstance(aggregator, agg.LocalAggregator)
    assert kw["pp_options"] == [1, 2]
