"""The port's elastic membership (``Trainer.lose_node`` / ``join_node``,
the controller's forced replans, live migration onto the survivors and
back) against the JAX package's pieces, on the CPU.

The JAX ``Trainer``'s e2e membership tests fail under this jax, so the
port is held against the pieces they compose:

  * the one-process analogues of JAX's ``dp_e2e``, ``pp_e2e`` and
    ``leader_death_e2e`` fixtures (``tests/test_elastic.py:261-412``):
    JAX's clusters and plans; each forced replan's plan and scores ``==``
    JAX's ``planner.search`` on the same edited cluster and store; the
    migrated state equal bit for bit to the checkpoint-restart control;
    the losses of the whole run, across the plan changes, within 2e-5 of
    JAX's jitted ``make_train_step`` looped without a mesh (fp32, from
    JAX's initial state); the staleness marks and the expiry;
  * on gloo ranks (``parallel/launch.run_ranks``): 4 ranks on pp 2 x dp 2
    lose gpu-a to pp 2 x dp 1 on the two amd ranks and join back, every
    move bit for bit against ``split_state_for_rank`` of the checkpoint
    of its step, the survivors' next loss equal to a fresh rank
    trainer's on their gathered state, the leaving ranks holding nothing
    and still stepping, and as many process groups alive after as
    before; 2 ranks on pp 2 losing the leader's island, the survivor
    re-elected, searching and moving alone;
  * the train CLI's ``--lose`` / ``--join`` in one process and under
    ``torchrun --nproc-per-node 4``, with ``tools/validate_elastic.py``
    passing on its events and run log.
"""
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import cluster as JC  # noqa: E402
from repro.core import planner as jplanner  # noqa: E402
from repro.core.plan import ParallelPlan as JPlan  # noqa: E402
from repro.data.pipeline import SyntheticTokens as JTokens  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.parallel.sharding import ShardingRules as JRules  # noqa: E402
from repro.profile.model import ProfiledCostModel as JCostModel  # noqa
from repro.profile.store import ProfileStore as JStore  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch.adapt import ElectingFanIn, MembershipView  # noqa: E402
from repro_torch.core import cluster as C  # noqa: E402
from repro_torch.core import planner  # noqa: E402
from repro_torch.core.plan import ParallelPlan, StagePlacement  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.parallel import pipeline as tpp  # noqa: E402
from repro_torch.parallel import rank_programs  # noqa: E402
from repro_torch.parallel.launch import run_ranks  # noqa: E402
from repro_torch.parallel.sharding import ShardingRules  # noqa: E402
from repro_torch.profile.store import ProfileStore  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 120
GB, SEQ, LAYERS = 8, 32, 6
F32_TOL = 2e-5
# tests/test_elastic.py's search space
SEARCH_KW = dict(pp_options=[2], tp_options=[1], micro_bs_options=[1, 2],
                 require_fit=False, include_tp_comm=False,
                 schedule="1f1b", explore_orders=False)
BUNDLE_KW = dict(arch="llama3-8b", smoke=True, num_layers=LAYERS)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's in-process trainers (SMOKE
    sizes gain nothing from more), so that test workers running side by
    side do not oversubscribe the host's cores; restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _two_island(accel=1):
    return C.ClusterSpec(groups=(
        C.NodeGroup(C.AMD, 1, accel_per_node=accel),
        C.NodeGroup(C.GPU_A, 1, accel_per_node=accel)))


def _pp_plan():
    return ParallelPlan(stages=(StagePlacement(0, 3, 1, 1, False),
                                StagePlacement(1, 3, 1, 1, True)),
                        micro_bs=2, global_batch=GB, seq_len=SEQ)


@pytest.fixture(scope="module")
def jax_start():
    """JAX's fp32 SMOKE initial state and the losses of its jitted train
    step looped over the synthetic batches (no mesh): the reference
    every plan of the run computes."""
    jb = jreg.get_bundle("llama3-8b", smoke=True, num_layers=LAYERS)
    step = jax.jit(jsteps.make_train_step(
        jb, JRules(jb.cfg, tp=1, dp_axes=("data",)),
        jadamw.AdamWConfig()))
    state = jsteps.init_train_state(jb, jax.random.PRNGKey(0))
    start = jax.tree.map(np.asarray, state)
    data = JTokens(vocab_size=jb.cfg.vocab_size, seq_len=SEQ,
                   global_batch=GB)
    losses = []
    for i in range(8):
        state, metrics = step(state, data.batch_at(i))
        losses.append(float(metrics["loss"]))
    return start, losses


class _WatchSearch:
    """Every ``planner.search`` the trainers run: (cluster, keywords with
    the cost source's entries as the search saw them, result)."""

    def __init__(self):
        self.seen = []
        self._real = ttrainer.planner_mod.search
        self._patch = mock.patch.object(ttrainer.planner_mod, "search",
                                        self._search)

    def _search(self, cluster, cfg, **kw):
        res = self._real(cluster, cfg, **kw)
        src = kw.get("cost_source")
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


def _jax_search(cluster, kw):
    """JAX's ``planner.search`` on the JAX twin of ``cluster`` (its groups
    by kind and count), the same keywords, the cost source rebuilt over
    the same entries."""
    kinds = {"amd": JC.AMD, "gpu-a": JC.GPU_A}
    jcl = JC.ClusterSpec(groups=tuple(
        JC.NodeGroup(kinds[g.device.name], g.n_nodes,
                     accel_per_node=g.accel_per_node)
        for g in cluster.groups))
    kw = dict(kw)
    src, entries = kw.pop("cost_source", None), kw.pop("_entries")
    jkw = {k: v for k, v in kw.items()
           if k not in ("baseline_plan", "global_batch", "seq_len")}
    if kw.get("baseline_plan") is not None:
        jkw["baseline_plan"] = JPlan.from_dict(kw["baseline_plan"].to_dict())
    if src is not None:
        store = JStore()
        for dev, op, shape, value, meta in entries:
            store.put(dev, op, shape, value, meta)
        jkw["cost_source"] = JCostModel(store, device_map=src.device_map,
                                        time_scale=src.time_scale)
    jcfg = jreg.get_bundle("llama3-8b", smoke=True, num_layers=LAYERS).cfg
    return jplanner.search(jcl, jcfg, global_batch=GB, seq_len=SEQ, **jkw)


def _mk_elastic(tmp, cl, start, plan=None, aggregator=None, **kw):
    """``tests/test_elastic.py``'s ``_mk_elastic`` on the port, from JAX's
    initial state."""
    bundle = treg.get_bundle(**BUNDLE_KW)
    if plan is None:
        plan = planner.search(cl, bundle.cfg, global_batch=GB, seq_len=SEQ,
                              **dict(SEARCH_KW, **kw)).plan
    return Trainer(bundle,
                   TrainerConfig(global_batch=GB, seq_len=SEQ,
                                 ckpt_dir=str(Path(tmp) / "ckpt"),
                                 ckpt_every=100, replan_profile_min_obs=4),
                   plan=plan, cluster=cl, profile_store=ProfileStore(),
                   aggregator=aggregator, device="cpu",
                   state=convert.from_jax(start, device="cpu"),
                   adapt_search_kw=dict(SEARCH_KW, **kw))


def _snap(t):
    return {p: x.clone() for p, x in _flat(t.state).items()}


def _flat(tree, prefix=()):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
    else:
        out[prefix] = tree
    return out


def _bit_exact(a, b):
    assert a.keys() == b.keys()
    for p in a:
        assert a[p].dtype == b[p].dtype and torch.equal(a[p], b[p]), p


def _restart(t):
    """The checkpoint-restart control: the state restored from the
    checkpoint of this step (``_adopt`` wrote it before moving)."""
    keep = t.state
    assert t._init_or_restore(None)
    got = _snap(t)
    t.state = keep
    return got


def _assert_jax_losses(losses, want):
    np.testing.assert_allclose(losses, want[:len(losses)], rtol=0,
                               atol=F32_TOL)


@pytest.fixture(scope="module")
def dp_e2e(jax_start, tmp_path_factory):
    """dp-width shrink: two 2-accel islands run pp=2 dp=2; losing gpu-a
    leaves 2 accelerators (pp=2 dp=1); the rejoin restores the shape."""
    cl = _two_island(accel=2)
    t = _mk_elastic(tmp_path_factory.mktemp("dp"), cl, jax_start[0])
    plan0 = t.plan
    with _WatchSearch() as seen:
        r = t.run(3)
        t.lose_node("gpu-a")
        r1 = t.run(1)
        lost_plan = t.plan
        migrated, restarted = _snap(t), _restart(t)
        lost_mark = t.profile_store.departed_since("gpu-a")
        t.join_node("gpu-a")
        r2 = t.run(1)
        joined_plan = t.plan
        rejoined, rejoined_restart = _snap(t), _restart(t)
        r3 = t.run(2)
    return dict(t=t, plan0=plan0, lost_plan=lost_plan,
                joined_plan=joined_plan, migrated=migrated,
                restarted=restarted, rejoined=rejoined,
                rejoined_restart=rejoined_restart, lost_mark=lost_mark,
                seen=seen, losses=(r["losses"] + r1["losses"]
                                   + r2["losses"] + r3["losses"]))


def test_dp_width_shrinks_on_loss_and_restores_on_join(dp_e2e):
    t = dp_e2e["t"]
    assert [s.dp for s in dp_e2e["plan0"].stages] == [2, 2]
    assert [s.dp for s in dp_e2e["lost_plan"].stages] == [1, 1]
    assert dp_e2e["joined_plan"] == dp_e2e["plan0"]
    assert [g.device.name for g in t.cluster.groups] == ["amd", "gpu-a"]
    actions = [e.action for e in t.adapt_log]
    assert actions.count("node-lost") == 1
    assert actions.count("node-joined") == 1
    assert actions.count("migrate") == 2 and "skip" not in actions
    assert t.migrations["memory"] == 2 and t.replans == 2


@pytest.mark.parametrize("which", ["dp", "pp"])
def test_forced_replans_equal_jax_search(which, dp_e2e, pp_e2e):
    """Each membership search (the edited cluster, no baseline across the
    loss, the incumbent across the join) equals JAX's, and its event
    carries JAX's scores."""
    run = dp_e2e if which == "dp" else pp_e2e
    searches = [s for s in run["seen"]]
    assert len(searches) == 2
    replans = [e for e in run["t"].adapt_log if e.action == "replan"]
    for (cluster, kw, res), ev in zip(searches, replans):
        want = _jax_search(cluster, kw)
        assert res.plan.to_dict() == want.plan.to_dict()
        assert res.prediction.iter_time == want.prediction.iter_time
        assert res.baseline_time == want.baseline_time
        assert ev.detail["winner"] == want.plan.describe()
        assert ev.detail["iter_time"] == want.prediction.iter_time
    assert searches[0][1]["baseline_plan"] is None


@pytest.mark.parametrize("when", ["lost", "joined"])
def test_dp_migration_bit_exact_vs_checkpoint_restart(dp_e2e, when):
    if when == "lost":
        _bit_exact(dp_e2e["migrated"], dp_e2e["restarted"])
    else:
        _bit_exact(dp_e2e["rejoined"], dp_e2e["rejoined_restart"])


@pytest.mark.parametrize("which", ["dp", "pp", "leader"])
def test_losses_match_jax_train_step_across_plan_changes(
        which, dp_e2e, pp_e2e, leader_death_e2e, jax_start):
    """Every step of the run, whatever plan took it, within 2e-5 of JAX's
    jitted train step on the same batches from the same state."""
    run = {"dp": dp_e2e, "pp": pp_e2e, "leader": leader_death_e2e}[which]
    assert len(run["losses"]) >= 6
    _assert_jax_losses(run["losses"], jax_start[1])


def test_staleness_marks_follow_membership(dp_e2e):
    t = dp_e2e["t"]
    assert dp_e2e["lost_mark"] == 4           # marked at the loss step
    assert t.profile_store.departed_since("gpu-a") is None  # cleared


@pytest.fixture(scope="module")
def pp_e2e(jax_start, tmp_path_factory):
    """pp-depth change: two 1-accel islands run pp=2; the survivor alone
    cannot host 2 stages, so the replan goes to pp=1 — and back."""
    t = _mk_elastic(tmp_path_factory.mktemp("pp"), _two_island(accel=1),
                    jax_start[0], plan=_pp_plan(), pp_options=[1, 2])
    with _WatchSearch() as seen:
        r = t.run(3)
        t.lose_node("gpu-a")
        r1 = t.run(1)
        lost_plan = t.plan
        migrated, restarted = _snap(t), _restart(t)
        t.join_node("gpu-a")
        r2 = t.run(1)
        r3 = t.run(2)
    return dict(t=t, lost_plan=lost_plan, migrated=migrated,
                restarted=restarted, seen=seen,
                losses=r["losses"] + r1["losses"] + r2["losses"]
                + r3["losses"])


def test_pp_depth_changes_on_loss_and_back(pp_e2e):
    t = pp_e2e["t"]
    assert pp_e2e["lost_plan"].pp == 1
    assert t.plan.pp == 2
    assert t.migrations["memory"] == 2 and t.replans == 2
    assert not t._pipeline_active() or t.telemetry is not None


def test_pp_change_bit_exact_vs_checkpoint_restart(pp_e2e):
    _bit_exact(pp_e2e["migrated"], pp_e2e["restarted"])


@pytest.fixture(scope="module")
def leader_death_e2e(jax_start, tmp_path_factory):
    """THE LEADER DIES: this trainer is rank 1 of a simulated 2-rank
    membership; losing the island of rank 0 re-elects rank 1, which
    originates the node-lost directive, replans and migrates."""
    view = MembershipView(2)
    agg = ElectingFanIn(view, rank=1)
    t = _mk_elastic(tmp_path_factory.mktemp("leader"), _two_island(accel=1),
                    jax_start[0], plan=_pp_plan(), aggregator=agg,
                    pp_options=[1, 2])
    r = t.run(3)
    was_leader_before = agg.is_leader()
    t.lose_node("gpu-a", rank=0)
    r1 = t.run(1)
    migrated, restarted = _snap(t), _restart(t)
    r2 = t.run(2)
    return dict(t=t, agg=agg, view=view, migrated=migrated,
                restarted=restarted, was_leader_before=was_leader_before,
                losses=r["losses"] + r1["losses"] + r2["losses"])


def test_leader_death_reelects_and_replans(leader_death_e2e):
    t, agg = leader_death_e2e["t"], leader_death_e2e["agg"]
    assert not leader_death_e2e["was_leader_before"]
    assert agg.is_leader() and agg.leader_rank() == 1
    actions = [e.action for e in t.adapt_log]
    assert actions.index("re-elect") < actions.index("node-lost")
    assert "replan" in actions and "migrate" in actions
    assert t.plan.pp == 1 and t.replans == 1
    sent = [d for d in leader_death_e2e["view"].log if d is not None]
    assert len(sent) == 1 and sent[0]["membership"]["op"] == "lost"


def test_leader_death_migration_bit_exact(leader_death_e2e):
    _bit_exact(leader_death_e2e["migrated"], leader_death_e2e["restarted"])


def test_stale_profile_expires_after_window(jax_start, tmp_path):
    """JAX's ``test_e2e_stale_profile_expires_after_window``: a lost
    island's entries are kept inside ``profile_stale_steps``, then
    dropped; a rejoin inside the window keeps them."""
    cl = _two_island(accel=2)
    bundle = treg.get_bundle(**BUNDLE_KW)
    plan = planner.search(cl, bundle.cfg, global_batch=GB, seq_len=SEQ,
                          **SEARCH_KW).plan
    t = Trainer(bundle, TrainerConfig(global_batch=GB, seq_len=SEQ,
                                      ckpt_dir=str(tmp_path / "ckpt"),
                                      ckpt_every=100,
                                      replan_profile_min_obs=4,
                                      profile_stale_steps=3),
                plan=plan, cluster=cl, profile_store=ProfileStore(),
                device="cpu", adapt_search_kw=SEARCH_KW)
    t.profile_store.fold("gpu-a", "observed_stage_tick",
                         {"arch": "m", "stage": 1}, "tick_s", 0.9)
    t.run(2)
    t.lose_node("gpu-a")
    t.run(1)                                  # loss applied at step 3
    assert t.profile_store.departed_since("gpu-a") == 3
    assert t.profile_store.entries("gpu-a")   # kept: inside the window
    t.run(3)                                  # window (3 steps) passes
    assert t.profile_store.entries("gpu-a")
    t.run(1)                                  # next cadence expires it
    assert not t.profile_store.entries("gpu-a")
    assert t.profile_store.departed_since("gpu-a") is None
    # rejoining AFTER expiry still works — cold profile, fresh baseline
    t.join_node("gpu-a")
    t.run(1)
    assert [g.device.name for g in t.cluster.groups] == ["amd", "gpu-a"]
    assert t.plan == plan


def test_membership_errors_are_jaxs(jax_start, tmp_path):
    t = _mk_elastic(tmp_path, _two_island(accel=1), jax_start[0],
                    plan=_pp_plan(), pp_options=[1, 2])
    with pytest.raises(ValueError, match="unknown device kind 'tpu'"):
        t.lose_node("tpu")
    with pytest.raises(ValueError, match="no departed island of kind "
                       "'gpu-a' to rejoin"):
        t.join_node("gpu-a")
    with pytest.raises(ValueError, match="needs a device_kind"):
        t.join_node()
    bare = Trainer(treg.get_bundle(**BUNDLE_KW),
                   TrainerConfig(global_batch=GB, seq_len=SEQ), device="cpu")
    with pytest.raises(ValueError, match="lose_node needs a cluster"):
        bare.lose_node("amd")
    one = _mk_elastic(tmp_path / "one", _two_island().remove_group("gpu-a"),
                      jax_start[0], plan=ParallelPlan(
                          stages=(StagePlacement(0, LAYERS, 1, 1, True),),
                          micro_bs=2, global_batch=GB, seq_len=SEQ),
                      pp_options=[1])
    with pytest.raises(ValueError, match="last island"):
        one.lose_node("amd")


# ------------------------------------------------------- gloo ranks ----
@pytest.fixture(scope="module")
def rank_elastic(tmp_path_factory):
    """4 gloo ranks: JAX's dp_e2e cluster and plan (pp 2 x dp 2), gpu-a
    lost after step 3 and rejoined after step 4, two steps after."""
    cl = _two_island(accel=2)
    cfg = treg.get_bundle(**BUNDLE_KW).cfg
    plan = planner.search(cl, cfg, global_batch=GB, seq_len=SEQ,
                          **SEARCH_KW).plan
    d = str(tmp_path_factory.mktemp("ranks"))
    script = [(3, "lose", "gpu-a", None), (1, "join", "gpu-a", None),
              (1, None, None, None), (2, None, None, None)]
    res = run_ranks(rank_programs.elastic_ranks, 4, timeout_s=TIMEOUT,
                    device="cpu",
                    args=(BUNDLE_KW, plan.to_dict(),
                          [g.to_dict() for g in cl.groups], SEARCH_KW,
                          script, d))
    return dict(plan=plan, res=res, records=[r["records"] for r in res])


def test_ranks_lose_gpu_a_to_the_two_amd_ranks(rank_elastic):
    recs = rank_elastic["records"]
    plan = rank_elastic["plan"]
    assert [s.dp for s in plan.stages] == [2, 2]
    # after the loss: pp 2 x dp 1 on ranks 0 and 1, ranks 2 and 3 out
    lost = [r[1] for r in recs]
    rp = ParallelPlan.from_dict(lost[0]["run_plan"])
    assert (rp.pp, rp.dps) == (2, (1, 1))
    assert [r["grid"] and r["grid"][3] for r in lost] == \
        [[0, 1], [0, 1], None, None]
    assert lost[2]["state"] is None and lost[3]["state"] is None
    # the join brings back pp 2 x dp 2 on every rank
    joined = [r[2] for r in recs]
    assert all(r["grid"][3] == [0, 1, 2, 3] for r in joined)
    assert ParallelPlan.from_dict(joined[0]["run_plan"]) == plan
    for r in recs:
        acts = [e["action"] for e in r[-1]["events"]]
        assert acts.count("node-lost") == acts.count("node-joined") == 1
        assert acts.count("migrate") == 2
    assert recs[0][-1]["migrations"] == {"memory": 2, "checkpoint": 0}


def test_ranks_every_move_bit_for_bit_against_the_split(rank_elastic):
    """Each rank that holds state after a move holds exactly its
    ``split_state_for_rank`` of the checkpoint of the move's step."""
    n = 0
    for r in rank_elastic["records"]:
        for rec in r:
            if "move" in rec and rec["state"] is not None:
                assert rec["unequal"] == [], rec["step"]
                n += 1
    assert n == 2 + 4       # the loss on 2 survivors, the join on 4


def test_ranks_leaving_ranks_send_then_idle(rank_elastic):
    recs = rank_elastic["records"]
    for leaving in (2, 3):
        moves = [rec["move"] for rec in recs[leaving] if "move" in rec]
        assert moves[0]["sent_bytes"] > 0 and moves[0]["recv_bytes"] == 0
        assert recs[leaving][2]["losses"] == []      # stepped out
        assert moves[1]["recv_bytes"] > 0            # the join
    steps = {rec["step"] for r in recs for rec in r[1:2]}
    assert steps == {4}


def test_ranks_keep_their_process_groups(rank_elastic):
    recs = rank_elastic["records"]
    before = [r[0]["n_groups"] for r in recs]
    assert [r[-1]["n_groups"] for r in recs] == before
    assert recs[2][1]["n_groups"] < before[2]   # out: no grid groups


def test_ranks_losses_equal_across_ranks(rank_elastic):
    recs = rank_elastic["records"]
    for i in range(len(recs[0])):
        present = [r[i]["losses"] for r in recs if r[i]["losses"]]
        assert all(x == present[0] for x in present)


def test_ranks_survivors_next_loss_equals_a_fresh_rank_trainer(
        rank_elastic):
    """The survivors' gathered state after the loss, given to a fresh
    2-rank trainer of their plan: its next loss equals theirs."""
    recs = rank_elastic["records"]
    lost = [recs[r][1] for r in (0, 1)]
    rp = ParallelPlan.from_dict(lost[0]["run_plan"])
    rules = ShardingRules(treg.get_config(**BUNDLE_KW), tp=1)
    whole = tpp.gather_rank_states(
        [rank_programs._torch_tree(r["state"], torch.device("cpu"))
         for r in lost], rules, rp)
    whole = rank_programs._numpy_tree(whole)
    fresh = run_ranks(rank_programs.trainer_steps, 2, timeout_s=TIMEOUT,
                      device="cpu",
                      args=(BUNDLE_KW, rp.to_dict(), whole, 1, {}))
    nxt = recs[0][2]["losses"]       # the step after the loss
    assert fresh[0]["losses"] == nxt and fresh[1]["losses"] == nxt


def test_ranks_lose_the_leaders_island():
    """2 gloo ranks on pp 2: the island of rank 0 (amd, stage 0, the
    leader) leaves; rank 1 is re-elected, searches, and trains pp 1
    alone while rank 0 holds nothing."""
    cl = _two_island(accel=1)
    script = [(3, "lose", "amd", 0), (1, None, None, None),
              (2, None, None, None)]
    d = tempfile.mkdtemp()
    res = run_ranks(rank_programs.elastic_ranks, 2, timeout_s=TIMEOUT,
                    device="cpu",
                    args=(BUNDLE_KW, _pp_plan().to_dict(),
                          [g.to_dict() for g in cl.groups],
                          dict(SEARCH_KW, pp_options=[1, 2]), script, d))
    r0, r1 = res[0]["records"], res[1]["records"]
    acts1 = [e["action"] for e in r1[-1]["events"]]
    assert acts1.index("re-elect") < acts1.index("node-lost")
    assert "re-elect" not in [e["action"] for e in r0[-1]["events"]]
    assert r1[-1]["leader"] == r0[-1]["leader"] == 1
    assert r0[1]["grid"] is None and r0[1]["state"] is None
    assert r1[1]["grid"][3] == [1]
    assert ParallelPlan.from_dict(r1[1]["run_plan"]).pp == 1
    assert r1[1]["unequal"] == []
    assert r0[2]["losses"] == [] and len(r1[2]["losses"]) == 2
    assert np.all(np.isfinite(r1[2]["losses"]))


def test_pp1_rank_step_takes_the_plans_microbatches_one_at_a_time():
    """A pp 1 plan on ranks (the survivors' plan after a loss) whose
    replica rows split into m > 1 microbatches runs them one at a time,
    adding up the gradients: on 2 gloo ranks its losses and gradient
    norms equal the one-pass plan's (m 1) within 2e-5 (fp32)."""
    def plan(mbs):
        return ParallelPlan(stages=(StagePlacement(0, LAYERS, 2, 1, True),),
                            micro_bs=mbs, global_batch=GB, seq_len=SEQ)

    out = {}
    for mbs in (1, 4):
        assert plan(mbs).micro_batches == GB // (2 * mbs)
        res = run_ranks(rank_programs.trainer_steps, 2, timeout_s=TIMEOUT,
                        device="cpu",
                        args=(BUNDLE_KW, plan(mbs).to_dict(), None, 2, {}))
        assert res[0]["losses"] == res[1]["losses"]
        out[mbs] = res[0]
    np.testing.assert_allclose(out[1]["losses"], out[4]["losses"], rtol=0,
                               atol=F32_TOL)
    np.testing.assert_allclose(out[1]["grad_norms"], out[4]["grad_norms"],
                               rtol=F32_TOL, atol=0)


# ---------------------------------------------------------- the CLI ----
def _cli(args, tmp, nproc=1):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), TMPDIR=str(tmp),
               OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    head = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc-per-node={nproc}"] if nproc > 1
            else [sys.executable])
    cmd = head + ["-m", "repro_torch.launch.train", "--smoke",
                  "--device", "cpu", "--pp", "2", "--layers", "4",
                  "--global-batch", "4", "--seq", "16",
                  "--ckpt-dir", ""] + args
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300, cwd=str(tmp))
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


@pytest.mark.parametrize("nproc", [1, 4])
def test_cli_lose_join_passes_validate_elastic(nproc, tmp_path):
    """``--lose gpu-a@2 --join gpu-a@4``: two forced replans, moved in
    memory, in one process and under torchrun (each rank its own events
    file); ``tools/validate_elastic.py`` passes on rank 0's."""
    events = tmp_path / "events.jsonl"
    stdout = _cli(["--steps", "6", "--lose", "gpu-a@2", "--join",
                   "gpu-a@4", "--events-out", str(events)], tmp_path, nproc)
    log = tmp_path / "run.log"
    log.write_text(stdout)
    got = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "validate_elastic.py"),
         "--events", str(events), "--run-log", str(log)],
        capture_output=True, text=True)
    assert got.returncode == 0, got.stdout
    if nproc > 1:
        assert (tmp_path / "events.rank3.jsonl").exists()
    summary = json.loads(stdout.strip().splitlines()[-1])
    assert summary["steps"] == 6 and summary["world"] == nproc
    assert len(summary["moves"]) == 2
    assert "[train] membership: island gpu-a lost at step 2" in stdout
