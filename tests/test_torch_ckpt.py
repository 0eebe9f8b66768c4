"""The port's checkpoints (``repro_torch.ckpt.checkpoint`` and the
``Trainer``'s checkpoint half) against ``repro/ckpt/checkpoint.py`` and
JAX's jitted train step, on the CPU.

The state is JAX's SMOKE llama3-8b with bf16 parameters, so that it holds
bf16 leaves and an fp32 master beside the fp32 moments and int32 scalars:

  * (a) the format, both ways: JAX's ``save`` restores through the port
    equal to ``convert.from_jax`` of the state bit for bit, and the port's
    ``save`` of that state writes JAX's manifest and JAX's bytes, file for
    file, and restores through JAX's ``restore`` (bf16 leaves come back as
    2-byte voids, viewed through ``ml_dtypes``);
  * (b) the layout algebra: ``plan_layout`` and ``_norm_layout`` equal
    JAX's on planner plans and raise JAX's errors; ``migrate`` equals
    JAX's and composes to the identity (``tests/test_replan.py``'s cases,
    hypothesis included);
  * (c) ``AsyncCheckpointer``: ``tests/test_replan.py``'s error, race and
    keep-window cases, and the snapshot taken before ``save_async``
    returns;
  * (d) ``pipeline.rank_leaf_slices`` takes from a whole state what
    ``split_state_for_rank`` takes, and one rank writes each element;
  * (e) a restart from a checkpoint equals the uninterrupted run bit for
    bit on the reference, cp, one-card pp (1f1b, vpp 2) and rank routes;
  * (f) a stacked JAX pp checkpoint restores into the port's pp
    ``Trainer`` (``migrations["checkpoint"]`` 1), its next loss within
    2e-5 of JAX's jitted pp step;
  * (g) on gloo ranks (``parallel/launch.run_ranks``, each run killed after
    60 s): pp 2 x dp 2 with ZeRO-1, interleaved vpp 2, and pp 2 x tp 2
    write one checkpoint in parallel equal to ``gather_rank_states`` bit
    for bit; another plan's ranks restore the gathered state, and their
    next loss is within 2e-5 of one process's on that plan;
  * (h) the train CLI resumes with ``start_step``, in one process and
    under ``torchrun``.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import ml_dtypes  # noqa: E402  (a JAX dependency)

from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.core import cluster as jcluster  # noqa: E402
from repro.core import planner as jplanner  # noqa: E402
from repro.data.pipeline import SyntheticTokens as JTokens  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.parallel import pipeline as jpp  # noqa: E402
from repro.parallel.sharding import ShardingRules as JRules  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.core import cluster as tcluster  # noqa: E402
from repro_torch.core import planner as tplanner  # noqa: E402
from repro_torch.core.plan import ParallelPlan, StagePlacement  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import pipeline as tpp  # noqa: E402
from repro_torch.parallel import rank_programs, sharding  # noqa: E402
from repro_torch.parallel.launch import run_ranks  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 60
LOSS_TOL = 2e-5
SEQ = 32
BF16 = dict(param_dtype="bfloat16", dtype="bfloat16")
SMOKE4 = dict(arch="llama3-8b", smoke=True, num_layers=4, **BF16)
OPT = dict(lr=1e-2, warmup_steps=2)
IL = "interleaved-1f1b"


def _deadline(world: int) -> float:
    """``run_ranks``' wait for ``world`` ranks: TIMEOUT for two, scaled with
    the ranks beyond (each starts an interpreter and a process group, and
    shares the host's cores with the other test workers)."""
    return TIMEOUT * max(1.0, world / 2)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's in-process port code (SMOKE
    sizes gain nothing from more), so that test workers running side by
    side do not oversubscribe the host's cores; restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: x for k, v in tree.items()
                for p, x in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


def _assert_trees_equal(got, want):
    """Same key paths, dtypes and bits (torch tensors or numpy)."""
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        a, b = (x if torch.is_tensor(x) else torch.from_numpy(np.array(x))
                for x in (g[k], w[k]))
        assert a.dtype == b.dtype and torch.equal(a, b), k


def _step_dir(d, step):
    return Path(d) / f"step_{step:08d}"


# ---------------------------------------------------------- (a) format ----
@pytest.fixture(scope="module")
def jax_state():
    """JAX's bf16 SMOKE train state after one jitted step (m, v, master
    and the count all hold content)."""
    jb = jreg.get_bundle("llama3-8b", smoke=True, param_dtype="bfloat16")
    rules = JRules(jb.cfg, tp=1, dp_axes=("data",))
    step = jax.jit(jsteps.make_train_step(jb, rules, jadamw.AdamWConfig()))
    state = jsteps.init_train_state(jb, jax.random.PRNGKey(0))
    data = JTokens(vocab_size=jb.cfg.vocab_size, seq_len=16, global_batch=2)
    state, _ = step(state, data.batch_at(0))
    return jax.device_get(state)


EXTRA = {"data": {"seed": 0, "step": 1}, "layout": None}


def test_jax_checkpoint_restores_through_the_port(jax_state, tmp_path):
    jckpt.save(str(tmp_path), 1, jax_state, extra=EXTRA)
    want = convert.from_jax(jax_state, device="cpu")
    assert "master" in want["opt"]
    assert want["params"]["embed"].dtype == torch.bfloat16
    assert ckpt.latest_step(str(tmp_path)) == 1
    assert ckpt.manifest_extra(str(tmp_path), 1) == EXTRA
    got, extra = ckpt.restore(str(tmp_path), 1, want)
    assert extra == EXTRA
    _assert_trees_equal(got, want)
    # a meta target gives the shapes and dtypes; the leaves land on the CPU
    meta = adamw.tree_map(lambda t: t.to("meta"), want)
    got, _ = ckpt.restore(str(tmp_path), 1, meta)
    _assert_trees_equal(got, want)
    assert got["step"].shape == () and got["step"].dtype == torch.int32
    # a target of another shape is refused, naming the leaf
    bad = dict(want, params=dict(want["params"],
                                 embed=want["params"]["embed"][:-1]))
    with pytest.raises(ValueError, match="shape mismatch at params/embed"):
        ckpt.restore(str(tmp_path), 1, bad)


def test_port_checkpoint_is_jaxs_file_for_file(jax_state, tmp_path):
    jd, td = tmp_path / "jax", tmp_path / "port"
    jckpt.save(str(jd), 1, jax_state, extra=EXTRA)
    port = convert.from_jax(jax_state, device="cpu")
    ckpt.save(str(td), 1, port, extra=EXTRA)
    jm = json.loads((_step_dir(jd, 1) / "manifest.json").read_text())
    tm = json.loads((_step_dir(td, 1) / "manifest.json").read_text())
    assert tm == jm
    dtypes = {e["dtype"] for e in tm["leaves"]}
    assert dtypes == {"bfloat16", "float32", "int32"}
    assert {e["path"] for e in tm["leaves"]} >= {
        "params/_stacked", "opt/master/_stacked", "opt/count", "step"}
    for e in tm["leaves"]:
        a = (_step_dir(jd, 1) / "arrays" / e["file"]).read_bytes()
        b = (_step_dir(td, 1) / "arrays" / e["file"]).read_bytes()
        assert a == b, e
    # a 0-d int32 leaf, and a bf16 leaf as JAX writes it: a 2-byte void
    step = np.load(_step_dir(td, 1) / "arrays" / tm["leaves"][-1]["file"])
    assert tm["leaves"][-1]["path"] == "step"
    assert step.shape == () and step.dtype == np.int32 and int(step) == 1
    bf = next(e for e in tm["leaves"] if e["dtype"] == "bfloat16")
    assert np.load(_step_dir(td, 1) / "arrays" / bf["file"]).dtype.str \
        in ("<V2", "|V2")
    # JAX's restore of the port's checkpoint: bf16 bits through ml_dtypes
    back, extra = jckpt.restore(str(td), 1, jax_state)
    assert extra == EXTRA
    flat = jax.tree_util.tree_flatten_with_path(back)[0]
    for (kp, got), want in zip(flat, jax.tree.leaves(jax_state)):
        got = np.asarray(got)
        if got.dtype.kind == "V":
            got = got.view(ml_dtypes.bfloat16)
        want = np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, kp
        assert got.tobytes() == want.tobytes(), kp


def test_save_is_atomic_and_latest_counts_only_complete_steps(tmp_path):
    state = {"w": torch.arange(4, dtype=torch.float32)}
    ckpt.save(str(tmp_path), 3, state)
    (tmp_path / "step_00000007.tmp").mkdir()         # a save cut short
    (tmp_path / "step_00000009").mkdir()             # no manifest
    assert ckpt.all_steps(str(tmp_path)) == [3]
    assert ckpt.latest_step(str(tmp_path)) == 3
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    ckpt.clear_partial(str(tmp_path))
    assert not list(tmp_path.glob("*.tmp"))
    ckpt.save(str(tmp_path), 3, {"w": state["w"] + 1})   # replaces step 3
    got, _ = ckpt.restore(str(tmp_path), 3, state)
    assert torch.equal(got["w"], state["w"] + 1)


# ---------------------------------------------------------- (b) layouts ----
def _search(planner, cluster_mod, cfg, **kw):
    cl = cluster_mod.ClusterSpec(groups=(
        cluster_mod.NodeGroup(cluster_mod.AMD, 1, accel_per_node=1),
        cluster_mod.NodeGroup(cluster_mod.GPU_A, 1, accel_per_node=1)))
    return planner.search(cl, cfg, global_batch=8, seq_len=4096,
                          pp_options=[2], tp_options=[1],
                          micro_bs_options=[1, 2], require_fit=False,
                          include_tp_comm=False, **kw).plan


@pytest.mark.parametrize("kw", [dict(schedule="1f1b"),
                                dict(schedule=IL, vpp_options=[2])],
                         ids=["1f1b", "vpp2"])
def test_plan_layout_equals_jax_on_planner_plans(kw):
    tplan = _search(tplanner, tcluster, treg.get_config("llama3-8b"), **kw)
    jplan = _search(jplanner, jcluster, jreg.get_config("llama3-8b"), **kw)
    assert tplan.describe() == jplan.describe()
    want = jckpt.plan_layout(jplan)
    assert ckpt.plan_layout(tplan) == want
    assert ckpt._norm_layout(tplan) == jckpt._norm_layout(jplan) == want
    assert ckpt._norm_layout(want) == jckpt._norm_layout(want)
    assert ckpt.plan_layout(None) is None and ckpt._norm_layout(None) is None
    wide = dataclasses.replace(tplan, stages=tuple(
        dataclasses.replace(s, tp=2) for s in tplan.stages))
    assert ckpt.plan_layout(wide) == dict(want, stage_tp=[2, 2])


@pytest.mark.parametrize("stage_tp", [[], [1], [1, 0], "ab", [1, None]])
def test_norm_layout_raises_jaxs_error(stage_tp):
    lay = {"pp": 2, "vpp": 1, "virtual_layers": [2, 2], "stage_tp": stage_tp}
    with pytest.raises(ValueError) as want:
        jckpt._norm_layout(lay)
    with pytest.raises(ValueError) as got:
        ckpt._norm_layout(lay)
    assert str(got.value) == str(want.value)


def _toy_state(L, extra_master=True):
    rng = np.random.RandomState(0)
    params = {"blocks": {"w": rng.randn(L, 3, 2).astype(np.float32),
                         "b": rng.randn(L, 4).astype(np.float32)},
              "embed": rng.randn(5, 2).astype(np.float32)}
    opt = {"m": {"blocks": {"w": rng.randn(L, 3, 2).astype(np.float32),
                            "b": rng.randn(L, 4).astype(np.float32)},
                 "embed": np.zeros((5, 2), np.float32)},
           "v": {"blocks": {"w": rng.randn(L, 3, 2).astype(np.float32),
                            "b": rng.randn(L, 4).astype(np.float32)},
                 "embed": np.zeros((5, 2), np.float32)},
           "count": np.zeros((), np.int32)}
    if extra_master:
        opt["master"] = {"blocks": {"w": params["blocks"]["w"] * 1.0,
                                    "b": params["blocks"]["b"] * 1.0},
                         "embed": params["embed"] * 1.0}
    return adamw.tree_map(torch.from_numpy,
                          {"params": params, "opt": opt,
                           "step": np.zeros((), np.int32)})


def _rand_layout(rng, L):
    pp = rng.randint(1, 4)
    vpp = rng.randint(1, 3)
    V = pp * vpp
    if L < V:
        return None
    cuts = sorted(rng.choice(range(1, L), size=V - 1, replace=False)) \
        if V > 1 else []
    vl = [int(b - a) for a, b in zip([0] + list(cuts), list(cuts) + [L])]
    out = {"pp": pp, "vpp": vpp, "virtual_layers": vl}
    if rng.rand() < 0.75:
        out["stage_tp"] = [int(rng.choice([1, 2, 4, 8]))
                           for _ in range(pp)]
    return out


def test_migrate_equals_jax():
    rng = np.random.RandomState(3)
    n = 0
    while n < 12:
        L = rng.randint(2, 13)
        la, lb = _rand_layout(rng, L), _rand_layout(rng, L)
        if la is None or lb is None:
            continue
        n += 1
        state = _toy_state(L)
        jstate = adamw.tree_map(lambda t: t.numpy(), state)
        got = ckpt.migrate(ckpt.migrate(state, None, la), la, lb)
        want = jckpt.migrate(jckpt.migrate(jstate, None, la), la, lb)
        _assert_trees_equal(got, jax.tree.map(np.asarray, want))


def test_migrate_roundtrip_seeded():
    """canonical -> layout A -> layout B -> canonical is the identity on
    every real layer, for params and every optimizer moment tree."""
    rng = np.random.RandomState(7)
    for _ in range(25):
        L = rng.randint(2, 13)
        state = _toy_state(L)
        la = _rand_layout(rng, L)
        lb = _rand_layout(rng, L)
        if la is None or lb is None:
            continue
        a = ckpt.migrate(state, None, la)
        b = ckpt.migrate(a, la, lb)
        _assert_trees_equal(ckpt.migrate(b, lb, None), state)


@given(st.integers(2, 12), st.integers(0, 2 ** 30))
@settings(max_examples=40, deadline=None)
def test_migrate_roundtrip_property(L, seed):
    rng = np.random.RandomState(seed % (2 ** 31 - 1))
    la = _rand_layout(rng, L)
    lb = _rand_layout(rng, L)
    if la is None or lb is None:
        return
    state = _toy_state(L, extra_master=False)
    out = ckpt.migrate(ckpt.migrate(ckpt.migrate(state, None, la), la, lb),
                       lb, None)
    _assert_trees_equal(out, state)
    # stacked shapes honour the layout
    stacked = ckpt.migrate(state, None, la)
    w = stacked["params"]["blocks"]["w"]
    lmax = max(la["virtual_layers"])
    want = ((la["pp"], lmax, 3, 2) if la["vpp"] == 1
            else (la["pp"], la["vpp"], lmax, 3, 2))
    assert tuple(w.shape) == want


def test_migrate_tp_width_change_bit_exact_vs_checkpoint_restart(tmp_path):
    """Migrating a live state across a tp-width-changing layout equals
    restoring the pre-change checkpoint and migrating that."""
    L = 6
    state = _toy_state(L)
    old = {"pp": 2, "vpp": 1, "virtual_layers": [3, 3], "stage_tp": [1, 1]}
    new = {"pp": 3, "vpp": 1, "virtual_layers": [2, 2, 2],
           "stage_tp": [4, 2, 1]}
    stacked = ckpt.migrate(state, None, old)
    ckpt.save(str(tmp_path), 1, stacked, extra={"layout": old})
    live = ckpt.migrate(stacked, old, new)
    restored, _ = ckpt.restore(str(tmp_path), 1, stacked)
    _assert_trees_equal(live, ckpt.migrate(restored, old, new))
    _assert_trees_equal(ckpt.migrate(live, new, None), state)


def test_migrate_tp_only_delta_and_legacy_default():
    stacked = ckpt.migrate(_toy_state(4), None,
                           {"pp": 2, "vpp": 1, "virtual_layers": [2, 2],
                            "stage_tp": [1, 1]})
    la = {"pp": 2, "vpp": 1, "virtual_layers": [2, 2], "stage_tp": [1, 1]}
    lb = {"pp": 2, "vpp": 1, "virtual_layers": [2, 2], "stage_tp": [8, 2]}
    assert ckpt._norm_layout(la) != ckpt._norm_layout(lb)
    _assert_trees_equal(ckpt.migrate(stacked, la, lb), stacked)
    legacy = {"pp": 2, "vpp": 1, "virtual_layers": [2, 2]}
    assert ckpt._norm_layout(legacy)["stage_tp"] == [1, 1]
    assert ckpt._norm_layout(legacy) == ckpt._norm_layout(la)


# ------------------------------------------- (c) the async checkpointer ----
def _tiny_state():
    return {"w": torch.arange(8, dtype=torch.float32)}


def test_async_ckpt_error_raised_once_not_sticky(monkeypatch, tmp_path):
    ck = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    real_save = ckpt.save

    def failing_save(*a, **k):
        raise RuntimeError("disk on fire")

    monkeypatch.setattr(ckpt, "save", failing_save)
    ck.save_async(1, _tiny_state())
    with pytest.raises(RuntimeError, match="disk on fire"):
        ck.wait()
    ck.wait()                       # error consumed: must not re-raise
    monkeypatch.setattr(ckpt, "save", real_save)
    ck.save_async(2, _tiny_state())
    ck.wait()
    assert ckpt.latest_step(str(tmp_path)) == 2


def test_async_ckpt_concurrent_wait_save_keeps_window(monkeypatch,
                                                      tmp_path):
    """``wait()`` racing ``save_async()`` from threads around a slowed
    save: afterwards exactly the newest ``keep`` steps exist, complete, no
    ``.tmp`` remains and no error surfaced."""
    real_save = ckpt.save

    def slow_save(*a, **k):
        time.sleep(0.01)
        return real_save(*a, **k)

    monkeypatch.setattr(ckpt, "save", slow_save)
    ck = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    N = 12
    errs = []

    def writer(i):
        try:
            ck.save_async(i, _tiny_state())
        except BaseException as e:   # noqa: BLE001
            errs.append(e)

    def waiter():
        try:
            ck.wait()
        except BaseException as e:   # noqa: BLE001
            errs.append(e)

    threads = []
    for i in range(1, N + 1):
        threads.append(threading.Thread(target=writer, args=(i,)))
        threads.append(threading.Thread(target=waiter))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    ck.wait()
    with ck._lock:
        ck._gc()                     # settle the window deterministically
    assert not errs
    steps = ckpt.all_steps(str(tmp_path))
    assert len(steps) == 2 and steps[-1] <= N
    assert not list(Path(tmp_path).glob("*.tmp"))
    for s in steps:                  # every survivor is complete
        assert (_step_dir(tmp_path, s) / "manifest.json").exists()
        state, _ = ckpt.restore(str(tmp_path), s, _tiny_state())
        assert torch.equal(state["w"], _tiny_state()["w"])


def test_async_ckpt_gc_keep_window_sequential(tmp_path):
    ck = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in range(1, 6):
        ck.save_async(s, _tiny_state())
    ck.wait()
    assert ckpt.all_steps(str(tmp_path)) == [4, 5]


def test_async_ckpt_snapshots_before_returning(monkeypatch, tmp_path):
    """The train step updates its state in place right after
    ``save_async`` returns: the checkpoint holds the state as it was at
    the call, even when the write starts later."""
    go = threading.Event()
    real_save = ckpt.save

    def held_save(*a, **k):
        go.wait(10)
        return real_save(*a, **k)

    monkeypatch.setattr(ckpt, "save", held_save)
    ck = ckpt.AsyncCheckpointer(str(tmp_path))
    state = _tiny_state()
    ck.save_async(1, state)
    state["w"].mul_(-1)              # the next step, in place
    go.set()
    ck.wait()
    got, _ = ckpt.restore(str(tmp_path), 1, state)
    assert torch.equal(got["w"], _tiny_state()["w"])
    assert ck.timings["bytes"] == 32 and ck.timings["write_s"] >= 0


# ------------------------------------------------ (d) the rank map ----
def _plan(vl, vpp, dp, tp, gb=8):
    pp = len(vl) // vpp
    return ParallelPlan(
        stages=tuple(StagePlacement(s, sum(vl[s::pp]), dp, tp, s == pp - 1)
                     for s in range(pp)),
        micro_bs=1, global_batch=gb, seq_len=SEQ,
        schedule=IL if vpp > 1 else "1f1b", vpp=vpp,
        chunk_layers=tuple(vl) if vpp > 1 else None)


def _take(whole, slices):
    """A rank's state cut from a whole one by its ``rank_leaf_slices``."""
    if isinstance(slices, dict):
        return {k: _take(whole[k], v) for k, v in slices.items()}
    out = torch.empty(slices.shape, dtype=whole.dtype)
    for local, part in slices.pieces:
        out[local] = whole[part]
    return out


def _ranks(plan, tp):
    return [(s, q, r) for s in range(plan.pp) for q in range(plan.dps[0])
            for r in range(tp)]


def _written_once(whole, plan, rules):
    """Every element of every leaf has exactly one writer over the plan's
    ranks."""
    count = {k: torch.zeros(v.shape, dtype=torch.int32)
             for k, v in _flat(whole).items()}
    for s, q, r in _ranks(plan, rules.tp):
        sl = tpp.rank_leaf_slices(whole, plan, s, rules, r, replica=q)
        for k, x in _flat(sl).items():
            assert x.whole == tuple(count[k].shape)
            if x.writer:
                for _, part in x.pieces:
                    count[k][part] += 1
    for k, c in count.items():
        assert bool((c == 1).all()), (k, int(c.min()), int(c.max()))


MAP_CASES = [("vpp2", (2, 1, 1, 0), 2, 1, 1),
             ("vpp2-dp2", (1, 2, 0, 1), 2, 2, 1), ("pp1-dp4", (4,), 1, 4, 1),
             ("pp2-dp2-tp2", (3, 1), 1, 2, 2),
             ("vpp2-dp2-tp2", (1, 1, 1, 1), 2, 2, 2),
             ("pp2-tp4-kv-replicated", (3, 1), 1, 1, 4),
             ("vpp2-zero-crosses-chunks", (3, 0, 1, 4), 2, 2, 1)]


@pytest.mark.parametrize("case", MAP_CASES, ids=lambda c: c[0])
def test_rank_leaf_slices_take_what_split_state_for_rank_takes(case):
    _, vl, vpp, dp, tp = case
    b = treg.get_bundle("llama3-8b", smoke=True,
                        num_layers=sum(vl), **BF16)
    rules = sharding.ShardingRules(b.cfg, tp=tp)
    whole = tsteps.init_train_state(b, seed=0, device="cpu")
    for t in adamw.tree_leaves(whole["opt"]["m"]):
        t.normal_()     # content, so that a misplaced slice shows
    plan = _plan(vl, vpp, dp, tp)
    meta = tsteps.train_state_shapes(b)
    for s, q, r in _ranks(plan, tp):
        want = tpp.split_state_for_rank(whole, plan, s, rules, r, replica=q)
        sl = tpp.rank_leaf_slices(meta, plan, s, rules, r, replica=q)
        got = _take(whole, sl)
        assert list(_flat(got)) == list(_flat(want))
        _assert_trees_equal(got, want)
    _written_once(meta, plan, rules)


@pytest.mark.parametrize("case", MAP_CASES, ids=lambda c: c[0])
def test_save_rank_writes_the_whole_state_and_restore_rank_reads_a_share(
        case, tmp_path):
    """Every rank of the plan (a thread each: the ranks meet only through
    files) writes its own elements of one checkpoint of a whole state; the
    checkpoint equals the whole state, and each rank's ``restore_rank``
    equals its ``split_state_for_rank``, here and under another plan."""
    _, vl, vpp, dp, tp = case
    b = treg.get_bundle("llama3-8b", smoke=True,
                        num_layers=sum(vl), **BF16)
    rules = sharding.ShardingRules(b.cfg, tp=tp)
    whole = tsteps.init_train_state(b, seed=0, device="cpu")
    for t in adamw.tree_leaves(whole["opt"]):
        t.normal_() if t.is_floating_point() else t.fill_(7)
    plan = _plan(vl, vpp, dp, tp)
    meta = tsteps.train_state_shapes(b)
    ranks = _ranks(plan, tp)
    errors = []

    def write(rank, s, q, r):
        try:
            sl = tpp.rank_leaf_slices(meta, plan, s, rules, r, replica=q)
            own = tpp.split_state_for_rank(whole, plan, s, rules, r,
                                           replica=q)
            ckpt.save_rank(str(tmp_path), 5, own,
                           ckpt.RankPart(sl, meta, rank, len(ranks)),
                           extra={"layout": None}, timeout_s=30)
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=write, args=(i, *rk))
               for i, rk in enumerate(ranks)]
    for t in threads[::-1]:     # rank 0 last: the others wait for it
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert ckpt.all_steps(str(tmp_path)) == [5]
    assert sorted(p.name for p in _step_dir(tmp_path, 5).iterdir()) == \
        ["arrays", "manifest.json"]
    got, extra = ckpt.restore(str(tmp_path), 5, meta)
    assert extra == {"layout": None}
    _assert_trees_equal(got, whole)
    other = _plan((1, sum(vl) - 1), 1, 2, 1)
    orules = sharding.ShardingRules(b.cfg, tp=1)
    for p, rl in ((plan, rules), (other, orules)):
        for s, q, r in _ranks(p, rl.tp):
            sl = tpp.rank_leaf_slices(meta, p, s, rl, r, replica=q)
            mine, _ = ckpt.restore_rank(str(tmp_path), 5, sl)
            _assert_trees_equal(mine, tpp.split_state_for_rank(
                whole, p, s, rl, r, replica=q))


# ------------------------------------- (e) restart on one process ----
def _one_card_plans():
    cp = ParallelPlan(stages=(StagePlacement(0, 4, 4, 1, True),),
                      micro_bs=1, global_batch=2, seq_len=SEQ, cp=4,
                      cp_chunks=(10, 8, 8, 6))
    pp = ParallelPlan(stages=(StagePlacement(0, 3, 1, 1),
                              StagePlacement(1, 1, 1, 1, True)),
                      micro_bs=1, global_batch=4, seq_len=SEQ)
    return {"reference": None, "cp": cp, "pp": pp,
            "pp-vpp2": _plan((2, 1, 1, 0), 2, 1, 1, gb=4)}


@pytest.mark.parametrize("route", ["reference", "cp", "pp", "pp-vpp2"])
def test_restart_equals_the_uninterrupted_run(route, tmp_path):
    """2 steps (saving at step 2), then 2 more in the same trainer,
    against a new trainer from the step-2 checkpoint taking those 2:
    losses and the final state equal bit for bit."""
    plan = _one_card_plans()[route]
    gb = 2 if plan is None else plan.global_batch
    b = treg.get_bundle(**SMOKE4)
    cfg = TrainerConfig(global_batch=gb, seq_len=SEQ,
                        ckpt_dir=str(tmp_path), ckpt_every=2)
    opt = adamw.AdamWConfig(**OPT)
    a = Trainer(b, cfg, plan=plan, opt_cfg=opt, device="cpu")
    assert a._cp_active() == (route == "cp")
    assert a._pipeline_active() == route.startswith("pp")
    assert a.step == 0 and a.migrations == {"memory": 0, "checkpoint": 0}
    a.run(2)
    assert ckpt.all_steps(str(tmp_path)) == [2]
    losses = a.run(2)["losses"]
    assert ckpt.all_steps(str(tmp_path)) == [2, 4]
    shutil.rmtree(_step_dir(tmp_path, 4))
    r = Trainer(b, cfg, plan=plan, opt_cfg=opt, device="cpu")
    assert r.step == 2 and r.data.state.step == 2
    assert int(r.state["step"]) == 2 and r.migrations["checkpoint"] == 0
    assert r.run(2)["losses"] == losses
    _assert_trees_equal(r.state, a.state)
    with pytest.raises(ValueError, match="holds a checkpoint of step 4"):
        Trainer(b, cfg, plan=plan, opt_cfg=opt, state=a.state, device="cpu")


# ------------------------------------------- (f) a JAX pp checkpoint ----
def test_jax_pp_checkpoint_restores_into_the_pp_trainer(tmp_path):
    """JAX's pp train state, stacked ``(pp, Lmax, ...)`` under the
    planner's (3, 1) plan after two jitted pp steps, saved by JAX with its
    layout: the port's pp ``Trainer`` restores it canonical (one
    checkpoint migration), equal to the unstacked JAX state, and its next
    loss is within 2e-5 of JAX's next step."""
    plan = ParallelPlan(stages=(StagePlacement(0, 3, 1, 1),
                                StagePlacement(1, 1, 1, 1, True)),
                        micro_bs=1, global_batch=4, seq_len=SEQ)
    m, vl, gb = plan.micro_batches, list(plan.virtual_layers), 4
    kw = dict(smoke=True, num_layers=4)
    jb, tb = jreg.get_bundle("llama3-8b", **kw), treg.get_bundle(
        "llama3-8b", **kw)
    rules = JRules(jb.cfg, tp=1, dp_axes=("data",))
    jloss = jpp.make_pp_loss_fn(jb.cfg, None, plan.pp, m,
                                layers_per_stage=vl, stage_tp=[1, 1])
    step = jax.jit(jsteps.make_train_step(jb, rules,
                                          jadamw.AdamWConfig(**OPT),
                                          loss_fn=jloss))
    start = jsteps.init_train_state(jb, jax.random.PRNGKey(0))
    stack = lambda tree: jpp.stack_blocks_for_stages(  # noqa: E731
        tree, plan.pp, vl)
    state = dict(start, params=stack(start["params"]),
                 opt=dict(start["opt"], m=stack(start["opt"]["m"]),
                          v=stack(start["opt"]["v"])))
    data = JTokens(vocab_size=jb.cfg.vocab_size, seq_len=SEQ,
                   global_batch=gb)
    batch = lambda i: {k: v.reshape(m, gb // m, *v.shape[1:])  # noqa: E731
                       for k, v in data.batch_at(i).items()}
    for i in range(2):
        state, _ = step(state, batch(i))
    layout = jckpt.plan_layout(plan)
    jckpt.save(str(tmp_path), 2, state,
               extra={"data": {"seed": 0, "step": 2}, "layout": layout})
    want_state = ckpt.migrate(convert.from_jax(jax.device_get(state),
                                               device="cpu"), layout, None)
    _, metrics = step(state, batch(2))

    t = Trainer(tb, TrainerConfig(global_batch=gb, seq_len=SEQ,
                                  ckpt_dir=str(tmp_path)), plan=plan,
                opt_cfg=adamw.AdamWConfig(**OPT), device="cpu")
    assert t._pipeline_active() and t.step == 2
    assert t.migrations == {"memory": 0, "checkpoint": 1}
    _assert_trees_equal(t.state, want_state)
    loss = t.run(1)["losses"][0]
    assert abs(loss - float(metrics["loss"])) < LOSS_TOL


# -------------------------------------------------------- (g) ranks ----
def _gather(res, i, plan, rules):
    """The whole state from the ranks' ``states[i]``."""
    return tpp.gather_rank_states(
        [adamw.tree_map(torch.from_numpy, r["states"][i]) for r in res],
        rules, plan)


def _values(tree):
    """bf16 widened to fp32, as the rank programs return leaves."""
    return adamw.tree_map(lambda t: t.float() if t.dtype == torch.bfloat16
                          else t, tree)


def _pp_train(plan, d, steps, every, start=0, after=0):
    """``rank_programs.pp_train`` on the plan's ranks with checkpoints in
    ``d``, keeping every rank's states."""
    world = plan.pp * plan.dps[0] * plan.tps[0]
    return run_ranks(rank_programs.pp_train, world, device="cpu",
                     timeout_s=_deadline(world),
                     args=(SMOKE4, plan.to_dict(), steps, OPT, False, d,
                           every, start, after, True))


def _writer_bytes(whole, plan, rules, r):
    """The bytes of the leaves rank ``r`` (a ``pp_train`` result) writes."""
    sl = tpp.rank_leaf_slices(whole, plan, r["stage"], rules,
                              r["model_rank"], replica=r["replica"])
    flat = _flat(whole)
    return sum(int(np.prod(x.shape)) * flat[k].element_size()
               for k, x in _flat(sl).items() if x.writer)


# (id, the plan written under, the plan restored under)
RANK_CASES = [
    ("pp2-dp2-zero1", _plan((3, 1), 1, 2, 1), _plan((4,), 1, 4, 1)),
    ("pp2-vpp2", _plan((2, 1, 1, 0), 2, 1, 1), _plan((1, 3), 1, 2, 1)),
    ("pp2-tp2", _plan((3, 1), 1, 1, 2), _plan((4,), 1, 2, 1)),
]


@pytest.mark.parametrize("case", RANK_CASES, ids=lambda c: c[0])
def test_ranks_write_one_checkpoint_that_any_plan_restores(case, tmp_path):
    """Ranks of ``plan`` take 2 steps (saving at step 2, every rank its
    own elements, its snapshot only the leaves it writes) and a third:
    the checkpoint's leaves equal ``gather_rank_states`` of the ranks'
    step-2 states bit for bit, each element written once.  The ranks of
    ``other`` restore the gathered state and step once, their loss within
    2e-5 of one process's on ``other``.  pp 2 x dp 2 also restarts under
    its own plan and equals its uninterrupted third step bit for bit."""
    name, plan, other = case
    b = treg.get_bundle(**SMOKE4)
    d, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    res = _pp_train(plan, d, 2, 2, after=1)
    assert ckpt.all_steps(d) == [2]
    rules = sharding.ShardingRules(b.cfg, tp=plan.tps[0])
    at2 = _gather(res, 1, plan, rules)
    meta = tsteps.train_state_shapes(b)
    snap = [r["ckpt"]["bytes"] for r in res]
    assert snap == [_writer_bytes(meta, plan, rules, r) for r in res]
    for r, n in zip(res, snap):     # another rank writes some leaves
        if r["replica"] or r["model_rank"]:
            assert n < r["param_bytes"] + r["opt_bytes"], (r["rank"], n)
    saved, extra = ckpt.restore(d, 2, meta)
    assert extra == {"data": {"seed": 0, "step": 2}, "layout": None}
    assert saved["params"]["embed"].dtype == torch.bfloat16
    _assert_trees_equal(_values(saved), at2)
    _written_once(meta, plan, rules)
    shutil.copytree(_step_dir(d, 2), _step_dir(d2, 2))

    if name == "pp2-dp2-zero1":     # a restart on the same plan
        again = _pp_train(plan, d, 1, 100, start=2)
        for r, a in zip(again, res):
            assert r["losses"][0] == a["after_losses"][0]
            _assert_trees_equal(r["states"][1], a["states"][2])

    moved = _pp_train(other, d2, 1, 100, start=2)
    orules = sharding.ShardingRules(b.cfg, tp=other.tps[0])
    _assert_trees_equal(_gather(moved, 0, other, orules), at2)
    one = Trainer(b, TrainerConfig(global_batch=other.global_batch,
                                   seq_len=SEQ, ckpt_dir=d2,
                                   ckpt_every=100),
                  plan=other, opt_cfg=adamw.AdamWConfig(**OPT),
                  device="cpu")
    assert one.step == 2
    want = one.run(1)["losses"][0]
    for r in moved:
        assert abs(r["losses"][0] - want) < LOSS_TOL


def test_rank_leaf_slices_need_rules_at_dp_above_one():
    meta = tsteps.train_state_shapes(treg.get_bundle(**SMOKE4))
    with pytest.raises(ValueError, match="pass rules"):
        tpp.rank_leaf_slices(meta, _plan((4,), 1, 2, 1), 0)


# ---------------------------------------------------------- (h) the CLI ----
CLI = ["--smoke", "--device", "cpu", "--pp", "2", "--global-batch", "4",
       "--seq", "16"]


def _cli(capsys, *args):
    train_cli.main(CLI + list(args))
    lines = capsys.readouterr().out.strip().splitlines()
    return lines, json.loads(lines[-1])


def test_train_cli_default_ckpt_dir_is_under_tmpdir(capsys, tmp_path,
                                                     monkeypatch):
    """Without ``--ckpt-dir`` the CLI saves to and resumes from
    ``repro_train`` under ``$TMPDIR``, and leaves ``/tmp/repro_train``
    as it found it."""
    def listing(d):
        return sorted((str(p), p.stat().st_mtime_ns) for p in d.rglob("*")) \
            if d.is_dir() else None

    stray = Path("/tmp/repro_train")
    before = listing(stray)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)
    args = ["--smoke", "--device", "cpu", "--global-batch", "2", "--seq",
            "16"]
    train_cli.main(args + ["--steps", "2", "--ckpt-every", "2"])
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (first["start_step"], first["steps"]) == (0, 2)
    assert ckpt.all_steps(str(tmp_path / "repro_train")) == [2]
    train_cli.main(args + ["--steps", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert any("start_step=2" in ln for ln in lines)
    assert json.loads(lines[-1])["steps"] == 3
    assert listing(stray) == before


def test_train_cli_resumes_in_one_process_and_under_torchrun(capsys,
                                                             tmp_path):
    """One process saves at step 2; two ``torchrun`` ranks resume there
    (``start_step`` 2) and save at step 4; one process resumes at 4 and
    takes step 5: its loss within 2e-5 of an uninterrupted 5-step run."""
    d = str(tmp_path / "run")
    lines, first = _cli(capsys, "--steps", "2", "--ckpt-every", "2",
                        "--ckpt-dir", d)
    assert (first["start_step"], first["steps"]) == (0, 2)
    assert ckpt.all_steps(d) == [2]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *CLI,
         "--steps", "2", "--ckpt-every", "2", "--ckpt-dir", d],
        cwd=str(ROOT), env=env, capture_output=True, text=True,
        timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr[-3000:]
    ranks = json.loads(r.stdout.strip().splitlines()[-1])
    assert "start_step=2" in r.stdout
    assert (ranks["world"], ranks["start_step"], ranks["steps"]) == (2, 2, 4)
    assert ckpt.all_steps(d) == [2, 4]
    lines, last = _cli(capsys, "--steps", "1", "--ckpt-dir", d)
    assert any("start_step=4" in ln for ln in lines)
    assert (last["start_step"], last["steps"]) == (4, 5)
    _, whole = _cli(capsys, "--steps", "5", "--ckpt-dir",
                    str(tmp_path / "whole"))
    assert whole["start_step"] == 0
    assert abs(last["final_loss"] - whole["final_loss"]) < LOSS_TOL
    np.testing.assert_allclose(ranks["rank_losses"][0],
                               whole["rank_losses"][0][2:4], atol=LOSS_TOL)
