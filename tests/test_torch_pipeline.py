"""The port's pipeline (``repro_torch.parallel.pipeline``) and ICCL tap
against the JAX package, fp32 on the CPU.

The same weights (JAX's SMOKE llama3-8b at 4 layers, converted) and the
same microbatched tokens go through ``repro.parallel.pipeline.
make_pp_loss_fn``, run as ``tests/test_pipeline_moe.py`` runs it (jitted,
no mesh, stacked ``(pp[, vpp], Lmax, ...)`` blocks), and through the
port's loss on the canonical ``(L, ...)`` tree:

  * loss within 2e-5 (the fp32 row of ``tests/test_kernels.py:15-17``) and
    every parameter gradient within 1e-4 (the JAX pp tests' bound), the
    JAX gradients unstacked by the port's ``unstack_blocks_for_stages``;
    for pp 2 even, ``[3, 1]``, ``[1, 3]``, vpp 2 even and ``[2, 1, 1, 0]``
    (a zero-layer chunk), and mixed ``stage_tp=[2, 1]`` with
    ``act_sharding`` set;
  * the stack and unstack equal JAX's ``stack_blocks_for_stages`` and
    ``ckpt._unstack_blocks`` bit for bit;
  * one call's ICCL notes equal what JAX's sink records while tracing the
    same loss once;
  * the ``Trainer`` on the planner's non-uniform plan for llama3-8b, three
    steps against JAX's jitted ``make_train_step(loss_fn=make_pp_loss_fn)``
    on the stacked state over the same batches: losses, then parameters;
    at a global batch of 8, the pp and the reference route over seeds and
    learning rates, parameters screened by sqrt(v) after every step;
  * the train CLI's ``--pp``.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.data.pipeline import SyntheticTokens as JTokens  # noqa: E402
from repro.iccl import communicator as jcomm  # noqa: E402
from repro.iccl import transports as jtransports  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.parallel import pipeline as jpp  # noqa: E402
from repro.parallel.sharding import ShardingRules  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch.core.plan import ParallelPlan, StagePlacement  # noqa: E402
from repro_torch.iccl import communicator as tcomm  # noqa: E402
from repro_torch.iccl import transports as ttransports  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import pipeline as tpp  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

LOSS_TOL, GRAD_TOL = 2e-5, 1e-4
M, BT, SEQ = 4, 2, 32
ACT_SHARDING = (("data",), "model", None)
# (id, vpp, virtual-stage layers, stage_tp)
CASES = [
    ("even", 1, None, None),
    ("3-1", 1, [3, 1], None),
    ("1-3", 1, [1, 3], None),
    ("vpp2-even", 2, None, None),
    ("vpp2-2-1-1-0", 2, [2, 1, 1, 0], None),
    ("mixed-tp-3-1", 1, [3, 1], [2, 1]),
    ("mixed-tp-vpp2", 2, [2, 1, 1, 0], [2, 1]),
]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _models(act_sharding=()):
    kw = dict(smoke=True, num_layers=4, act_sharding=act_sharding)
    jb = jreg.get_bundle("llama3-8b", **kw)
    tb = treg.get_bundle("llama3-8b", **kw)
    return jb, tb


@pytest.fixture(scope="module")
def smoke4():
    jb, _ = _models()
    jparams = jb.init(jax.random.PRNGKey(0), jb.cfg)
    tparams = convert.from_jax(_np(jparams), device="cpu")
    batch = jreg.make_batch(jb.cfg, batch=M * BT, seq=SEQ)
    pp_batch = {k: v.reshape(M, BT, *v.shape[1:]) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in pp_batch.items()}
    return jparams, tparams, pp_batch, tbatch


def _case(case):
    _, vpp, vl, stage_tp = case
    jb, tb = _models(ACT_SHARDING if stage_tp else ())
    jloss = jpp.make_pp_loss_fn(jb.cfg, None, 2, M, layers_per_stage=vl,
                                vpp=vpp, stage_tp=stage_tp)
    tloss = tpp.make_pp_loss_fn(tb.cfg, 2, M, layers_per_stage=vl, vpp=vpp,
                                stage_tp=stage_tp)
    return vpp, vl, jloss, tloss


def _loss_and_grads(loss_fn, params, batch):
    leaves = adamw.tree_leaves(params)
    for t in leaves:
        t.requires_grad_()
    loss, metrics = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    it = iter(grads)
    return loss.detach(), metrics, adamw.tree_map(lambda _: next(it), params)


def _max_err(got, want) -> float:
    return max(float((g - w).abs().max()) for g, w in
               zip(adamw.tree_leaves(got), adamw.tree_leaves(want)))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_pp_loss_and_grads_match_jax(smoke4, case):
    jparams, tparams, pp_batch, tbatch = smoke4
    vpp, vl, jloss, tloss = _case(case)
    stacked = jpp.stack_blocks_for_stages(jparams, 2, vl, vpp=vpp)
    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        stacked, pp_batch)
    tl, tm, tg = _loss_and_grads(tloss, tparams, tbatch)
    assert abs(float(tl) - float(jl)) < LOSS_TOL
    assert abs(float(tm["ce"].detach()) - float(jm["ce"])) < LOSS_TOL
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0
    jg = tpp.unstack_blocks_for_stages(convert.from_jax(_np(jg),
                                                        device="cpu"),
                                       2, vl, vpp=vpp)
    assert _max_err(tg, jg) < GRAD_TOL


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_pp_tap_notes_match_jax_trace(smoke4, case):
    """One call of the port's loss notes (m + V - 1) ``pp_shift`` hops of
    the (n_stages[, vpp], B_tick, S, D) buffer, each after a
    ``pp_reshard`` when stage tp widths differ: the list JAX's sink takes
    while the same loss is traced once."""
    jparams, tparams, pp_batch, tbatch = smoke4
    vpp, vl, jloss, tloss = _case(case)
    stacked = jpp.stack_blocks_for_stages(jparams, 2, vl, vpp=vpp)
    jnotes, tnotes = [], []
    jcomm.set_collective_sink(lambda *a: jnotes.append(a))
    try:
        jax.eval_shape(jloss, stacked, pp_batch)
    finally:
        jcomm.set_collective_sink(None)
    tcomm.set_collective_sink(lambda *a: tnotes.append(a))
    try:
        with torch.no_grad():
            tloss(tparams, tbatch)
    finally:
        tcomm.set_collective_sink(None)
    assert tnotes == jnotes
    hops = M + 2 * vpp - 1
    D = jparams["embed"].shape[1]
    nbytes = 2 * vpp * BT * SEQ * D * 4
    shift = [("pp_shift", "pod", nbytes)]
    per_tick = ([("pp_reshard", "model", nbytes)] if case[3] else []) + shift
    assert tnotes == per_tick * hops


@pytest.mark.parametrize("vpp,vl", [(1, None), (1, [3, 1]), (1, [1, 3]),
                                    (2, None), (2, [2, 1, 1, 0])])
def test_stack_and_unstack_equal_jax(smoke4, vpp, vl):
    """The port's stack equals JAX's ``stack_blocks_for_stages`` bit for
    bit, and its unstack equals ``ckpt._unstack_blocks`` and gives back the
    canonical tree."""
    jparams, tparams, _, _ = smoke4
    jstacked = jpp.stack_blocks_for_stages(jparams, 2, vl, vpp=vpp)
    tstacked = tpp.stack_blocks_for_stages(tparams, 2, vl, vpp=vpp)
    want = convert.from_jax(_np(jstacked), device="cpu")
    for g, w in zip(adamw.tree_leaves(tstacked), adamw.tree_leaves(want)):
        assert g.shape == w.shape and torch.equal(g, w)
    virtual = tpp.virtual_stage_layers(4, 2, vl, vpp)
    junstacked = jckpt._unstack_blocks(
        jstacked, {"pp": 2, "vpp": vpp, "virtual_layers": virtual})
    back = tpp.unstack_blocks_for_stages(tstacked, 2, vl, vpp=vpp)
    for g, w, o in zip(adamw.tree_leaves(back),
                       adamw.tree_leaves(convert.from_jax(
                           _np(junstacked), device="cpu")),
                       adamw.tree_leaves(tparams)):
        assert torch.equal(g, w) and torch.equal(g, o)


def test_pp_scope_and_argument_errors():
    """An ssm stack names its ROADMAP item; layer counts and stage tp
    widths must fit the stages, as JAX asserts."""
    ssm = treg.get_bundle("falcon-mamba-7b", smoke=True)
    with pytest.raises(ValueError, match="queue A, item 9"):
        tpp.make_pp_loss_fn(ssm.cfg, 2, 4)
    _, tb = _models()
    with pytest.raises(ValueError, match="stage_tp needs 2 entries"):
        tpp.make_pp_loss_fn(tb.cfg, 2, 4, stage_tp=[1])
    with pytest.raises(ValueError, match="vpp=2 needs 4 virtual-stage"):
        tpp.make_pp_loss_fn(tb.cfg, 2, 4, layers_per_stage=[3, 1], vpp=2)
    with pytest.raises(ValueError, match="do not cover 4 layers"):
        tpp.make_pp_loss_fn(tb.cfg, 2, 4, layers_per_stage=[3, 2])
    with pytest.raises(ValueError, match="do not split evenly"):
        tpp.make_pp_loss_fn(tb.cfg, 3, 4)


def test_transports_equal_jax():
    """The transport registry is a copy: the same costs for every
    transport and collective."""
    want = jtransports.default_registry()
    got = ttransports.default_registry()
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert dataclasses.asdict(t) == dataclasses.asdict(want[name])
        for nbytes in (0.0, 1.0, 33554432.0):
            assert t.p2p_time(nbytes) == want[name].p2p_time(nbytes)
            for n in (1, 2, 8):
                for op in ("allreduce_time", "allgather_time",
                           "alltoall_time"):
                    assert getattr(t, op)(nbytes, n) == \
                        getattr(want[name], op)(nbytes, n)


# ------------------------------------------------ the trainer vs JAX ----
OPT = dict(lr=1e-2, warmup_steps=2)


def _planner_plan():
    """The planner's plan for llama3-8b at full width, 4 layers, seq 4096,
    global batch 4 on the CLI's two-kind cluster, run at SEQ."""
    cfg = treg.get_config("llama3-8b", num_layers=4)
    plan = train_cli.search_plan(cfg, 2, 4, 4096)
    assert plan.virtual_layers == (3, 1) and plan.micro_batches == 4
    return dataclasses.replace(plan, seq_len=SEQ)


def test_trainer_pp_steps_match_jax_train_step():
    plan = _planner_plan()
    m, vl, gb = plan.micro_batches, list(plan.virtual_layers), 4
    jb, tb = _models()
    rules = ShardingRules(jb.cfg, tp=1, dp_axes=("data",))
    jloss = jpp.make_pp_loss_fn(jb.cfg, None, plan.pp, m,
                                layers_per_stage=vl, stage_tp=[1, 1])
    step = jax.jit(jsteps.make_train_step(jb, rules,
                                          jadamw.AdamWConfig(**OPT),
                                          loss_fn=jloss))
    start = jsteps.init_train_state(jb, jax.random.PRNGKey(0))
    stack = lambda tree: jpp.stack_blocks_for_stages(tree, plan.pp, vl)
    state = dict(start, params=stack(start["params"]),
                 opt=dict(start["opt"], m=stack(start["opt"]["m"]),
                          v=stack(start["opt"]["v"])))
    data = JTokens(vocab_size=jb.cfg.vocab_size, seq_len=SEQ,
                   global_batch=gb)
    want = []
    for i in range(3):
        batch = {k: v.reshape(m, gb // m, *v.shape[1:])
                 for k, v in data.batch_at(i).items()}
        state, metrics = step(state, batch)
        want.append(float(metrics["loss"]))

    t = Trainer(tb, TrainerConfig(global_batch=gb, seq_len=SEQ), plan=plan,
                opt_cfg=adamw.AdamWConfig(**OPT),
                state=convert.from_jax(_np(start), device="cpu"),
                device="cpu")
    assert t._pipeline_active() and not t._cp_active()
    assert t._device_batch(t.data.batch_at(0))["tokens"].shape == \
        (m, gb // m, SEQ)
    out = t.run(3)
    assert out["step"] == 3 and np.all(np.isfinite(out["losses"]))
    np.testing.assert_allclose(out["losses"], want, rtol=1e-4, atol=1e-4)
    # AdamW divides an element's step by its own gradient rms, so where the
    # gradient is rounding noise (sqrt(v) < GRAD_TOL; the two frameworks'
    # gradients sit ~3e-7 apart) it moves by up to lr a step in a direction
    # the rounding picks: the reference route parts the same way (one embed
    # element 4e-3 apart).  Those elements are held to the three steps'
    # reach, every other one to GRAD_TOL.
    unstack = lambda tree: tpp.unstack_blocks_for_stages(
        convert.from_jax(_np(tree), device="cpu"), plan.pp, vl)
    for g, w, v in zip(adamw.tree_leaves(t.state["params"]),
                       adamw.tree_leaves(unstack(state["params"])),
                       adamw.tree_leaves(unstack(state["opt"]["v"]))):
        err = (g - w).abs()
        assert float(err.max()) < 2 * 3 * OPT["lr"]
        assert float(err[v.sqrt() >= GRAD_TOL].max()) < GRAD_TOL


# At a global batch of 8 the screen above, by sqrt(v) after the last step,
# lets through elements whose gradient was rounding noise at an earlier
# step: they moved by up to lr then, and keep that when their gradient
# grows.  The reference route, which has no pipeline, parts from JAX the
# same way, and the parting scales with lr.  Screened by sqrt(v) after
# every step, the rest hold to GRAD_TOL.  Run with -s for the readings.
@pytest.mark.parametrize("route,seed,lr", [
    ("pp", 0, 1e-2), ("pp", 1, 1e-2), ("pp", 2, 1e-2),
    ("reference", 0, 1e-2), ("pp", 0, 1e-3)])
def test_trainer_batch8_parts_from_jax_only_where_a_gradient_was_noise(
        route, seed, lr):
    gb, vl, m = 8, [3, 1], 4
    opt = dict(OPT, lr=lr)
    jb, tb = _models()
    plan = ParallelPlan(stages=(StagePlacement(0, 3, 1, 1),
                                StagePlacement(1, 1, 1, 1, True)),
                        micro_bs=gb // m, global_batch=gb, seq_len=SEQ,
                        schedule="1f1b-eager", eager_slack=1)
    rules = ShardingRules(jb.cfg, tp=1, dp_axes=("data",))
    start = jsteps.init_train_state(jb, jax.random.PRNGKey(seed))
    state, split, join = start, (lambda b: b), (
        lambda tree: convert.from_jax(_np(tree), device="cpu"))
    loss_fn = None
    if route == "pp":
        loss_fn = jpp.make_pp_loss_fn(jb.cfg, None, 2, m,
                                      layers_per_stage=vl, stage_tp=[1, 1])
        stack = lambda tree: jpp.stack_blocks_for_stages(tree, 2, vl)  # noqa
        state = dict(start, params=stack(start["params"]),
                     opt=dict(start["opt"], m=stack(start["opt"]["m"]),
                              v=stack(start["opt"]["v"])))
        split = lambda b: {k: v.reshape(m, gb // m, *v.shape[1:])  # noqa
                           for k, v in b.items()}
        join = lambda tree: tpp.unstack_blocks_for_stages(  # noqa: E731
            convert.from_jax(_np(tree), device="cpu"), 2, vl)
    step = jax.jit(jsteps.make_train_step(jb, rules,
                                          jadamw.AdamWConfig(**opt),
                                          loss_fn=loss_fn))
    data = JTokens(vocab_size=jb.cfg.vocab_size, seq_len=SEQ,
                   global_batch=gb)
    want, rms_min = [], None
    for i in range(3):
        state, metrics = step(state, split(data.batch_at(i)))
        want.append(float(metrics["loss"]))
        rms = [v.sqrt() for v in adamw.tree_leaves(join(state["opt"]["v"]))]
        rms_min = rms if rms_min is None else [
            torch.minimum(a, b) for a, b in zip(rms_min, rms)]
    t = Trainer(tb, TrainerConfig(global_batch=gb, seq_len=SEQ),
                plan=plan if route == "pp" else None,
                opt_cfg=adamw.AdamWConfig(**opt),
                state=convert.from_jax(_np(start), device="cpu"),
                device="cpu")
    np.testing.assert_allclose(t.run(3)["losses"], want, rtol=1e-4,
                               atol=1e-4)
    part = {"the last step": 0.0, "every step": 0.0}
    for g, w, v, lo in zip(adamw.tree_leaves(t.state["params"]),
                           adamw.tree_leaves(join(state["params"])),
                           adamw.tree_leaves(join(state["opt"]["v"])),
                           rms_min):
        err = (g - w).abs()
        assert float(err.max()) < 2 * 3 * lr
        for when, rms in (("the last step", v.sqrt()), ("every step", lo)):
            if (rms >= GRAD_TOL).any():
                part[when] = max(part[when],
                                 float(err[rms >= GRAD_TOL].max()))
    print(f"batch 8, {route}, seed {seed}, lr {lr}: largest parting where "
          f"sqrt(v) >= {GRAD_TOL} after " + ", after ".join(
              f"{when} {x:.3e}" for when, x in part.items()))
    assert part["every step"] < GRAD_TOL

def test_train_cli_pp_runs_the_planners_plan(capsys):
    train_cli.main(["--smoke", "--device", "cpu", "--pp", "2",
                    "--global-batch", "4", "--seq", "16", "--steps", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("[train] plan: pp=2 ")
    summary = json.loads(lines[-1])
    assert summary["pp"] == 2 and summary["steps"] == 2
    assert summary["micro_batches"] == 4
    assert sum(summary["virtual_layers"]) == 2
    assert np.isfinite(summary["final_loss"])


def test_train_cli_pp_raises_without_cuda(monkeypatch):
    """Asked for no device, the CLI wants the card, with ``--pp`` too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--smoke", "--pp", "2", "--global-batch", "4"])
