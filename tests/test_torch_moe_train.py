"""Training the MoE family on the port, against the JAX package, fp32 on the
CPU (SMOKE widths).

  * one reference-route train step of mixtral-8x7b (S 64, past its SMOKE
    window of 32) and phi3.5-moe-42b-a6.6b against ``jax.value_and_grad``
    of JAX's ``make_loss_fn`` (what JAX's ``make_train_step`` takes): the
    loss, its CE and aux, every gradient (the router's through the aux
    loss too) and the step's gradient norm within 2e-5;
  * the one-process pp loss, at vpp 1 (``[2, 1]``) and vpp 2
    (``[1, 1, 1, 0]``, a zero-layer chunk), against JAX's
    ``make_pp_loss_fn`` with its aux sum over the valid slots (run as
    ``tests/test_pipeline_moe.py`` runs it, at vpp 1: every layout
    computes that one function of the parameters): loss, CE and aux within
    2e-5, gradients within 1e-4;
  * 2 gloo ranks at pp 2 (``PPRankStep``, each stage's backward taking
    ``AUX_COEF / m`` of its own aux) against the same JAX loss;
  * the scope: MoE at dp > 1 and at tp > 1 raise by name before a grid is
    made.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.data.pipeline import SyntheticTokens as JTokens  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.parallel import pipeline as jpp  # noqa: E402
from repro.parallel.sharding import ShardingRules as JRules  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch.core.plan import ParallelPlan, StagePlacement  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import pipeline as tpp  # noqa: E402
from repro_torch.parallel import rank_programs  # noqa: E402
from repro_torch.parallel.launch import run_ranks  # noqa: E402
from repro_torch.train import steps  # noqa: E402

TOL = 2e-5
GRAD_TOL = 1e-4
OPT = dict(lr=1e-2, warmup_steps=2)
ARCHS = ("mixtral-8x7b", "phi3.5-moe-42b-a6.6b")
M, BT, SEQ = 2, 2, 32
PP3 = dict(arch="mixtral-8x7b", smoke=True, num_layers=3)
# (id, vpp, virtual-stage layers, schedule on ranks)
PP_CASES = [("2-1", 1, [2, 1], "1f1b"),
            ("vpp2-1-1-1-0", 2, [1, 1, 1, 0], "interleaved-1f1b")]
JAX_LAYOUT = [2, 1]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's in-process port code (SMOKE
    sizes gain nothing from more), so that test workers running side by
    side do not oversubscribe the host's cores; restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: x for k, v in tree.items() if k != "_stacked"
                for p, x in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


def _max_err(got, want) -> float:
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    return max(float(np.max(np.abs(np.asarray(g[k].detach(), np.float32)
                                   - np.asarray(w[k], np.float32))))
               for k in w)


def _grads(loss_fn, params, batch):
    leaves = adamw.tree_leaves(params)
    for t in leaves:
        t.requires_grad_()
    loss, metrics = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    it = iter(grads)
    return loss.detach(), metrics, adamw.tree_map(lambda _: next(it), params)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_train_step_matches_jax(arch):
    jb, tb = jreg.get_bundle(arch, smoke=True), treg.get_bundle(arch, True)
    rules = JRules(jb.cfg, tp=1, dp_axes=("data",))
    jstate = jax.jit(lambda k: jsteps.init_train_state(jb, k))(
        jax.random.PRNGKey(0))
    start = _np(jstate)
    batch = JTokens(vocab_size=256, seq_len=64, global_batch=2).batch_at(0)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        jsteps.make_loss_fn(jb, rules), has_aux=True))(jstate["params"],
                                                       batch)
    jnorm = float(np.sqrt(sum(np.sum(np.square(np.asarray(g, np.float64)))
                              for g in jax.tree.leaves(jg))))
    tstate = convert.from_jax(start, device="cpu")
    tl, tmet, tg = _grads(steps.make_loss_fn(tb), tstate["params"],
                          _torch_batch(batch))
    _, tm = steps.make_train_step(tb, adamw.AdamWConfig(**OPT))(
        tstate, _torch_batch(batch))
    assert float(jmet["aux"]) > 0
    tmet = {k: v.detach() for k, v in tmet.items()}
    for got, want in ((tl, jl), (tmet["ce"], jmet["ce"]),
                      (tmet["aux"], jmet["aux"]), (tm["loss"], jl),
                      (tm["grad_norm"], jnorm)):
        assert abs(float(got) - float(want)) < TOL
    assert _max_err(tg, jg) < TOL
    # the router learns from the CE and the aux
    assert float(tg["blocks"]["moe"]["router"].abs().max()) > 0


@pytest.fixture(scope="module")
def pp_setup():
    """The rank run (started first, so JAX compiles meanwhile), and JAX's
    pp loss, CE, aux and unstacked gradients at vpp 1 (``JAX_LAYOUT``),
    which every case is held to."""
    jb = jreg.get_bundle(**PP3)
    jparams = jax.jit(jb.init, static_argnums=1)(jax.random.PRNGKey(0),
                                                 jb.cfg)
    batch = jreg.make_batch(jb.cfg, batch=M * BT, seq=SEQ)
    pp_batch = {k: np.asarray(v).reshape(M, BT, *v.shape[1:])
                for k, v in batch.items()}
    port_np = adamw.tree_map(lambda t: t.numpy(),
                             convert.from_jax(_np(jparams), device="cpu"))
    pool = ThreadPoolExecutor(max_workers=1)
    ranks = pool.submit(run_ranks, rank_programs.pp_loss_and_grads, 2,
                        timeout_s=120, device="cpu",
                        args=(PP3, port_np, pp_batch,
                              [(vl, sched, 1, vpp)
                               for _, vpp, vl, sched in PP_CASES]))
    pool.shutdown(wait=False)
    jloss = jpp.make_pp_loss_fn(jb.cfg, None, 2, M,
                                layers_per_stage=JAX_LAYOUT)
    stacked = jpp.stack_blocks_for_stages(jparams, 2, JAX_LAYOUT)
    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        stacked, pp_batch)
    jg = tpp.unstack_blocks_for_stages(
        convert.from_jax(_np(jg), device="cpu"), 2, JAX_LAYOUT)
    return (jparams, pp_batch,
            (float(jl), float(jm["ce"]), float(jm["aux"]), jg), ranks)


@pytest.mark.parametrize("case", PP_CASES, ids=[c[0] for c in PP_CASES])
def test_pp_loss_with_aux_matches_jax(pp_setup, case):
    jparams, pp_batch, (jl, jce, jaux, jg), _ = pp_setup
    _, vpp, vl, _ = case
    tb = treg.get_bundle(**PP3)
    tloss = tpp.make_pp_loss_fn(tb.cfg, 2, M, layers_per_stage=vl, vpp=vpp)
    tparams = convert.from_jax(_np(jparams), device="cpu")
    tl, tm, tg = _grads(tloss, tparams, _torch_batch(pp_batch))
    assert jaux > 0
    assert abs(float(tl) - jl) < TOL
    assert abs(float(tm["ce"].detach()) - jce) < TOL
    assert abs(float(tm["aux"].detach()) - jaux) < TOL
    assert _max_err(tg, jg) < GRAD_TOL


@pytest.mark.parametrize("i", range(len(PP_CASES)),
                         ids=[c[0] for c in PP_CASES])
def test_pp_ranks_with_aux_match_jax(pp_setup, i):
    _, _, (jl, _, _, jg), ranks = pp_setup
    _, vpp, vl, _ = PP_CASES[i]
    for r in (res[i] for res in ranks.result()):
        assert abs(r["loss"] - jl) < TOL
        want = tpp.stage_tree(jg, vl, r["stage"], vpp)
        assert _max_err(adamw.tree_map(torch.from_numpy, r["grads"]),
                        want) < GRAD_TOL


def _plan(dp=1, tp=1, pp=2):
    stages = tuple(StagePlacement(s, 4 // pp, dp, tp, s == pp - 1)
                   for s in range(pp))    # of a 4-layer stack
    return ParallelPlan(stages=stages, micro_bs=1, global_batch=4 * dp,
                        seq_len=SEQ)


def test_moe_and_ssm_rank_scope_errors():
    cfg = treg.get_config("mixtral-8x7b", smoke=True, num_layers=4)
    tpp.check_rank_plan(cfg, _plan())
    tpp.check_rank_plan(cfg, _plan(pp=1))
    for pp in (1, 2):
        with pytest.raises(ValueError, match="MoE at dp > 1.*item A9c"):
            tpp.check_rank_plan(cfg, _plan(dp=2, pp=pp))
        with pytest.raises(NotImplementedError, match="item A9b"):
            tpp.check_rank_plan(cfg, _plan(tp=2, pp=pp))
    ssm = treg.get_config("falcon-mamba-7b", smoke=True, num_layers=4)
    tpp.check_rank_plan(ssm, _plan(dp=2))
    with pytest.raises(NotImplementedError, match="item A9a"):
        tpp.check_rank_plan(ssm, _plan(tp=2))
    with pytest.raises(NotImplementedError, match="item A9b"):
        transformer.check_tp_supported(cfg)
    with pytest.raises(ValueError, match="moe family, and only it"):
        transformer.check_supported(dataclasses.replace(cfg, n_experts=0))
