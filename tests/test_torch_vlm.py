"""phi-3-vision-4.2b (the VLM: the dense stack behind prepended image
embeddings, the CLIP frontend a stub) through the port against the JAX
package, fp32 SMOKE at 4 layers (d 64, 16 image positions) on the CPU,
JAX's parameters carried over by ``from_jax`` and the inputs made from
numpy seeds.  The JAX references are jitted once a module.

  * ``lm_forward`` with the prepend, and ``lm_prefill`` (its cache and
    ``pos`` over N + S_text positions) with 4 decode steps, 1e-4;
  * the reference loss (labels over the image positions too) and its
    gradients: loss 2e-5, gradients 1e-4;
  * the one-process pp loss at vpp 1 and 2 (stage 0 prepends) against
    JAX's pp loss, and two ``Trainer`` steps on a pp 2 plan (its batch
    microbatches ``image_embeds``) against JAX's jitted train step of that
    loss: losses 2e-5, gradients 1e-4, parameters 1e-4 where sqrt(v) >=
    1e-4;
  * ``PPRankStep`` on two gloo ranks at pp 2 (the first stage's ranks take
    ``image_embeds``) against the one-process route;
  * the cp route refused by name.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.data.pipeline import SyntheticTokens as JTokens  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.parallel import pipeline as jpp  # noqa: E402
from repro.parallel.sharding import ShardingRules as JRules  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch.core.plan import ParallelPlan, StagePlacement  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import context, rank_programs  # noqa: E402
from repro_torch.parallel import pipeline as tpp  # noqa: E402
from repro_torch.parallel.launch import run_ranks  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

ARCH = "phi-3-vision-4.2b"
KW = dict(smoke=True, num_layers=4)
TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_TOL, GRAD_TOL = 2e-5, 1e-4
OPT = dict(lr=1e-2, warmup_steps=2)
N_IMG, B, S_TEXT, MAX_LEN = 16, 2, 20, 48
M, BT, SEQ = 4, 2, 40          # SEQ counts the 16 image positions


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


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **tol)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: x for k, v in tree.items() if k != "_stacked"
                for p, x in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _grads(loss_fn, params, batch):
    """(loss, metrics, {key path: gradient}) of ``loss_fn``."""
    p = adamw.tree_map(lambda t: t.clone().requires_grad_(), params)
    loss, metrics = loss_fn(p, batch)
    leaves = adamw.tree_leaves(p)
    it = iter(torch.autograd.grad(loss, leaves))
    return (float(loss.detach()), metrics,
            _flat(adamw.tree_map(lambda _: next(it), p)))


def _grads_close(got, want):
    assert sorted(got) == sorted(want)
    assert max(float((got[k] - torch.as_tensor(np.array(want[k])))
                     .abs().max()) for k in want) < GRAD_TOL


@pytest.fixture(scope="module")
def smoke():
    """(JAX bundle, JAX params, port bundle, port params, image embeds,
    tokens of S_TEXT + 4: the prompt and 4 decode steps)."""
    jb = jreg.get_bundle(ARCH, **KW)
    jp = jax.jit(jb.init, static_argnums=1)(jax.random.PRNGKey(0), jb.cfg)
    tp = convert.from_jax(_np(jp), device="cpu")
    rng = np.random.default_rng(0)
    img = rng.standard_normal((B, N_IMG, 64)).astype(np.float32)
    toks = rng.integers(0, 256, (B, S_TEXT + 4), dtype=np.int32)
    return jb, jp, treg.get_bundle(ARCH, **KW), tp, img, toks


def test_forward_with_the_prepend_matches_jax(smoke):
    jb, jp, tb, tp, img, toks = smoke
    jl, _ = jax.jit(lambda p, i, t: jb.forward(
        p, {"image_embeds": i, "tokens": t}, jb.cfg))(
        jp, jnp.asarray(img), jnp.asarray(toks))
    tl, aux = tb.forward(tp, _torch({"image_embeds": img, "tokens": toks}),
                         tb.cfg)
    assert tl.shape == (B, N_IMG + S_TEXT + 4, 256) and float(aux) == 0.0
    _close(tl, jl)


def test_prefill_and_decode_with_the_prepend_match_jax(smoke):
    jb, jp, tb, tp, img, toks = smoke
    cfg = jb.cfg
    prefill = jax.jit(lambda p, i, t: jb.prefill(
        p, {"image_embeds": i, "tokens": t}, cfg, MAX_LEN))
    step = jax.jit(lambda p, t, c: jb.decode_step(p, t, c, cfg))
    jl, jc = prefill(jp, jnp.asarray(img), jnp.asarray(toks[:, :S_TEXT]))
    tl, tc = tb.prefill(tp, _torch({"image_embeds": img,
                                    "tokens": toks[:, :S_TEXT]}),
                        tb.cfg, MAX_LEN)
    treg.check_last_logits(tl, B, 256)
    _close(tl, jl)
    assert int(tc["pos"]) == int(jc["pos"]) == N_IMG + S_TEXT
    _close(tc["kv"]["k"], jc["kv"]["k"])
    _close(tc["kv"]["v"], jc["kv"]["v"])
    for i in range(4):
        nxt = toks[:, S_TEXT + i:S_TEXT + i + 1]
        jl, jc = step(jp, jnp.asarray(nxt), jc)
        tl, tc = tb.decode_step(tp, torch.from_numpy(nxt), tc, tb.cfg)
        _close(tl, jl)
        _close(tc["kv"]["k"], jc["kv"]["k"])


# ------------------------------------------------------------ training ---
def test_reference_loss_and_gradients_match_jax(smoke):
    jb, jp, tb, tp, _, _ = smoke
    batch = jreg.make_batch(jb.cfg, batch=B, seq=SEQ)
    assert batch["labels"].shape == (B, SEQ)
    rules = JRules(jb.cfg, tp=1, dp_axes=("data",))
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        jsteps.make_loss_fn(jb, rules), has_aux=True))(jp, batch)
    tl, tm, tg = _grads(tsteps.make_loss_fn(tb), tp, _torch(_np(batch)))
    assert abs(tl - float(jl)) < LOSS_TOL
    assert abs(float(tm["ce"].detach()) - float(jm["ce"])) < LOSS_TOL
    _grads_close(tg, _flat(_np(jg)))


@pytest.fixture(scope="module")
def pp_batch(smoke):
    jb = smoke[0]
    batch = jreg.make_batch(jb.cfg, batch=M * BT, seq=SEQ)
    return {k: np.asarray(v).reshape(M, BT, *v.shape[1:])
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def port_pp(smoke, pp_batch):
    """The one-process pp 2 loss and gradients (vpp 1): the rank test's
    witness."""
    _, _, tb, tp, _, _ = smoke
    return _grads(tpp.make_pp_loss_fn(tb.cfg, 2, M), tp, _torch(pp_batch))


@pytest.mark.parametrize("vpp", [1, 2])
def test_pp_loss_and_gradients_match_jax(smoke, pp_batch, port_pp, vpp):
    """Stage 0 prepends the image embeddings of each microbatch, in JAX's
    pp loss and in the port's, at vpp 1 and 2."""
    jb, jp, tb, tp, _, _ = smoke
    assert pp_batch["image_embeds"].shape == (M, BT, N_IMG, 64)
    jloss = jpp.make_pp_loss_fn(jb.cfg, None, 2, M, vpp=vpp)
    stacked = jpp.stack_blocks_for_stages(jp, 2, None, vpp=vpp)
    (jl, _), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        stacked, pp_batch)
    jg = tpp.unstack_blocks_for_stages(
        convert.from_jax(_np(jg), device="cpu"), 2, None, vpp=vpp)
    tl, _, tg = (port_pp if vpp == 1 else _grads(
        tpp.make_pp_loss_fn(tb.cfg, 2, M, vpp=vpp), tp, _torch(pp_batch)))
    assert abs(tl - float(jl)) < LOSS_TOL
    _grads_close(tg, _flat(jg))


def test_pp_trainer_steps_match_jax(smoke):
    """Two ``Trainer`` steps on a pp 2 plan (its batch microbatches
    ``image_embeds``) against JAX's jitted train step of its pp loss on
    the same synthetic VLM batches: parameters within 1e-4 where sqrt(v)
    >= 1e-4 after every step (an element whose gradient is rounding noise
    parts by up to lr a step: tests/test_torch_pipeline.py, PERF.md)."""
    jb, jp, tb, _, _, _ = smoke
    plan = ParallelPlan(stages=(StagePlacement(0, 2, 1, 1),
                                StagePlacement(1, 2, 1, 1, True)),
                        micro_bs=BT, global_batch=M * BT, seq_len=SEQ)
    rules = JRules(jb.cfg, tp=1, dp_axes=("data",))
    jloss = jpp.make_pp_loss_fn(jb.cfg, None, 2, M)
    step = jax.jit(jsteps.make_train_step(
        jb, rules, jadamw.AdamWConfig(**OPT), loss_fn=jloss))
    stacked = jpp.stack_blocks_for_stages(jp, 2, None)
    state = {"params": stacked, "opt": jadamw.init_opt_state(stacked, False),
             "step": jnp.zeros((), jnp.int32)}
    data = JTokens(vocab_size=256, seq_len=SEQ, global_batch=M * BT,
                   family="vlm", d_model=64, n_vision_tokens=N_IMG)
    t = Trainer(tb, TrainerConfig(global_batch=M * BT, seq_len=SEQ),
                plan=plan, opt_cfg=adamw.AdamWConfig(**OPT),
                state=convert.from_jax(
                    {"params": jp, "opt": _np(jadamw.init_opt_state(
                        jp, False)), "step": np.zeros((), np.int32)},
                    device="cpu"), device="cpu")
    assert t._pipeline_active()

    def canonical(tree):
        return _flat(tpp.unstack_blocks_for_stages(
            convert.from_jax(_np(tree), device="cpu"), 2, None))

    for i in range(2):
        batch = {k: v.reshape(M, BT, *v.shape[1:])
                 for k, v in data.batch_at(i).items()}
        state, m = step(state, batch)
        assert abs(t.run(1)["losses"][0] - float(m["loss"])) < LOSS_TOL, i
        want, rms = canonical(state["params"]), canonical(state["opt"]["v"])
        got = _flat(t.state["params"])
        assert sorted(got) == sorted(want)
        for k, w in want.items():   # screened by sqrt(v), as PERF.md says
            err = (got[k] - w).abs()
            assert float(err.max()) < 2 * (i + 1) * OPT["lr"], k
            assert float(err[rms[k].sqrt() >= GRAD_TOL].max(
                ) if (rms[k].sqrt() >= GRAD_TOL).any() else 0) < GRAD_TOL, k


def test_rank_step_on_gloo_matches_the_one_process_route(smoke, pp_batch,
                                                         port_pp):
    """``PPRankStep`` of pp 2 on two gloo ranks: stage 0's rank embeds and
    prepends, the boundary carries N + S_text positions; every rank's
    loss and the gathered gradients equal the one-process route's."""
    _, jp, _, _, _, _ = smoke
    params = adamw.tree_map(lambda t: t.numpy(),
                            convert.from_jax(_np(jp), device="cpu"))
    res = run_ranks(rank_programs.pp_loss_and_grads, 2, timeout_s=60,
                    device="cpu", args=(dict(arch=ARCH, **KW), params,
                                        pp_batch, [([2, 2], "1f1b", 1)]))
    tl, _, tg = port_pp
    for r in res:
        assert abs(r[0]["loss"] - tl) < LOSS_TOL
    grads = _flat(tpp.gather_stage_trees(
        [adamw.tree_map(torch.from_numpy, r[0]["grads"]) for r in res],
        [2, 2]))
    assert sorted(grads) == sorted(tg)
    assert max(float((grads[k] - tg[k]).abs().max()) for k in tg) \
        < LOSS_TOL


def test_cp_route_refused_by_name(smoke):
    """JAX's cp loss reads tokens and labels only: a VLM's cp plan has no
    route, on one process (the trainer raises rather than keep the
    reference loss) or on ranks."""
    tb = smoke[2]
    with pytest.raises(NotImplementedError, match="reads tokens and labels"):
        context.make_cp_loss_fn(tb.cfg, (24, 16))
    cp2 = ParallelPlan(stages=(StagePlacement(0, 4, 2, 1, True),),
                       micro_bs=4, global_batch=4, seq_len=SEQ, cp=2,
                       cp_chunks=(24, 16))
    with pytest.raises(NotImplementedError, match="image_embeds"):
        tpp.check_rank_plan(tb.cfg, cp2)
    with pytest.raises(NotImplementedError, match="image_embeds"):
        Trainer(tb, TrainerConfig(global_batch=4, seq_len=SEQ), plan=cp2,
                device="cpu")
