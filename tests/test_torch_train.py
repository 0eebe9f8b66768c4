"""The port's training path against the JAX package, fp32 on the CPU.

  * the backward plain versions ``rmsnorm_bwd`` / ``swiglu_bwd`` against
    ``jax.vjp`` of the JAX oracles;
  * ``cross_entropy`` (with z-loss), two ``adamw_update`` steps (clipping,
    warmup, master weights), ``SyntheticTokens`` batches, ``ParallelPlan``;
  * the cp ring loss and the reference loss, value and gradients, against
    ``context.make_cp_loss_fn`` / ``steps.make_loss_fn`` on the SMOKE
    llama3-8b at 4 layers (2e-5 and 2e-4, as tests/test_context_parallel.py);
  * three ``Trainer`` steps on each route against JAX's jitted train step
    looped over the same batches from one state (1e-4, as
    tests/test_context_parallel.py:404).  The JAX ``Trainer`` itself fails
    under this jax (ShardingTypeError in ``_embed_tokens``), so its
    ``_run`` is written out here without its mesh.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.plan import ParallelPlan as JPlan  # noqa: E402
from repro.core.plan import StagePlacement as JStage  # noqa: E402
from repro.data.pipeline import SyntheticTokens as JTokens  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.parallel import context as jcontext  # noqa: E402
from repro.parallel.sharding import ShardingRules  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch.core.plan import ParallelPlan, StagePlacement  # noqa: E402
from repro_torch.data.pipeline import SyntheticTokens  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import context  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _np(x):
    return np.asarray(x, np.float32)


def _to_np(t):
    return t.detach().float().numpy()


def _pair(rng, shape, dtype="float32"):
    a = rng.standard_normal(shape).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _tree_close(got, want, tol, path=""):
    """got: nested dict of tensors; want: the JAX tree (``_stacked``
    markers skipped)."""
    if isinstance(got, dict):
        for k, v in got.items():
            _tree_close(v, want[k], tol, f"{path}/{k}")
        return
    np.testing.assert_allclose(_to_np(got), _np(want), err_msg=path, **tol)


# ------------------------------------------------------ backward refs ----
@pytest.mark.parametrize("shape", [(37, 64), (4, 5, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_bwd_matches_jax_vjp(shape, dtype):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng, shape, dtype)
    sj, st = _pair(rng, shape[-1:], dtype)
    dj, dt = _pair(rng, shape, dtype)
    _, vjp = jax.vjp(lambda x, s: jref.rmsnorm_ref(x, s, 1e-5), xj, sj)
    want_dx, want_ds = vjp(dj)
    dx, ds = ref.rmsnorm_bwd(xt, st, dt, 1e-5)
    assert dx.dtype == xt.dtype and ds.dtype == torch.float32
    tol = BF16 if dtype == "bfloat16" else F32
    np.testing.assert_allclose(_to_np(dx), _np(want_dx), **tol)
    # dscale sums over rows: scale the bf16 tolerance by the magnitude
    np.testing.assert_allclose(_to_np(ds), _np(want_ds),
                               rtol=tol["rtol"],
                               atol=tol["atol"] * np.sqrt(xt.numel()
                                                          / shape[-1]))


@pytest.mark.parametrize("shape", [(5, 7, 128), (300, 96)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_bwd_matches_jax_vjp(shape, dtype):
    rng = np.random.default_rng(1)
    gj, gt = _pair(rng, shape, dtype)
    uj, ut = _pair(rng, shape, dtype)
    hj, ht = _pair(rng, shape, dtype)
    _, vjp = jax.vjp(jref.swiglu_ref, gj, uj)
    want = vjp(hj)
    got = ref.swiglu_bwd(gt, ut, ht)
    tol = BF16 if dtype == "bfloat16" else F32
    for g, w in zip(got, want):
        assert g.dtype == gt.dtype
        np.testing.assert_allclose(_to_np(g), _np(w), **tol)


# ------------------------------------------------------------- loss ----
def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(2)
    lj, lt = _pair(rng, (3, 11, 50))
    lt = lt * 4
    lj = lj * 4
    lab = rng.integers(0, 50, (3, 11)).astype(np.int32)
    want, want_g = jax.value_and_grad(jsteps.cross_entropy)(lj, lab)
    lt.requires_grad_()
    got = steps.cross_entropy(lt, torch.from_numpy(lab))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), **F32)
    np.testing.assert_allclose(_to_np(lt.grad), _np(want_g), **F32)


# ------------------------------------------------------------ AdamW ----
def _opt_trees(rng):
    shapes = {"w": (6, 5), "b": {"scale": (5,)}}

    def make(sh, scale):
        if isinstance(sh, dict):
            return {k: make(v, scale) for k, v in sh.items()}
        return (rng.standard_normal(sh) * scale).astype(np.float32)

    return make(shapes, 1.0), [make(shapes, 3.0), make(shapes, 0.05)]


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adamw_two_steps_match_jax(param_dtype):
    """Step 1 is clipped (gradient norm ~20 > 1), step 2 is not; warmup
    over 3 steps scales the learning rate; bf16 params keep fp32
    masters."""
    rng = np.random.default_rng(3)
    params_np, grads_np = _opt_trees(rng)
    jd = jnp.bfloat16 if param_dtype == "bfloat16" else jnp.float32
    cfg_kw = dict(lr=1e-2, warmup_steps=3, weight_decay=0.1, grad_clip=1.0)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jd), params_np)
    jst = jadamw.init_opt_state(jp, keep_master=param_dtype != "float32")
    tp = convert.from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    tst = adamw.init_opt_state(tp, keep_master=param_dtype != "float32")
    for g_np in grads_np:
        jg = jax.tree.map(lambda a: jnp.asarray(a).astype(jd), g_np)
        tg = convert.from_jax(jax.tree.map(np.asarray, jg), device="cpu")
        jp, jst, jm = jadamw.adamw_update(jp, jg, jst,
                                          jadamw.AdamWConfig(**cfg_kw))
        tp, tst, tm = adamw.adamw_update(tp, tg, tst,
                                         adamw.AdamWConfig(**cfg_kw))
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **F32)
    assert int(tst["count"]) == int(jst["count"]) == 2
    tol = BF16 if param_dtype == "bfloat16" else F32
    _tree_close(tp, jp, tol)
    for k in ("m", "v") + (("master",) if param_dtype == "bfloat16" else ()):
        _tree_close(tst[k], jst[k], F32)


# ------------------------------------------------------ data and plan ----
def test_synthetic_batches_equal_jax():
    kw = dict(vocab_size=300, seq_len=17, global_batch=4, seed=7)
    jt, tt = JTokens(**kw), SyntheticTokens(**kw)
    for step in (0, 1, 5):
        for dp_rank, dp_size in ((0, 1), (1, 2)):
            want = jt.batch_at(step, dp_rank=dp_rank, dp_size=dp_size)
            got = tt.batch_at(step, dp_rank=dp_rank, dp_size=dp_size)
            assert sorted(got) == sorted(want) == ["labels", "tokens"]
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])


def test_parallel_plan_matches_jax():
    stages = ((0, 4, 4, 1, True),)
    kw = dict(micro_bs=1, global_batch=1, seq_len=4096, cp=4,
              cp_chunks=(1383, 1057, 884, 772))
    jp = JPlan(stages=tuple(JStage(*s) for s in stages), **kw)
    tp = ParallelPlan(stages=tuple(StagePlacement(*s) for s in stages), **kw)
    assert tp.to_dict() == jp.to_dict()
    assert tp.describe() == jp.describe()
    assert ParallelPlan.from_dict(jp.to_dict()) == tp
    assert (tp.pp, tp.cp_chunk_sizes) == (1, kw["cp_chunks"])
    even = ParallelPlan(stages=tp.stages, micro_bs=1, global_batch=1,
                        seq_len=10, cp=4)
    assert even.cp_chunk_sizes == (3, 3, 2, 2)
    for bad, match in (({"cp_chunks": (1, 2)}, "needs cp=4 entries"),
                       ({"cp": 3, "cp_chunks": None}, "must divide every"),
                       ({"transport": "ib"}, "unknown transport")):
        with pytest.raises(ValueError, match=match):
            ParallelPlan(stages=tp.stages, **{**kw, **bad})


# -------------------------------------------- losses against the JAX ----
@pytest.fixture(scope="module")
def smoke4():
    jb = jreg.get_bundle("llama3-8b", smoke=True, num_layers=4)
    jparams = jb.init(jax.random.PRNGKey(0), jb.cfg)
    tb = treg.get_bundle("llama3-8b", smoke=True, num_layers=4)
    tparams = convert.from_jax(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jb, jparams, tb, tparams


def _loss_and_grads(loss_fn, params, batch):
    leaves = adamw.tree_leaves(params)
    for t in leaves:
        t.requires_grad_()
    loss, metrics = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    it = iter(grads)
    return loss, metrics, adamw.tree_map(lambda _: next(it), params)


def _max_grad_err(tg, jg):
    if isinstance(tg, dict):
        return max(_max_grad_err(v, jg[k]) for k, v in tg.items())
    return float(np.max(np.abs(_to_np(tg) - _np(jg))))


@pytest.mark.parametrize("route,chunks", [
    ("cp", (48, 48)), ("cp", (40, 31, 25)), ("cp", (1, 94, 1)),
    ("reference", (96,))])
def test_loss_and_grads_match_jax(smoke4, route, chunks):
    """The port's cp ring loss against JAX's ``make_cp_loss_fn`` (and the
    reference loss against ``make_loss_fn``): loss within 2e-5, every
    parameter gradient within 2e-4."""
    jb, jparams, tb, tparams = smoke4
    S = sum(chunks)
    batch = jreg.make_batch(jb.cfg, batch=2, seq=S)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    if route == "cp":
        jloss = jcontext.make_cp_loss_fn(jb.cfg, None, chunks)
        tloss = context.make_cp_loss_fn(tb.cfg, chunks)
    else:
        jloss = jsteps.make_loss_fn(jb, ShardingRules(jb.cfg, tp=1,
                                                      dp_axes=("data",)))
        tloss = steps.make_loss_fn(tb)
    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jparams, batch)
    tl, tm, tg = _loss_and_grads(tloss, tparams, tbatch)
    tl = tl.detach()
    assert abs(float(tl) - float(jl)) < 2e-5
    assert abs(float(tm["ce"].detach()) - float(jm["ce"])) < 2e-5
    assert _max_grad_err(tg, jg) < 2e-4


def test_chunked_loss_matches_jax(smoke4):
    """``cfg.loss_chunk``: the head over sequence chunks (recomputed in the
    backward under ``cfg.remat``), a tail shorter than a chunk dropped, as
    in JAX."""
    jb, jparams, tb, tparams = smoke4
    jb = jreg.bundle_for(dataclasses.replace(jb.cfg, loss_chunk=24))
    tb = treg.bundle_for(dataclasses.replace(tb.cfg, loss_chunk=24))
    batch = jreg.make_batch(jb.cfg, batch=2, seq=60)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    jloss = jsteps.make_loss_fn(jb, ShardingRules(jb.cfg, tp=1,
                                                  dp_axes=("data",)))
    (jl, _), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jparams, batch)
    tl, _, tg = _loss_and_grads(steps.make_loss_fn(tb), tparams, tbatch)
    tl = tl.detach()
    assert abs(float(tl) - float(jl)) < 2e-5
    assert _max_grad_err(tg, jg) < 2e-4


# ------------------------------------------------ the trainer vs JAX ----
OPT = dict(lr=1e-2, warmup_steps=2)
GB, SEQ, CP_CHUNKS = 8, 32, (20, 12)


def _cp_plan():
    return ParallelPlan(stages=(StagePlacement(0, 4, 2, 1, True),),
                        micro_bs=8, global_batch=GB, seq_len=SEQ, cp=2,
                        cp_chunks=CP_CHUNKS)


def _jax_losses(jb, route, n):
    """JAX's Trainer._run without its mesh: the jitted train step over
    the same synthetic batches from step 0."""
    rules = ShardingRules(jb.cfg, tp=1, dp_axes=("data",))
    loss_fn = (jcontext.make_cp_loss_fn(jb.cfg, None, CP_CHUNKS)
               if route == "cp" else None)
    step = jax.jit(jsteps.make_train_step(
        jb, rules, jadamw.AdamWConfig(**OPT), loss_fn=loss_fn))
    state = jsteps.init_train_state(jb, jax.random.PRNGKey(0))
    start = jax.tree.map(np.asarray, state)
    data = JTokens(vocab_size=jb.cfg.vocab_size, seq_len=SEQ,
                   global_batch=GB)
    losses = []
    for i in range(n):
        state, metrics = step(state, data.batch_at(i))
        losses.append(float(metrics["loss"]))
    return start, losses


@pytest.mark.parametrize("route", ["cp", "reference"])
def test_trainer_steps_match_jax_train_step(smoke4, route):
    jb, _, tb, _ = smoke4
    start, want = _jax_losses(jb, route, 3)
    t = Trainer(tb, TrainerConfig(global_batch=GB, seq_len=SEQ),
                plan=_cp_plan() if route == "cp" else None,
                opt_cfg=adamw.AdamWConfig(**OPT),
                state=convert.from_jax(start, device="cpu"), device="cpu")
    assert t._cp_active() == (route == "cp")
    assert not t._pipeline_active()
    out = t.run(3)
    assert out["step"] == 3 and len(out["step_s"]) == 3
    assert np.all(np.isfinite(out["losses"]))
    np.testing.assert_allclose(out["losses"], want, rtol=1e-4, atol=1e-4)


def test_trainer_routes(smoke4):
    """pp > 1 raises (the pipeline is ROADMAP queue A, item 5); a model
    outside the cp scope and a cp = 1 plan keep the reference route; a
    plan for another workload stays advisory."""
    _, _, tb, _ = smoke4
    cfg = TrainerConfig(global_batch=GB, seq_len=SEQ)
    pp2 = ParallelPlan(stages=(StagePlacement(0, 2, 1, 1),
                               StagePlacement(1, 2, 1, 1, True)),
                       micro_bs=1, global_batch=GB, seq_len=SEQ)
    with pytest.raises(NotImplementedError, match="queue A, item 5"):
        Trainer(tb, cfg, plan=pp2, device="cpu")
    swa = treg.bundle_for(dataclasses.replace(tb.cfg, window=8))
    assert not Trainer(swa, cfg, plan=_cp_plan(),
                       device="cpu")._cp_active()
    cp1 = dataclasses.replace(_cp_plan(), cp=1, cp_chunks=None)
    assert not Trainer(tb, cfg, plan=cp1, device="cpu")._cp_active()
    other = TrainerConfig(global_batch=GB, seq_len=2 * SEQ)
    assert not Trainer(tb, other, plan=_cp_plan(),
                       device="cpu")._cp_active()
    with pytest.raises(ValueError, match="sliding-window"):
        context.make_cp_loss_fn(swa.cfg, (4, 4))


def test_grad_accum_matches_one_big_batch(smoke4):
    """Two microbatches of 4 give the mean of their losses and gradients:
    the same update as one batch of 8 (fp32, summation order only)."""
    _, _, tb, tparams = smoke4
    data = SyntheticTokens(vocab_size=256, seq_len=16, global_batch=8)
    batch = {k: torch.from_numpy(v) for k, v in data.batch_at(0).items()}
    results = []
    for accum in (1, 2):
        state = {"params": adamw.tree_map(lambda t: t.clone(), tparams)}
        state["opt"] = adamw.init_opt_state(state["params"],
                                            keep_master=False)
        state["step"] = torch.zeros((), dtype=torch.int32)
        step = steps.make_train_step(tb, adamw.AdamWConfig(**OPT),
                                     grad_accum=accum)
        results.append(step(state, batch))
    (s1, m1), (s2, m2) = results
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), **F32)
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(m1["grad_norm"]), **F32)
    assert int(s2["step"]) == 1
    _tree_close(s2["params"], adamw.tree_map(_to_np, s1["params"]), F32)


def test_train_cli_runs_on_cpu_when_asked(capsys):
    train_cli.main(["--smoke", "--device", "cpu", "--steps", "3",
                    "--global-batch", "2", "--seq", "16"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2].startswith("[train] step=3 loss=")
    summary = json.loads(lines[-1])
    assert summary["steps"] == 3 and summary["device"] == "cpu"
    assert np.isfinite(summary["final_loss"])
    assert set(summary["kernel_launches"].values()) == {0}
