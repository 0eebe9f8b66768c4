"""Training falcon-mamba-7b on the port, against the JAX package, fp32 on
the CPU (SMOKE widths, numpy-seeded inputs).

  * the scan's VJP: ``ref.ssm_scan_bwd`` (the plain reverse loop the card
    kernel ``ssm_scan_bwd`` is held to) against ``torch.autograd`` of
    ``ref.ssm_scan`` in float64 (1e-10) and against ``jax.vjp`` of JAX's
    ``ssm_scan_ref`` at ragged S (2e-4, the scan's tolerance:
    tests/test_kernels.py:102-103); ``ops.ssm_scan``'s autograd function
    on the CPU; a gradient on the last state raises;
  * ``mamba_block``'s gradients against ``jax.grad`` of JAX's
    ``mamba_block`` at S 64 and 256 (JAX's chunked scan needs ``S // 128``
    to divide S), and the LM loss's at S 64, within 2e-4;
  * two reference-route train steps at S 256 against JAX's jitted
    ``make_train_step``: losses and gradient norms within 2e-5, then the
    parameters within 1e-4 where sqrt(v) >= 1e-4 after every step (an
    element whose gradient was rounding noise moves by up to lr a step:
    ``tests/test_torch_pipeline.py``, PERF.md);
  * the one-process pp 2 loss, and a 2-rank gloo ``PPRankStep``, against
    JAX's ``make_pp_loss_fn`` on a uniform ssm stack: loss within 2e-5,
    gradients within 2e-4.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.data.pipeline import SyntheticTokens as JTokens  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.parallel import pipeline as jpp  # noqa: E402
from repro.parallel.sharding import ShardingRules as JRules  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import convert, mamba  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import pipeline as tpp  # noqa: E402
from repro_torch.parallel import rank_programs  # noqa: E402
from repro_torch.parallel.launch import run_ranks  # noqa: E402
from repro_torch.train import steps  # noqa: E402

ARCH = "falcon-mamba-7b"
SCAN_TOL = 2e-4
LOSS_TOL, GRAD_TOL = 2e-5, 2e-4
OPT = dict(lr=1e-2, warmup_steps=2)
M, BT, SEQ = 2, 2, 32
PP_LAYERS = [2, 1]
PP3 = dict(arch=ARCH, smoke=True, num_layers=3)


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


def _jax_init(jb):
    """JAX's initial parameters, jitted (eager init dispatches, and
    compiles, op by op)."""
    return jax.jit(jb.init, static_argnums=1)(jax.random.PRNGKey(0), jb.cfg)


def _scan_inputs(B, S, di, ds, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((B, S, di))
    dt = np.log1p(np.exp(rng.standard_normal((B, S, di)) - 1.0))
    Bc = rng.standard_normal((B, S, ds))
    Cc = rng.standard_normal((B, S, ds))
    A = -np.exp(rng.standard_normal((di, ds)) * 0.3)
    dy = rng.standard_normal((B, S, di))
    return tuple(a.astype(dtype) for a in (u, dt, Bc, Cc, A, dy))


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


def _grads(loss_fn, params, *args):
    leaves = adamw.tree_leaves(params)
    for t in leaves:
        t.requires_grad_()
    out = loss_fn(params, *args)
    loss = out[0] if isinstance(out, tuple) else out
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    it = iter(grads)
    return loss.detach(), adamw.tree_map(lambda _: next(it), params)


# ------------------------------------------------------------ the scan ---
def test_plain_scan_vjp_matches_autograd_in_fp64():
    args = [torch.from_numpy(a) for a in _scan_inputs(2, 70, 5, 3,
                                                      dtype=np.float64)]
    x, dy = args[:5], args[5]
    for t in x:
        t.requires_grad_()
    y, _ = ref.ssm_scan(*x)
    want = torch.autograd.grad(y.double(), x, dy)
    # ref.ssm_scan runs in fp32: take the fp64 loop of the VJP's forward
    got = ref.ssm_scan_bwd(*(t.detach() for t in x), dy)
    h = torch.zeros(2, 5, 3, dtype=torch.float64)
    ys = []
    for t in range(70):
        h = torch.exp(x[1][:, t, :, None] * x[4]) * h \
            + (x[1][:, t] * x[0][:, t])[..., None] * x[2][:, t, None]
        ys.append((h * x[3][:, t, None]).sum(-1))
    want64 = torch.autograd.grad(torch.stack(ys, 1), x, dy)
    for g, w, w32 in zip(got, want64, want):
        assert g.dtype == torch.float64
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10)
        torch.testing.assert_close(g.float(), w32.float(), rtol=1e-3,
                                   atol=1e-3)


@pytest.mark.parametrize("S", [37, 129])
def test_plain_scan_vjp_matches_jax_vjp(S):
    u, dt, Bc, Cc, A, dy = _scan_inputs(2, S, 12, 4, seed=S)
    _, vjp = jax.vjp(jref.ssm_scan_ref, *(jnp.asarray(a)
                                          for a in (u, dt, Bc, Cc, A)))
    want = vjp(jnp.asarray(dy))
    got = ref.ssm_scan_bwd(*(torch.from_numpy(a)
                             for a in (u, dt, Bc, Cc, A, dy)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=SCAN_TOL,
                                   atol=SCAN_TOL)
    # the autograd function on the CPU runs the same backward
    x = [torch.from_numpy(a).requires_grad_() for a in (u, dt, Bc, Cc, A)]
    y, _ = ops.ssm_scan(*x)
    for g, w in zip(torch.autograd.grad(y, x, torch.from_numpy(dy)), got):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("S,chunk,decays", [
    (200, 64, "softplus"),    # a ragged last chunk of the kernel's 64
    (64, 64, "softplus"),     # one whole chunk: no carry between chunks
    (61, 8, "near1"),         # dt A ~ 1e-3: decays ~1, 8 chunks
    (45, 7, "underflow"),     # dt A <= -800 on half the channels: exp = 0
])
def test_chunked_scan_vjp_matches_the_plain_loop(S, chunk, decays):
    """The card kernel's split over time (zero-carry chunk walks, the
    carries in series, walks from the carried state), mirrored in plain
    PyTorch, gives the plain reverse loop's VJP in fp64."""
    u, dt, Bc, Cc, A, dy = (torch.from_numpy(a) for a in _scan_inputs(
        2, S, 6, 5, seed=S, dtype=np.float64))
    if decays == "near1":
        dt, A = dt * 1e-3, A * 1e-1
    elif decays == "underflow":
        dt = torch.where(torch.arange(6) % 2 == 0, 900.0 + dt, dt)
        assert (torch.exp(dt[..., None] * A) == 0).any()
    want = ref.ssm_scan_bwd(u, dt, Bc, Cc, A, dy)
    got = ref.ssm_scan_bwd_chunked(u, dt, Bc, Cc, A, dy, chunk=chunk)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10)


def test_last_state_gradient_raises():
    x = [torch.from_numpy(a).requires_grad_()
         for a in _scan_inputs(1, 9, 4, 2)[:5]]
    y, h = ops.ssm_scan(*x)
    (y.sum() + 0 * h.sum()).backward()      # a zero gradient is allowed
    y, h = ops.ssm_scan(*x)
    with pytest.raises(RuntimeError, match="last state has no gradient"):
        h.sum().backward()


# ------------------------------------------------------- block and model --
@pytest.fixture(scope="module")
def models():
    jb = jreg.get_bundle(ARCH, smoke=True)
    jp = _jax_init(jb)
    tp = convert.from_jax(_np(jp), device="cpu")
    return jb, jp, treg.get_bundle(ARCH, smoke=True), tp


@pytest.mark.parametrize("S", [64, 256])
def test_block_and_loss_gradients_match_jax(models, S):
    jb, jp, tb, tp = models
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, jb.cfg.d_model)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    jblk = jax.tree.map(lambda a: a[0], jp["blocks"]["ssm"])
    tblk = {k: v[0].clone() for k, v in tp["blocks"]["ssm"].items()}

    def jblock(p, x):
        return jnp.sum(jmamba.mamba_block(p, x, jb.cfg) * w)

    jl, (jgp, jgx) = jax.jit(jax.value_and_grad(jblock, argnums=(0, 1)))(
        jblk, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    tl, tg = _grads(lambda p: (mamba.mamba_block(p, tx, tb.cfg)
                               * torch.from_numpy(w)).sum(), tblk)
    assert abs(float(tl) - float(jl)) < SCAN_TOL * abs(float(jl))
    assert _max_err(tg, jgp) < SCAN_TOL
    (gx,) = torch.autograd.grad((mamba.mamba_block(tblk, tx, tb.cfg)
                                 * torch.from_numpy(w)).sum(), tx)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=SCAN_TOL,
                               atol=SCAN_TOL)

    if S != 64:         # the train step below takes the loss at S 256
        return
    tok = rng.integers(0, 256, (2, S), dtype=np.int32)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
    rules = JRules(jb.cfg, tp=1, dp_axes=("data",))
    (jl, _), jg = jax.jit(jax.value_and_grad(
        jsteps.make_loss_fn(jb, rules), has_aux=True))(jp, batch)
    tl, tg = _grads(steps.make_loss_fn(tb), tp,
                    {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(tl) - float(jl)) < LOSS_TOL
    assert _max_err(tg, jg) < GRAD_TOL


def test_reference_train_step_matches_jax(models):
    """JAX's jitted ``make_train_step`` from JAX's initial state on its
    first two synthetic batches against the port's train step, remat on
    (each block's scan forward runs twice, its backward once)."""
    jb, jp, tb, _ = models
    rules = JRules(jb.cfg, tp=1, dp_axes=("data",))
    assert jb.cfg.param_dtype == "float32"    # init_train_state's, from jp
    jstate = {"params": jp, "opt": jadamw.init_opt_state(jp, False),
              "step": jnp.zeros((), jnp.int32)}
    tstate = convert.from_jax(_np(jstate), device="cpu")
    jstep = jax.jit(jsteps.make_train_step(jb, rules,
                                           jadamw.AdamWConfig(**OPT)))
    tstep = steps.make_train_step(tb, adamw.AdamWConfig(**OPT))
    data = JTokens(vocab_size=256, seq_len=256, global_batch=2)
    assert tb.cfg.remat
    rms = None      # each element's smallest sqrt(v) over the steps
    for i in range(2):
        batch = data.batch_at(i)
        jstate, jm = jstep(jstate, batch)
        tstate, tm = tstep(tstate, {k: torch.from_numpy(np.array(v))
                                    for k, v in batch.items()})
        assert abs(float(tm["loss"]) - float(jm["loss"])) < LOSS_TOL
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) \
            < LOSS_TOL
        v = {k: np.sqrt(a) for k, a in _flat(_np(jstate["opt"]["v"])).items()}
        rms = v if rms is None else {k: np.minimum(rms[k], v[k]) for k in v}
    # an element whose gradient was rounding noise at some step moves by
    # up to lr there, in a direction the rounding picks (PERF.md)
    jp, tp = _flat(_np(jstate["params"])), _flat(tstate["params"])
    for k, want in jp.items():
        err = np.abs(tp[k].numpy() - np.asarray(want, np.float32))
        assert err.max() < 2 * 2 * OPT["lr"], k
        assert err[rms[k] >= GRAD_TOL / 2].max(initial=0) < GRAD_TOL / 2, k


# ------------------------------------------------------------ pipeline ---
@pytest.fixture(scope="module")
def pp_setup():
    jb = jreg.get_bundle(**PP3)
    jparams = _jax_init(jb)
    batch = jreg.make_batch(jb.cfg, batch=M * BT, seq=SEQ)
    pp_batch = {k: np.asarray(v).reshape(M, BT, *v.shape[1:])
                for k, v in batch.items()}
    # the ranks run while JAX compiles
    from concurrent.futures import ThreadPoolExecutor
    pool = ThreadPoolExecutor(max_workers=1)
    port_np = adamw.tree_map(lambda t: t.numpy(),
                             convert.from_jax(_np(jparams), device="cpu"))
    future = pool.submit(run_ranks, rank_programs.pp_loss_and_grads, 2,
                         timeout_s=120, device="cpu",
                         args=(PP3, port_np, pp_batch,
                               [(PP_LAYERS, "1f1b", 1)]))
    pool.shutdown(wait=False)
    jloss = jpp.make_pp_loss_fn(jb.cfg, None, 2, M,
                                layers_per_stage=PP_LAYERS)
    stacked = jpp.stack_blocks_for_stages(jparams, 2, PP_LAYERS)
    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        stacked, pp_batch)
    jg = tpp.unstack_blocks_for_stages(convert.from_jax(_np(jg),
                                                        device="cpu"),
                                       2, PP_LAYERS)
    return jparams, pp_batch, float(jl), jg, future


def test_pp_loss_matches_jax(pp_setup):
    jparams, pp_batch, jl, jg, _ = pp_setup
    cfg = treg.get_config(**{k: v for k, v in PP3.items() if k != "arch"},
                          arch=ARCH)
    tparams = convert.from_jax(_np(jparams), device="cpu")
    tloss = tpp.make_pp_loss_fn(cfg, 2, M, layers_per_stage=PP_LAYERS)
    tl, tg = _grads(tloss, tparams,
                    {k: torch.from_numpy(np.array(v))
                     for k, v in pp_batch.items()})
    assert abs(float(tl) - jl) < LOSS_TOL
    assert _max_err(tg, jg) < GRAD_TOL
    nonuniform = dataclasses.replace(cfg, family="hybrid",
                                     block_pattern=("ssm", "attn"))
    with pytest.raises(ValueError, match="uniform scanned stack"):
        tpp.make_pp_loss_fn(nonuniform, 2, M)


def test_pp_ranks_match_jax(pp_setup):
    _, _, jl, jg, future = pp_setup
    res = [r[0] for r in future.result()]
    for r in res:
        assert abs(r["loss"] - jl) < LOSS_TOL
        want = tpp.stage_tree(jg, PP_LAYERS, r["stage"])
        got = adamw.tree_map(torch.from_numpy, r["grads"])
        assert _max_err(got, want) < GRAD_TOL
