"""The port's cp ring (``repro_torch.kernels.ring_attention`` and its
plain versions on the CPU) against the JAX package's ring: the Pallas
``ring_step`` in interpret mode, the jnp fold ``_ring_step_ref`` and the
host ring ``ring_flash_attention`` with ``jax.grad``.  Also
``torch.autograd.gradcheck`` of the port's four autograd functions in
fp64, and the kernel wrappers' refusal of inputs that need a gradient.

Also the cp loss's ICCL notes against those JAX's sink takes while the
JAX cp loss is traced.

Tolerances are the JAX package's (tests/test_kernels.py:15-17 and
tests/test_context_parallel.py): fp32 2e-5, bf16 2e-2 (one rounding of
the inputs), gradients through the ring 2e-4, a fully masked hop 1e-6.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.iccl import communicator as jcomm  # noqa: E402
from repro.kernels import ring_attention as jra  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.parallel import context as jcontext  # noqa: E402
from repro_torch.iccl import communicator as tcomm  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ring_attention as tra  # noqa: E402
from repro_torch.kernels import rmsnorm as trn  # noqa: E402
from repro_torch.kernels import ssm_scan as tss  # noqa: E402
from repro_torch.kernels import swiglu as tsg  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.parallel import context  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's in-process port code (SMOKE
    sizes gain nothing from more), so that test workers running side by
    side do not oversubscribe the host's cores; restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _pair(rng, shape, name="float32"):
    a = rng.standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[name]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _t(x):
    """A jax array as an fp32 torch tensor."""
    return torch.from_numpy(np.array(x, np.float32))


def _close(got_t, want_j, tol):
    np.testing.assert_allclose(got_t.detach().float().numpy(),
                               np.asarray(want_j, np.float32), **tol)


def _empty_state(B, Cq, H, hd):
    return (jnp.full((B, Cq, H, 1), jra.NEG_INF, jnp.float32),
            jnp.zeros((B, Cq, H, 1), jnp.float32),
            jnp.zeros((B, Cq, H, hd), jnp.float32))


# ------------------------------------------------------- one ring hop ----
@pytest.mark.parametrize("q_start,k_start,k_valid", [
    (0, 0, 48),       # self hop (ring step 0): causal diagonal inside
    (48, 0, 48),      # past hop: fully visible prefix block
    (0, 48, 48),      # wrap hop: KV from a LATER chunk, fully masked
    (64, 32, 17),     # masked partial chunk: only 17 of 48 rows real
])
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_ring_step_matches_pallas(q_start, k_start, k_valid, name):
    """One hop of the port (one rank) against the Pallas hop in interpret
    mode and the jnp fold, from a warm carry (a previous self hop), across
    the hop geometries of tests/test_kernels.py:145-150."""
    B, Cq, Ck, H, Hk, hd = 2, 48, 48, 4, 2, 32
    rng = np.random.default_rng(3)
    qj, qt = _pair(rng, (B, Cq, H, hd), name)
    kj, kt = _pair(rng, (B, Ck, Hk, hd), name)
    vj, vt = _pair(rng, (B, Ck, Hk, hd), name)
    warm = jra._ring_step_ref(qj, qj[:, :, :Hk], vj, *_empty_state(B, Cq, H, hd),
                              q_start=q_start, k_start=q_start, k_valid=Cq,
                              causal=True, sm_scale=1.0 / math.sqrt(hd))
    pallas = jra.ring_step(qj, kj, vj, *warm, q_start=q_start,
                           k_start=k_start, k_valid=k_valid, causal=True,
                           block_q=32, block_k=32, interpret=True)
    jnp_ref = jra._ring_step_ref(qj, kj, vj, *warm, q_start=q_start,
                                 k_start=k_start, k_valid=k_valid,
                                 causal=True, sm_scale=1.0 / math.sqrt(hd))
    got = ops.ring_step(qt[None], kt[None], vt[None],
                        *(_t(w)[None] for w in warm),
                        [(q_start, 0, k_start, k_valid, Cq)], causal=True)
    for g, p, w in zip(got, pallas, jnp_ref):
        assert g.dtype == torch.float32
        _close(g[0], p, _tol(name))
        _close(g[0], w, _tol(name))


def test_ring_step_fully_masked_hop_is_noop():
    """A wrap hop under causality (every key in the future) passes a
    seeded carry through (tests/test_kernels.py:179-205, 1e-6)."""
    B, C, H, Hk, hd = 1, 32, 2, 2, 16
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, B, C, H, hd), (1, B, C, Hk, hd),
                         (1, B, C, Hk, hd)))
    empty = (torch.full((1, B, C, H, 1), ref.NEG_INF),
             torch.zeros(1, B, C, H, 1), torch.zeros(1, B, C, H, hd))
    state = ops.ring_step(q, k, v, *empty, [(0, 0, 0, C, C)])
    after = ops.ring_step(q, k, v, *state, [(0, 0, C, C, C)])
    for a, b in zip(after, state):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_ring_step_rank_batched_matches_per_rank_folds():
    """One batched call folds ring step s for every rank: on each rank's
    real rows it equals the jnp fold run rank by rank on the source
    rank's KV block, for every step of a ragged cp = 3 ring.  The pad rows
    past a rank's chunk (its ``q_valid``), which JAX folds and drops, see
    no key and keep the empty carry exactly."""
    chunks = (40, 31, 25)
    cp, cmax, B, H, Hk, hd = 3, 40, 2, 4, 2, 32
    starts = tra.chunk_starts(chunks)
    rng = np.random.default_rng(5)
    qj, qt = _pair(rng, (cp, B, cmax, H, hd))
    kj, kt = _pair(rng, (cp, B, cmax, Hk, hd))
    vj, vt = _pair(rng, (cp, B, cmax, Hk, hd))
    jstate = [_empty_state(B, cmax, H, hd) for _ in range(cp)]
    tstate = (torch.full((cp, B, cmax, H, 1), ref.NEG_INF),
              torch.zeros(cp, B, cmax, H, 1), torch.zeros(cp, B, cmax, H, hd))
    for s in range(cp):
        hops = tra.ring_hops(chunks, s)
        assert [h[1] for h in hops] == [(r - s) % cp for r in range(cp)]
        tstate = ops.ring_step(qt, kt, vt, *tstate, hops)
        for r, (q_start, src, k_start, k_valid, q_valid) in enumerate(hops):
            assert q_start == starts[r] and k_valid == chunks[src]
            assert q_valid == chunks[r]
            jstate[r] = jra._ring_step_ref(
                qj[r], kj[src], vj[src], *jstate[r], q_start=q_start,
                k_start=k_start, k_valid=k_valid, causal=True,
                sm_scale=1.0 / math.sqrt(hd))
        for r, c in enumerate(chunks):
            for g, w in zip(tstate, jstate[r]):
                _close(g[r][:, :c], w[:, :c], _tol("float32"))
            m, l, acc = (t[r][:, c:] for t in tstate)
            assert (m == ref.NEG_INF).all() and not l.any() and not acc.any()


# ------------------------------------------- real rows of a hop table ----
@pytest.mark.parametrize("chunks", [(40, 31, 25), (1, 94, 1), (48, 48)])
def test_ring_hops_carry_each_ranks_real_rows(chunks):
    """Every hop of every ring step carries the visiting chunk's real key
    count and the rank's own real q count: q_valid = the rank's chunk."""
    starts = tra.chunk_starts(chunks)
    for s in range(len(chunks)):
        for r, (q_start, src, k_start, k_valid, q_valid) in enumerate(
                tra.ring_hops(chunks, s)):
            assert (q_start, k_start) == (starts[r], starts[src])
            assert (k_valid, q_valid) == (chunks[src], chunks[r])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_plain_hops_skip_pad_rows_and_keep_real_rows(direction, causal):
    """The plain hop and its VJP with each rank's q_valid give the real
    rows of the same hops with q_valid = Cq.  The pad rows see no key: the
    forward leaves their empty carry as it was, and (with dout 0 there, as
    ``unpad_chunks``' gradient gives) the backward gives them dq = 0."""
    chunks = (40, 31, 25)
    cp, C, B, H, Hk, hd = 3, 40, 2, 4, 2, 16
    g = torch.Generator().manual_seed(7)
    q, k, v, do = (torch.randn(cp, B, C, h, hd, generator=g)
                   for h in (H, Hk, Hk, H))
    for r, c in enumerate(chunks):
        do[r, :, c:] = 0
    tables = [tra.ring_hops(chunks, s) for s in range(cp)]
    full = [[h[:4] + (C,) for h in t] for t in tables]
    empty = (torch.full((cp, B, C, H, 1), ref.NEG_INF),
             torch.zeros(cp, B, C, H, 1), torch.zeros(cp, B, C, H, hd))
    carries = {}
    for name, tabs in (("q_valid", tables), ("full", full)):
        carry = empty
        for t in tabs:
            carry = ref.ring_step(q, k, v, *carry, t, causal=causal)
        carries[name] = carry
    if direction == "forward":
        for got, want, e in zip(carries["q_valid"], carries["full"], empty):
            for r, c in enumerate(chunks):
                torch.testing.assert_close(got[r, :, :c], want[r, :, :c],
                                           rtol=0, atol=0)
                assert torch.equal(got[r, :, c:], e[r, :, c:])
        return
    m, l, acc = carries["q_valid"]
    o = acc / l.clamp_min(1e-30)
    lse = torch.where(l > 0, m + torch.log(l), torch.inf)[..., 0]
    delta = (do * o).sum(-1)
    grads = {}
    for name, tabs in (("q_valid", tables), ("full", full)):
        acc3 = [torch.zeros(t.shape) for t in (q, k, v)]
        for t in tabs:
            ref.ring_step_bwd(q, k, v, do, lse, delta, *acc3, t,
                              causal=causal)
        grads[name] = acc3
    for got, want in zip(grads["q_valid"], grads["full"]):
        for r, c in enumerate(chunks):
            torch.testing.assert_close(got[r, :, :c], want[r, :, :c],
                                       **_tol("float32"))
    for r, c in enumerate(chunks):
        assert not grads["q_valid"][0][r, :, c:].any()


# ----------------------------------------------------------- the ring ----
@pytest.mark.parametrize("chunks", [(48, 48), (40, 31, 25), (1, 94, 1)])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_flash_attention_matches_jax(chunks, causal):
    S = sum(chunks)
    rng = np.random.default_rng(0)
    qj, qt = _pair(rng, (2, S, 4, 32))
    kj, kt = _pair(rng, (2, S, 2, 32))
    vj, vt = _pair(rng, (2, S, 2, 32))
    got = tra.ring_flash_attention(qt, kt, vt, chunks, causal=causal)
    want = jra.ring_flash_attention(qj, kj, vj, chunks, causal=causal)
    _close(got, want, _tol("float32"))


@pytest.mark.parametrize("chunks", [(48, 48), (40, 31, 25), (1, 94, 1)])
def test_ring_flash_attention_grads_match_jax(chunks):
    """The port's ring backward (cp hop backwards from the final
    logsumexp) against jax.grad through JAX's folds, running max
    included (tests/test_context_parallel.py:65-98)."""
    S = sum(chunks)
    rng = np.random.default_rng(1)
    qj, qt = _pair(rng, (1, S, 4, 32))
    kj, kt = _pair(rng, (1, S, 2, 32))
    vj, vt = _pair(rng, (1, S, 2, 32))

    def f_jax(q, k, v):
        return jnp.sum(jnp.square(
            jra.ring_flash_attention(q, k, v, chunks, causal=True)))

    want = jax.grad(f_jax, argnums=(0, 1, 2))(qj, kj, vj)
    ins = [t.clone().requires_grad_() for t in (qt, kt, vt)]
    loss = torch.sum(torch.square(
        tra.ring_flash_attention(*ins, chunks, causal=True)))
    got = torch.autograd.grad(loss, ins)
    for g, w in zip(got, want):
        _close(g, w, dict(rtol=2e-4, atol=2e-4))


def test_ring_attention_rejects_a_layout_that_is_not_the_chunks():
    q = torch.zeros(2, 1, 8, 2, 16)
    with pytest.raises(ValueError, match="padded layout"):
        ops.ring_attention(q, q[:, :, :, :1], q[:, :, :, :1], (5, 4))


# ------------------------------------------------ autograd functions ----
def _f64(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=torch.float64,
                       requires_grad=True)


@pytest.mark.parametrize("case", ["rmsnorm", "swiglu", "flash", "ring"])
def test_autograd_functions_pass_gradcheck(case):
    """Each autograd function's backward (the plain ``*_bwd`` on the CPU,
    the math the card's backward kernels compute) against finite
    differences, fp64, tiny sizes."""
    if case == "rmsnorm":
        fn, ins = (lambda x, s: ops.rmsnorm(x, s, 1e-5),
                   (_f64(3, 5, 16), _f64(16, seed=1)))
    elif case == "swiglu":
        fn, ins = ops.swiglu, (_f64(4, 24), _f64(4, 24, seed=1))
    elif case == "flash":
        # Sq < Sk: queries at the end of the keys, GQA
        fn, ins = (lambda q, k, v: ops.flash_attention(q, k, v, causal=True),
                   (_f64(2, 7, 4, 8), _f64(2, 9, 2, 8, seed=1),
                    _f64(2, 9, 2, 8, seed=2)))
    else:
        chunks = (4, 3, 2)
        fn = lambda q, k, v: ops.ring_attention(  # noqa: E731
            q, k, v, chunks, causal=True)
        ins = tuple(tra.pad_chunks(t, chunks).detach().requires_grad_()
                    for t in (_f64(1, 9, 4, 8), _f64(1, 9, 2, 8, seed=1),
                              _f64(1, 9, 2, 8, seed=2)))
    assert torch.autograd.gradcheck(fn, ins)


@pytest.mark.parametrize("case", ["rmsnorm", "swiglu", "flash"])
def test_ops_use_the_autograd_function_only_when_a_grad_is_needed(case):
    """Serving calls (no input requires grad) go to the forward directly
    and give the same values as the autograd function, which a training
    call goes through."""
    x = torch.randn(1, 8, 2, 16)
    fn = {"rmsnorm": lambda a: ops.rmsnorm(a, torch.ones(16)),
          "swiglu": lambda a: ops.swiglu(a, a),
          "flash": lambda a: ops.flash_attention(a, a, a)}[case]
    plain = fn(x)
    assert plain.grad_fn is None
    traced = fn(x.clone().requires_grad_())
    assert type(traced.grad_fn).__name__.endswith("FnBackward")
    torch.testing.assert_close(traced.detach(), plain, rtol=0, atol=0)


@pytest.mark.parametrize("window,softcap,hd,Sq", [
    (4, None, 16, 12), (None, 20.0, 16, 12), (4, 2.0, 16, 12),
    (5, 3.0, 120, 12), (3, None, 24, 7)])
def test_flash_backward_takes_window_softcap_and_any_head_dim(window, softcap,
                                                              hd, Sq):
    """The flash backward (the one-rank hop backward, P from the forward's
    logsumexp) with a window, a softcap, both, at head dims 120 and 24
    and with the queries at the end of the keys, against autograd through
    the plain forward: the same gradients in exact arithmetic."""
    rng = np.random.default_rng(8)
    B, Sk, H, Hk = 2, 12, 4, 2
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   for s in ((B, Sq, H, hd), (B, Sk, Hk, hd),
                             (B, Sk, Hk, hd), (B, Sq, H, hd)))
    kw = dict(causal=True, window=window, softcap=softcap)
    ins = tuple(t.clone().requires_grad_() for t in (q, k, v))
    got = torch.autograd.grad(ops.flash_attention(*ins, **kw), ins, do)
    ins = tuple(t.clone().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(ref.flash_attention(*ins, **kw), ins, do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5)


def test_flash_attention_returns_its_logsumexp():
    """The lse the backward starts from: logsumexp of each row's visible
    scores, +inf for a row that sees no key (Sq > Sk)."""
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.standard_normal((1, 12, 2, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 8, 2, 16)).astype(np.float32))
    _, lse = ref.flash_attention(q, k, k, causal=True, return_lse=True)
    s = torch.einsum("bqhd,bkhd->bqhk", q, k) / 4.0
    for i in range(4, 12):
        want = torch.logsumexp(s[0, i, :, :i - 3], dim=-1)
        torch.testing.assert_close(lse[0, i], want)
    assert torch.isinf(lse[0, :4]).all() and (lse[0, :4] > 0).all()


# ---------------------------------------------- no silent detach guard ----
def _wrapper_calls():
    x = torch.randn(2, 64)
    q = torch.randn(1, 8, 2, 16)
    r = torch.randn(1, 1, 8, 2, 16)
    m = torch.zeros(1, 1, 8, 2, 1)
    u, bc = torch.randn(1, 8, 16), torch.randn(1, 8, 4)
    return {
        "rmsnorm": (trn.rmsnorm, (x, torch.ones(64))),
        "rmsnorm_bwd": (trn.rmsnorm_bwd, (x, torch.ones(64), x)),
        "swiglu": (tsg.swiglu, (x, x)),
        "swiglu_bwd": (tsg.swiglu_bwd, (x, x, x)),
        "flash_attention": (tfa.flash_attention, (q, q, q)),
        "ring_step": (lambda *a: tra.ring_step(*a, [(0, 0, 0, 8, 8)]),
                      (r, r, r, m, m, r)),
        "ssm_scan": (tss.ssm_scan, (u, u, bc, bc, torch.randn(16, 4))),
    }


@pytest.mark.parametrize("kernel", list(_wrapper_calls()))
def test_kernel_wrapper_refuses_inputs_that_need_grad(kernel):
    """A wrapper's output has no grad_fn: with grad mode on and an input
    that requires grad it raises instead of cutting the graph; with grad
    mode off (as inside an autograd function) the guard lets the call
    through to the device check."""
    fn, args = _wrapper_calls()[kernel]
    needs = (args[0].clone().requires_grad_(),) + args[1:]
    with pytest.raises(RuntimeError, match="kernels.ops"):
        fn(*needs)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA kernel"):
        fn(*needs)


@pytest.mark.parametrize("chunks", [(20, 12), (40, 31, 25)])
def test_cp_ring_tap_notes_match_jax_trace(chunks):
    """Each layer of the port's cp loss notes the ring's cp - 1 hops of K
    and of V: the notes JAX's sink takes while the JAX cp loss is traced,
    whose layers are one ``lax.scan`` body traced once."""
    jb = jreg.get_bundle("llama3-8b", smoke=True)
    tb = treg.get_bundle("llama3-8b", smoke=True)
    jparams = jb.init(jax.random.PRNGKey(0), jb.cfg)
    tparams = convert.from_jax(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    batch = jreg.make_batch(jb.cfg, batch=2, seq=sum(chunks))
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    jnotes, tnotes = [], []
    jcomm.set_collective_sink(lambda *a: jnotes.append(a))
    try:
        jax.eval_shape(jcontext.make_cp_loss_fn(jb.cfg, None, chunks),
                       jparams, batch)
    finally:
        jcomm.set_collective_sink(None)
    tcomm.set_collective_sink(lambda *a: tnotes.append(a))
    try:
        with torch.no_grad():
            context.make_cp_loss_fn(tb.cfg, chunks)(tparams, tbatch)
    finally:
        tcomm.set_collective_sink(None)
    cfg, cp = tb.cfg, len(chunks)
    kv_bytes = cp * 2 * max(chunks) * cfg.n_kv_heads * cfg.hd * 4
    assert jnotes == [("cp_ring", "pod", kv_bytes)] * 2 * (cp - 1)
    assert tnotes == jnotes * cfg.num_layers
