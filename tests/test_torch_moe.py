"""The MoE family (mixtral-8x7b, phi3.5-moe-42b-a6.6b) through the port
against the JAX package, fp32 SMOKE on the CPU, JAX's parameters carried
over by ``from_jax``.

  * the configs copied field for field, and ``init_lm`` / ``from_jax``
    keeping JAX's tree (router fp32, experts stacked ``(L, E, ...)``);
  * ``moe.moe_mlp`` against JAX's ``moe_mlp`` on numpy-seeded weights and
    activations whose router favours one expert, at the default capacity
    factor (tokens are dropped) and at 8.0 (none are): the routing indices
    against ``jax.lax.top_k``, the kept slots against JAX's dispatch
    arithmetic, the output and the aux loss; ties route as
    ``jax.lax.top_k`` does (the lower index first);
  * the SMOKE forward, prefill and decode of both archs against JAX's.
    mixtral's SMOKE window is 32: its forward is held at S 40 and 64, its
    prefill and decode where JAX's prefill layout agrees with its decode
    (S <= the buffer, or a multiple of it; ROADMAP reference behaviours);
  * greedy engine streams against ``decode_sequential`` and the JAX
    engine on the same trace and weights (the serving contract for MoE is
    token-stream equality: its output depends on the batch's width at
    ~1e-7).

Tolerance: atol = rtol = 1e-4 for outputs, as ``tests/test_torch_model.py``
(fp32 on both sides, sums in other orders); the aux loss at 1e-6 (a sum of
E products of means); routing and slots exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve import scripted_trace as jax_trace  # noqa: E402
from repro_torch.models import convert, moe  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.serve import (ServeEngine, decode_sequential,  # noqa: E402
                               scripted_trace)

TOL = dict(rtol=1e-4, atol=1e-4)
AUX_TOL = 1e-6
ARCHS = ("mixtral-8x7b", "phi3.5-moe-42b-a6.6b")
MAX_LEN = 96             # mixtral SMOKE: a rolling buffer of 32
_MODELS = {}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's in-process port code (SMOKE
    sizes gain nothing from more), so that test workers running side by
    side do not oversubscribe the host's cores; restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _models(arch):
    """(JAX bundle, JAX params, port bundle, port params), made once."""
    if arch not in _MODELS:
        jb = jreg.get_bundle(arch, smoke=True)
        jp = jax.jit(jb.init, static_argnums=1)(jax.random.PRNGKey(0),
                                                jb.cfg)
        tp = convert.from_jax(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
        _MODELS[arch] = (jb, jp, treg.get_bundle(arch, smoke=True), tp)
    return _MODELS[arch]


_JITTED = {}


def _jax_fns(jb):
    """JAX's forward, prefill (at MAX_LEN) and decode step, jitted once an
    arch (eager JAX dispatches op by op)."""
    if jb.cfg.name not in _JITTED:
        cfg = jb.cfg
        _JITTED[cfg.name] = (
            jax.jit(lambda p, t: jb.forward(p, {"tokens": t}, cfg)),
            jax.jit(lambda p, t: jb.prefill(p, {"tokens": t}, cfg,
                                            MAX_LEN)),
            jax.jit(lambda p, t, c: jb.decode_step(p, t, c, cfg)))
    return _JITTED[jb.cfg.name]


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B, S),
                                                dtype=np.int32)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **tol)


# ------------------------------------------------------------- configs ---
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_tree_match_jax(arch):
    for smoke in (False, True):
        j, t = jreg.get_config(arch, smoke), treg.get_config(arch, smoke)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count()
        assert t.param_count(True) == j.param_count(True)
    assert arch in treg.ARCH_IDS
    jb, jp, tb, tp = _models(arch)
    mine = tb.init(tb.cfg, seed=0, device="cpu")

    def shapes(node):
        if isinstance(node, dict):
            return {k: shapes(v) for k, v in node.items() if k != "_stacked"}
        return (tuple(node.shape), str(node.dtype).split(".")[-1])

    assert shapes(mine) == shapes(tp) == shapes(jp)
    assert set(mine["blocks"]) == {"ln1", "attn", "ln2", "moe"}
    c = tb.cfg
    assert tuple(tp["blocks"]["moe"]["w_gate"].shape) == (
        c.num_layers, c.n_experts, c.d_model, c.d_ff)
    assert tp["blocks"]["moe"]["router"].dtype == torch.float32
    # from_jax is the identity on the MoE tree's layouts
    for path in ("router", "w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(
            tp["blocks"]["moe"][path].numpy(),
            np.asarray(jp["blocks"]["moe"][path]))
    bf = treg.get_config(arch, smoke=True, param_dtype="bfloat16")
    p = moe.init_moe(torch.Generator().manual_seed(0), bf, 2)
    assert p["w_down"].dtype == torch.bfloat16
    assert p["router"].dtype == torch.float32


def test_capacity_matches_jax():
    for arch in ARCHS:
        for smoke in (False, True):
            cfg = jreg.get_config(arch, smoke)
            tcfg = treg.get_config(arch, smoke)
            for S in (1, 2, 7, 8, 9, 64, 100, 4096):
                assert moe.row_capacity(S, tcfg) == jmoe.row_capacity(S, cfg)
    cfg = treg.get_config("mixtral-8x7b")
    assert moe.row_capacity(1, cfg) == 1      # a decode step keeps both


# ----------------------------------------------------------- the layer ---
def _layer_inputs(cfg, B, S, seed=0):
    """One layer's weights and activations; the router leans to expert 0
    for tokens along a shared direction, so the capacity binds."""
    rng = np.random.default_rng(seed)
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    lean = rng.standard_normal(D).astype(np.float32)
    router = (rng.standard_normal((D, E)) / np.sqrt(D)).astype(np.float32)
    router[:, 0] += 0.5 * lean / np.linalg.norm(lean)
    p = {"router": router,
         "w_gate": (rng.standard_normal((E, D, F)) / np.sqrt(D)
                    ).astype(np.float32),
         "w_up": (rng.standard_normal((E, D, F)) / np.sqrt(D)
                  ).astype(np.float32),
         "w_down": (rng.standard_normal((E, F, D)) / np.sqrt(F)
                    ).astype(np.float32)}
    x = (rng.standard_normal((B, S, D)) + 0.6 * lean).astype(np.float32)
    return p, x


def _jax_slots(p, x, cfg):
    """JAX's top-k indices and its dispatch arithmetic
    (``repro/models/moe.py:_moe_mlp_gspmd``): (idx, pos, keep)."""
    E, K = cfg.n_experts, cfg.top_k
    C = jmoe.row_capacity(x.shape[1], cfg)
    gates = jax.nn.softmax(jnp.einsum("bsd,de->bse", x, p["router"]), -1)
    _, gidx = jax.lax.top_k(gates, K)
    fill = jnp.zeros((x.shape[0], E), jnp.int32)
    pos_k, keep_k = [], []
    for k in range(K):
        e = gidx[..., k]
        oh = jax.nn.one_hot(e, E, dtype=jnp.int32)
        rank = jnp.cumsum(oh, axis=1) - oh
        pos = jnp.take_along_axis(rank, e[..., None], axis=2)[..., 0] \
            + jnp.take_along_axis(fill, e, axis=1)
        keep_k.append(pos < C)
        pos_k.append(jnp.where(pos < C, pos, 0))
        fill = fill + jnp.sum(oh, axis=1)
    return (np.asarray(gidx), np.asarray(jnp.stack(pos_k, -1)),
            np.asarray(jnp.stack(keep_k, -1)))


@pytest.mark.parametrize("act", ["swiglu", "sq_relu"])
@pytest.mark.parametrize("factor,drops", [(1.25, True), (8.0, False)])
def test_moe_layer_matches_jax(factor, drops, act):
    cfg = dataclasses.replace(jreg.get_config("mixtral-8x7b", True),
                              capacity_factor=factor, act=act)
    tcfg = dataclasses.replace(treg.get_config("mixtral-8x7b", True),
                               capacity_factor=factor, act=act)
    p, x = _layer_inputs(cfg, 2, 48)
    jout, jaux = jax.jit(lambda p_, x_: jmoe.moe_mlp(p_, x_, cfg))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tx = torch.from_numpy(x)
    tout, taux = moe.moe_mlp(tp, tx, tcfg)
    _close(tout, jout)
    assert abs(float(taux) - float(jaux)) < AUX_TOL
    r = moe.route(tp["router"], tx, tcfg, moe.row_capacity(48, tcfg))
    idx, pos, keep = _jax_slots(p, x, cfg)
    np.testing.assert_array_equal(r.idx.numpy(), idx)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_array_equal(r.pos.numpy(), pos)
    assert (not keep.all()) == drops
    assert (r.weight.numpy()[~keep] == 0).all()


def test_ties_route_as_jax_top_k():
    """Equal gates (equal router columns): the lower expert index first,
    as ``jax.lax.top_k``."""
    cfg = jreg.get_config("phi3.5-moe-42b-a6.6b", True)
    tcfg = treg.get_config("phi3.5-moe-42b-a6.6b", True)
    rng = np.random.default_rng(5)
    router = rng.standard_normal((cfg.d_model, 4)).astype(np.float32)
    router[:, 3] = router[:, 1]
    router[:, 2] = router[:, 0]
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    gates = jax.nn.softmax(jnp.einsum("bsd,de->bse", x, router), -1)
    _, want = jax.lax.top_k(gates, 3)
    _, got = moe.top_k(torch.softmax(torch.from_numpy(x)
                                     @ torch.from_numpy(router), -1), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    r = moe.route(torch.from_numpy(router), torch.from_numpy(x), tcfg, 16)
    np.testing.assert_array_equal(r.idx.numpy(), np.asarray(want)[..., :2])


# ------------------------------------------------------------ the model ---
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    jb, jp, tb, tp = _models(arch)
    jforward = _jax_fns(jb)[0]
    for S in (40, 64):
        tok = _tokens(2, S, seed=S)
        jl, jaux = jforward(jp, jnp.asarray(tok))
        tl, taux = tb.forward(tp, {"tokens": torch.from_numpy(tok)}, tb.cfg)
        _close(tl, jl)
        assert abs(float(taux) - float(jaux)) < AUX_TOL
        assert float(taux) > 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S", [20, 64])
def test_prefill_and_decode_match_jax(arch, S):
    """Prefill logits and cache, then 4 decode steps (a step's row has
    S = 1: capacity 1 and both experts kept); mixtral's buffer of 32 takes
    S 20 whole and S 64 wrapped twice."""
    jb, jp, tb, tp = _models(arch)
    _, jprefill, jdecode = _jax_fns(jb)
    tok = _tokens(2, S, seed=S + 1)
    jl, jc = jprefill(jp, jnp.asarray(tok))
    tl, tc = tb.prefill(tp, {"tokens": torch.from_numpy(tok)}, tb.cfg,
                        MAX_LEN)
    _close(tl, jl)
    _close(tc["kv"]["k"], jc["kv"]["k"])
    _close(tc["kv"]["v"], jc["kv"]["v"])
    steps = _tokens(4, 2, seed=3)
    for t in range(4):
        nxt = steps[t][:, None]
        jl, jc = jdecode(jp, jnp.asarray(nxt), jc)
        tl, tc = tb.decode_step(tp, torch.from_numpy(nxt), tc, tb.cfg)
        _close(tl, jl)
    assert int(tc["pos"]) == int(jc["pos"]) == S + 4


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_streams_equal_sequential_and_jax(arch):
    jb, jp, tb, tp = _models(arch)
    kw = dict(vocab_size=256, seed=3, prompt_lens=(6, 24),
              gen_lens=(4, 12))
    reqs, jreqs = scripted_trace(4, **kw), jax_trace(4, **kw)
    got = ServeEngine(tb, tp, max_batch=3, max_len=48, device="cpu").run(reqs)
    streams = {c.rid: c.tokens for c in got.completions}
    assert streams == decode_sequential(tb, tp, reqs, max_len=48,
                                        device="cpu")
    want = JaxServeEngine(jb, jp, max_batch=3, max_len=48).run(jreqs)
    assert streams == {c.rid: c.tokens for c in want.completions}
