"""The rest of the dense family through the port against the JAX package,
fp32 SMOKE on the CPU, JAX's parameters carried over by ``from_jax``:
qwen3-14b (qk_norm), nemotron-4-15b (two-matrix squared-ReLU MLP),
h2o-danube-3-4b (sliding window, rolling KV buffer), and llama3-8b SMOKE
with the ``gelu`` and ``geglu`` activations.

Tolerance: atol = rtol = 1e-4, as ``tests/test_torch_model.py`` states it
(fp32 on both sides; matmul order and libm RoPE leave a few 1e-6).

The SWA prefill: JAX writes the last ``window`` positions at the front of
its rolling buffer while its decode reads position a at index a mod the
buffer's length, which agree only where the prompt is no longer than the
buffer or a multiple of it.  The port writes a at a mod the length, and
is held against JAX's windowed ``forward`` of the same tokens at every
prompt length, and against JAX's own prefill and decode only at the
lengths where those agree.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import registry as jreg  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve import scripted_trace as jax_trace  # noqa: E402
from repro_torch.models import convert, layers  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.serve import (ServeEngine, decode_sequential,  # noqa: E402
                               scripted_trace)

TOL = dict(rtol=1e-4, atol=1e-4)
NEW_ARCHS = ("qwen3-14b", "nemotron-4-15b", "h2o-danube-3-4b")
# (arch, config overrides): the new archs, and the other two activations
CASES = [(a, {}) for a in NEW_ARCHS] + [("llama3-8b", {"act": "gelu"}),
                                        ("llama3-8b", {"act": "geglu"})]
CASE_IDS = [a + "".join(f"-{v}" for v in kw.values()) for a, kw in CASES]
MAX_LEN = 24
SWA = "h2o-danube-3-4b"
SWA_MAX_LEN = 96         # SMOKE window 32: the buffer holds 32 positions
SWA_PROMPTS = (20, 32, 40, 64, 70)
SWA_JAX_AGREES = (20, 32, 64)   # <= the buffer, or a multiple of it

_MODELS = {}


def _models(arch, **kw):
    """(JAX bundle, JAX params, port bundle, port params), made once."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _MODELS:
        jb = jreg.get_bundle(arch, smoke=True, **kw)
        jp = jb.init(jax.random.PRNGKey(0), jb.cfg)
        tp = convert.from_jax(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
        _MODELS[key] = (jb, jp, treg.get_bundle(arch, smoke=True, **kw), tp)
    return _MODELS[key]


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B, S),
                                                dtype=np.int32)


def _close(t, j):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **TOL)


# ------------------------------------------------------------- configs ---
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_copied_field_for_field(arch):
    for smoke in (False, True):
        j, t = jreg.get_config(arch, smoke), treg.get_config(arch, smoke)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count()
    jb, tb = jreg.get_bundle(arch), treg.get_bundle(arch)
    assert tb.subquadratic == jb.subquadratic == (arch == SWA)


@pytest.mark.parametrize("arch,kw", CASES, ids=CASE_IDS)
def test_init_has_the_jax_tree_layout(arch, kw):
    """The port's own init builds JAX's tree (q_norm / k_norm leaves, the
    two-matrix MLP), so from_jax stays the identity on layouts."""
    _, _, tb, tp = _models(arch, **kw)
    mine = tb.init(tb.cfg, seed=0, device="cpu")

    def shapes(node):
        if isinstance(node, dict):
            return {k: shapes(v) for k, v in node.items()}
        return (tuple(node.shape), node.dtype)

    assert shapes(mine) == shapes(tp)


# ---------------------------------------- forward, prefill and decode ---
@pytest.mark.parametrize("arch,kw", CASES, ids=CASE_IDS)
def test_forward_prefill_decode_match_jax(arch, kw):
    """lm_forward's logits, then prefill (logits and cache) and 3 decode
    steps at per-row positions [S, S-2], against JAX's."""
    jb, jp, tb, tp = _models(arch, **kw)
    tok = _tokens(2, 12)
    jl, _ = jb.forward(jp, {"tokens": jnp.asarray(tok)}, jb.cfg)
    tl, _ = tb.forward(tp, {"tokens": torch.from_numpy(tok)}, tb.cfg)
    _close(tl, jl)

    S = 11
    tok = _tokens(2, S, seed=1)
    jl, jc = jb.prefill(jp, {"tokens": jnp.asarray(tok)}, jb.cfg, MAX_LEN)
    tl, tc = tb.prefill(tp, {"tokens": torch.from_numpy(tok)}, tb.cfg,
                        MAX_LEN)
    _close(tl, jl)
    _close(tc["kv"]["k"], jc["kv"]["k"])
    _close(tc["kv"]["v"], jc["kv"]["v"])
    jc["pos"] = jnp.asarray([S, S - 2], jnp.int32)
    tc["pos"] = torch.tensor([S, S - 2])
    step_toks = _tokens(3, 2, seed=2)
    for t in range(3):
        nxt = step_toks[t][:, None]
        jl, jc = jb.decode_step(jp, jnp.asarray(nxt), jc, jb.cfg)
        tl, tc = tb.decode_step(tp, torch.from_numpy(nxt), tc, tb.cfg)
        _close(tl, jl)
    _close(tc["kv"]["k"], jc["kv"]["k"])
    _close(tc["kv"]["v"], jc["kv"]["v"])


# ------------------------------------------------- the rolling buffer ---
@pytest.mark.parametrize("S", SWA_PROMPTS)
def test_swa_prefill_and_decode_match_windowed_forward(S):
    """Prefill of S tokens at max_len 96 (a 32-position buffer) and 3
    decode steps: each step's logits equal JAX's windowed forward over the
    whole sequence so far, at its last position."""
    jb, jp, tb, tp = _models(SWA)
    n_dec = 3
    seq = _tokens(1, S + n_dec, seed=S)
    tl, tc = tb.prefill(tp, {"tokens": torch.from_numpy(seq[:, :S])},
                        tb.cfg, SWA_MAX_LEN)
    assert tc["kv"]["k"].shape[2] == tb.cfg.window
    got = [tl]
    for t in range(n_dec):
        tl, tc = tb.decode_step(tp, torch.from_numpy(seq[:, S + t:S + t + 1]),
                                tc, tb.cfg)
        got.append(tl)
    jl, _ = jb.forward(jp, {"tokens": jnp.asarray(seq)}, jb.cfg)
    for t, g in enumerate(got):
        _close(g, jl[:, S - 1 + t])


@pytest.mark.parametrize("S", SWA_JAX_AGREES)
def test_swa_prefill_and_decode_match_jax_where_its_layout_agrees(S):
    """At S <= the buffer or a multiple of it the port's rolling layout is
    JAX's: the caches and every step's logits agree with JAX's prefill and
    decode, per-row positions included."""
    jb, jp, tb, tp = _models(SWA)
    seq = _tokens(2, S + 4, seed=100 + S)
    jl, jc = jb.prefill(jp, {"tokens": jnp.asarray(seq[:, :S])}, jb.cfg,
                        SWA_MAX_LEN)
    tl, tc = tb.prefill(tp, {"tokens": torch.from_numpy(seq[:, :S])},
                        tb.cfg, SWA_MAX_LEN)
    _close(tl, jl)
    _close(tc["kv"]["k"], jc["kv"]["k"])
    _close(tc["kv"]["v"], jc["kv"]["v"])
    jc["pos"] = jnp.asarray([S, S], jnp.int32)
    tc["pos"] = torch.tensor([S, S])
    for t in range(4):
        nxt = seq[:, S + t:S + t + 1]
        jl, jc = jb.decode_step(jp, jnp.asarray(nxt), jc, jb.cfg)
        tl, tc = tb.decode_step(tp, torch.from_numpy(nxt), tc, tb.cfg)
        _close(tl, jl)
    _close(tc["kv"]["k"], jc["kv"]["k"])


@pytest.mark.parametrize("S,window", [(6, 5), (6, 6), (8, 32)])
def test_swa_decode_mask_reads_the_live_window(S, window):
    """decode_mask on a rolling buffer of S, scalar rows and a batch of
    unequal positions, against a count: index i is read iff the latest
    position a <= pos with a mod S == i lies inside the window."""
    def want(pos):
        out = []
        for i in range(S):
            held = [a for a in range(pos + 1) if a % S == i]
            out.append(bool(held) and max(held) > pos - window)
        return out

    posv = torch.arange(0, 3 * S + 2)
    got = layers.decode_mask(S, posv, window)
    assert got.tolist() == [want(int(p)) for p in posv]
    flat = layers.decode_mask(S, posv, None)
    assert flat.tolist() == [[i <= p for i in range(S)] for p in
                             posv.tolist()]


# ------------------------------------------------------------- serving ---
@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_swa_engine_matches_sequential_across_the_window(temp):
    """danube SMOKE at max_len 48 (a 32-position buffer): prompts and
    streams that cross the window, continuous batching against each
    request alone."""
    _, _, tb, tp = _models(SWA)
    reqs = scripted_trace(6, vocab_size=256, seed=4,
                          prompt_lens=(20, 30, 36), gen_lens=(6, 12),
                          arrival_every=1)
    rep = ServeEngine(tb, tp, max_batch=3, max_len=48, temperature=temp,
                      seed=5, device="cpu").run(reqs)
    want = decode_sequential(tb, tp, reqs, max_len=48, temperature=temp,
                             seed=5, device="cpu")
    assert {c.rid: c.tokens for c in rep.completions} == want


@pytest.mark.parametrize("arch", ["qwen3-14b", "nemotron-4-15b"])
def test_greedy_streams_equal_jax_engine(arch):
    jb, jp, tb, tp = _models(arch)
    reqs = scripted_trace(6, vocab_size=256, seed=3)
    want = JaxServeEngine(jb, jp, max_batch=3, max_len=40).run(
        jax_trace(6, vocab_size=256, seed=3))
    got = ServeEngine(tb, tp, max_batch=3, max_len=40,
                      device="cpu").run(reqs)
    assert {c.rid: c.tokens for c in got.completions} == \
        {c.rid: c.tokens for c in want.completions}


# ------------------------------------------------- tp over the MLPs ---
class _SumOfParts:
    """A model communicator whose all-reduce hands each rank's part back
    unreduced (the test adds the parts)."""

    def iallreduce(self, x):
        return x


@pytest.mark.parametrize("arch,kw", [("nemotron-4-15b", {}),
                                     ("llama3-8b", {"act": "gelu"}),
                                     ("llama3-8b", {"act": "geglu"})],
                         ids=["sq_relu", "gelu", "geglu"])
def test_tp_mlp_forward_on_a_fake_split(arch, kw):
    """The two-matrix and geglu MLPs split over 2 model ranks, each rank
    its columns of ``w_up`` (and ``w_gate``) and rows of ``w_down``: the
    ranks' partial outputs add up to the whole MLP's."""
    _, _, tb, tp = _models(arch, **kw)
    blk = {k: v[0] for k, v in tp["blocks"]["mlp"].items()}
    F = tb.cfg.d_ff
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 5, tb.cfg.d_model)).astype(np.float32))
    parts = []
    for r in range(2):
        cols = slice(r * F // 2, (r + 1) * F // 2)
        half = {k: (w[cols] if k == "w_down" else w[:, cols])
                for k, w in blk.items()}
        parts.append(layers.mlp(half, x, tb.cfg, model=_SumOfParts()))
    torch.testing.assert_close(parts[0] + parts[1],
                               layers.mlp(blk, x, tb.cfg), **TOL)
