"""recurrentgemma-9b (the hybrid stack: RG-LRU blocks and local attention
in groups and a tail) through the port against the JAX package, fp32
SMOKE on the CPU, JAX's parameters carried over by ``from_jax`` and the
inputs made from numpy seeds.  The JAX references are jitted once a
module (eager JAX dispatches, and compiles, op by op).

  * ``rglru_scan`` (a Hillis-Steele scan in the port, JAX's
    ``associative_scan`` there) and its gradient against ``jax.vjp``, at
    S 1, 37 and 256, 1e-5; ``rglru_block`` with its decode state, and
    ``rglru_decode``, 1e-5;
  * ``lm_forward`` at 3, 5 and 6 layers (one group; a group and a tail
    of two; two groups), 1e-4;
  * prefill and decode against JAX's windowed ``forward`` at S 20, 40 and
    70 (the SMOKE window is 32: 40 and 70 wrap the rolling buffer), and
    against JAX's own prefill and decode where its front-written buffer
    agrees (S 20 and 64: no longer than the buffer, or a multiple of it),
    1e-4; the engine's greedy streams equal the JAX engine's;
  * 3 reference-route ``Trainer`` steps, remat on and off, against JAX's
    jitted ``make_train_step`` looped without a mesh: losses within 2e-5,
    gradient norms within 2e-5 relative, parameters within 1e-4 where sqrt(v) >= 1e-4 at
    every step (an element whose gradient was rounding noise moves by up
    to lr a step: tests/test_torch_pipeline.py, PERF.md); remat bit for
    bit is tests/test_torch_train_archs.py's;
  * the plain flash forward and backward at head dim 256, MQA, with a
    window, against JAX's Pallas kernel (interpret mode) and ``jax.vjp``
    of JAX's ``_sdpa``;
  * a hybrid train state saved by either package read by the other bit
    for bit, and a reference-route resume;
  * the routes the hybrid stack does not take, each refused by name: a
    pp plan (JAX asserts a uniform stack), tp and the rank routes (A9g);
    a cp plan trains on the reference loss, as JAX's trainer does.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.data.pipeline import SyntheticTokens as JTokens  # noqa: E402
from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.models import griffin as jgriffin  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.parallel.sharding import ShardingRules as JRules  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve import scripted_trace as jax_trace  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.core.plan import ParallelPlan, StagePlacement  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import convert, griffin, transformer  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import pipeline as tpp  # noqa: E402
from repro_torch.serve import ServeEngine, scripted_trace  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

ARCH = "recurrentgemma-9b"
SCAN_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_TOL, PARAM_TOL = 2e-5, 1e-4
OPT = dict(lr=1e-2, warmup_steps=2)
GB, SEQ = 2, 64          # past the SMOKE window of 32
MAX_LEN = 96             # the buffer holds 32 positions
PROMPTS = (20, 40, 70)
JAX_AGREES = (20, 64)    # <= the buffer, or a multiple of it

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


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _models(layers=3):
    """(JAX bundle, JAX params, port bundle, port params) of SMOKE at
    ``layers`` layers, made once (JAX's init jitted)."""
    if layers not in _MODELS:
        jb = jreg.get_bundle(ARCH, smoke=True, num_layers=layers)
        jp = jax.jit(jb.init, static_argnums=1)(jax.random.PRNGKey(0),
                                                 jb.cfg)
        tp = convert.from_jax(_np(jp), device="cpu")
        _MODELS[layers] = (jb, jp, treg.get_bundle(ARCH, smoke=True,
                                                   num_layers=layers), tp)
    return _MODELS[layers]


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B, S),
                                                dtype=np.int32)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **tol)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: x for k, v in tree.items()
                for p, x in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, list):
        return {p: x for i, v in enumerate(tree)
                for p, x in _flat(v, f"{prefix}/[{i}]").items()}
    return {prefix: tree}


# ------------------------------------------------------------ the scan ---
@pytest.mark.parametrize("S", [1, 37, 256])
def test_rglru_scan_and_its_gradient_match_jax(S):
    rng = np.random.default_rng(S)
    x, ig, r, dh = (rng.standard_normal((2, S, 24)).astype(np.float32)
                    for _ in range(4))
    ig = 1 / (1 + np.exp(-ig))
    log_a = (-8.0 * np.log1p(np.exp(0.65)) / (1 + np.exp(-r))).astype(
        np.float32)
    jh, jgrads = jax.jit(lambda a, b, c, d: (
        lambda out: (out[0], out[1](d)))(jax.vjp(jgriffin.rglru_scan, a, b,
                                                 c)))(
        *map(jnp.asarray, (x, ig, log_a, dh)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, ig, log_a)]
    th = griffin.rglru_scan(*ts)
    _close(th, jh, SCAN_TOL)
    for g, w in zip(torch.autograd.grad(th, ts, torch.from_numpy(dh)),
                    jgrads):
        _close(g, w, SCAN_TOL)


def test_rglru_block_state_and_decode_match_jax():
    jb, jp, tb, tp = _models()
    cfg = jb.cfg
    jblk = jax.tree.map(lambda a: a[0], jp["groups"]["b0"]["rec"])
    tblk = transformer.layer(tp["groups"]["b0"]["rec"], 0)
    x = np.random.default_rng(1).standard_normal((2, 30, 64)).astype(
        np.float32)
    want = jax.jit(lambda p, x: jtransformer._rglru_prefill_state(
        p, x, cfg))(jblk, jnp.asarray(x))
    out, h, conv = griffin.rglru_block(tblk, torch.from_numpy(x), tb.cfg,
                                       return_state=True)
    _close(out, jax.jit(lambda p, x: jgriffin.rglru_block(p, x, cfg))(
        jblk, jnp.asarray(x)), SCAN_TOL)
    for t, w in zip((out, h, conv), want):
        _close(t, w, SCAN_TOL)
    # the decode recurrence from that state, 4 steps, in place
    step = jax.jit(lambda p, x, h, c: jgriffin.rglru_decode(p, x, h, c, cfg))
    jh, jc = want[1], want[2]
    h, conv = h.clone(), conv.clone()
    for i in range(4):
        xi = np.random.default_rng(10 + i).standard_normal((2, 1, 64)).astype(
            np.float32)
        jo, jh, jc = step(jblk, jnp.asarray(xi), jh, jc)
        to = griffin.rglru_decode(tblk, torch.from_numpy(xi), h, conv,
                                  tb.cfg)
        _close(to, jo, SCAN_TOL)
        _close(h, jh, SCAN_TOL)
        _close(conv, jc, SCAN_TOL)


# ---------------------------------------------------------- the stack ----
@pytest.mark.parametrize("layers", [3, 5, 6])
def test_lm_forward_matches_jax(layers):
    """One group; a group and a tail of two rec blocks; two groups."""
    jb, jp, tb, tp = _models(layers)
    assert len(tp["tail"]) == layers % 3
    toks = _tokens(2, 40)
    jl, _ = jax.jit(lambda p, t: jb.forward(p, {"tokens": t}, jb.cfg))(
        jp, jnp.asarray(toks))
    tl, aux = tb.forward(tp, {"tokens": torch.from_numpy(toks)}, tb.cfg)
    assert float(aux) == 0.0
    _close(tl, jl)


@pytest.fixture(scope="module")
def jax_decode():
    jb = _models(5)[0]
    prefill = jax.jit(lambda p, t: jb.prefill(p, {"tokens": t}, jb.cfg,
                                              MAX_LEN))
    step = jax.jit(lambda p, t, c: jb.decode_step(p, t, c, jb.cfg))
    forward = jax.jit(lambda p, t: jb.forward(p, {"tokens": t}, jb.cfg)[0])
    return prefill, step, forward


@pytest.mark.parametrize("S", sorted(set(PROMPTS + JAX_AGREES)))
def test_prefill_and_decode_match_jax(jax_decode, S):
    """5 layers: the prefill of S tokens and 4 decode steps against JAX's
    windowed forward of the same tokens, and against JAX's own prefill
    and decode where its buffer layout agrees with the port's."""
    prefill, step, forward = jax_decode
    jb, jp, tb, tp = _models(5)
    toks = _tokens(2, S + 4, seed=S)
    full = np.asarray(forward(jp, jnp.asarray(toks)))
    tl, tc = tb.prefill(tp, {"tokens": torch.from_numpy(toks[:, :S])},
                        tb.cfg, MAX_LEN)
    assert tc["kv"]["k"].shape[:3] == (1, 2, 32)
    assert tc["rec"]["h"].shape == (4, 2, 64)
    assert tc["rec"]["conv"].shape == (4, 2, 3, 64)
    _close(tl, full[:, S - 1])
    agrees = S in JAX_AGREES
    if agrees:
        jl, jc = prefill(jp, jnp.asarray(toks[:, :S]))
        _close(tl, jl)
        for key in ("h", "conv"):
            _close(tc["rec"][key], jc["rec"][key])
    for i in range(4):
        nxt = toks[:, S + i:S + i + 1]
        tl, tc = tb.decode_step(tp, torch.from_numpy(nxt), tc, tb.cfg)
        _close(tl, full[:, S + i])
        if agrees:
            jl, jc = step(jp, jnp.asarray(nxt), jc)
            _close(tl, jl)
            _close(tc["rec"]["h"], jc["rec"]["h"])
            _close(tc["kv"]["k"], jc["kv"]["k"])


def test_greedy_streams_equal_jax_engine():
    """The engine's per-slot rows of the rec state and the rolling KV
    buffer (max_len 40 past the window of 32), greedy, against JAX's."""
    jb, jp, tb, tp = _models(5)
    kw = dict(prompt_lens=(6, 12, 24), gen_lens=(4, 8, 16), arrival_every=1)
    want = JaxServeEngine(jb, jp, max_batch=3, max_len=40).run(
        jax_trace(6, vocab_size=256, seed=5, **kw))
    got = ServeEngine(tb, tp, max_batch=3, max_len=40, device="cpu").run(
        scripted_trace(6, vocab_size=256, seed=5, **kw))
    assert {c.rid: c.tokens for c in got.completions} == \
        {c.rid: c.tokens for c in want.completions}


# ------------------------------------------------------------ training ---
@pytest.fixture(scope="module")
def jax_steps():
    """JAX's Trainer._run without its mesh at 5 layers: the jitted train
    step over the synthetic batches from JAX's initial state; the state
    it starts from, each step's (loss, grad norm), each element's
    smallest sqrt(v) over the steps, and the final parameters."""
    jb, jp, _, _ = _models(5)
    rules = JRules(jb.cfg, tp=1, dp_axes=("data",))
    step = jax.jit(jsteps.make_train_step(jb, rules,
                                          jadamw.AdamWConfig(**OPT)))
    state = {"params": jp, "opt": jadamw.init_opt_state(jp, False),
             "step": jnp.zeros((), jnp.int32)}
    start = _np(state)
    data = JTokens(vocab_size=256, seq_len=SEQ, global_batch=GB)
    metrics, rms = [], None
    for i in range(3):
        state, m = step(state, data.batch_at(i))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        v = {k: np.sqrt(a) for k, a in _flat(_np(state["opt"]["v"])).items()}
        rms = v if rms is None else {k: np.minimum(rms[k], v[k]) for k in v}
    return start, metrics, rms, _flat(_np(state["params"]))


@pytest.mark.parametrize("remat", [True, False])
def test_trainer_steps_match_jax(jax_steps, remat):
    start, want, rms, jparams = jax_steps
    tb = treg.bundle_for(dataclasses.replace(_models(5)[2].cfg, remat=remat))
    t = Trainer(tb, TrainerConfig(global_batch=GB, seq_len=SEQ),
                opt_cfg=adamw.AdamWConfig(**OPT),
                state=convert.from_jax(start, device="cpu"), device="cpu")
    assert not t._pipeline_active() and not t._cp_active()
    out = t.run(3)
    np.testing.assert_allclose(out["losses"], [m[0] for m in want],
                               rtol=0, atol=LOSS_TOL)
    # the norms, ~6-9, relative: fp32 sums over ~1e5 squares
    np.testing.assert_allclose(out["grad_norms"], [m[1] for m in want],
                               rtol=LOSS_TOL, atol=0)
    got = _flat(t.state["params"])
    assert sorted(got) == sorted(jparams)
    for k, w in jparams.items():
        err = np.abs(got[k].numpy() - w)
        assert err.max() < 2 * 3 * OPT["lr"], k
        assert err[rms[k] >= PARAM_TOL].max(initial=0) < PARAM_TOL, k


# ------------------------------------------------- flash at head dim 256 --
@pytest.mark.parametrize("S,window", [(64, 24), (48, None)])
def test_plain_flash_at_head_dim_256_matches_jax(S, window):
    """recurrentgemma-9b's attention shape at a small S: head dim 256 over
    one KV head.  The forward against JAX's Pallas kernel (interpret
    mode) and its plain reference; the gradient (the one-rank hop
    backward's plain version) against ``jax.vjp`` of JAX's ``_sdpa``."""
    rng = np.random.default_rng(S)
    q = rng.standard_normal((1, S, 4, 256)).astype(np.float32)
    k, v = (rng.standard_normal((1, S, 1, 256)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((1, S, 4, 256)).astype(np.float32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = jfa.flash_attention(jq, jk, jv, causal=True, window=window,
                               block_q=16, block_k=16, interpret=True)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=True, window=window)
    _close(got, want)
    cfg = jreg.get_config(ARCH, smoke=True)
    pos = jnp.arange(S)
    mask = jlayers._scores_mask(pos, pos, window, True)
    _, vjp = jax.vjp(lambda a, b, c: jlayers._sdpa(a, b, c, mask, cfg),
                     jq, jk, jv)
    for g, w in zip(torch.autograd.grad(got, (tq, tk, tv),
                                        torch.from_numpy(do)),
                    vjp(jnp.asarray(do))):
        _close(g, w)
    lse = ref.flash_attention(tq.detach(), tk.detach(), tv.detach(),
                              window=window, return_lse=True)[1]
    assert lse.shape == (1, S, 4) and torch.isfinite(lse).all()
    assert math.isclose(float(got.detach().abs().max()),
                        float(np.abs(np.asarray(want)).max()), rel_tol=1e-4)


# --------------------------------------------------------- checkpoints ---
def test_hybrid_checkpoint_reads_across_packages(jax_steps, tmp_path):
    """JAX names a list element by its index in brackets
    (``params/tail/[0]/ln1/scale``) and writes no ``_stacked`` marker for
    a hybrid tree: the port writes the same files and reads JAX's bit for
    bit, JAX reads the port's, and a reference-route Trainer resumes from
    its own save."""
    jb = _models(5)[0]
    jbf = dataclasses.replace(jb, cfg=dataclasses.replace(
        jb.cfg, param_dtype="bfloat16"))
    jstate = jax.device_get(jax.jit(lambda k: jsteps.init_train_state(
        jbf, k))(jax.random.PRNGKey(1)))
    jd, td = tmp_path / "jax", tmp_path / "port"
    jckpt.save(str(jd), 1, jstate)
    want = convert.from_jax(jstate, device="cpu")
    assert isinstance(want["params"]["tail"], list)
    got, _ = ckpt.restore(str(jd), 1, want)
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w) and "/params/tail/[1]/rec/lam" in g
    for k in w:
        assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k
    ckpt.save(str(td), 1, want)
    jm = (jd / "step_00000001" / "manifest.json").read_text()
    assert (td / "step_00000001" / "manifest.json").read_text() == jm
    assert "params/tail/[0]/ln1/scale" in jm and "_stacked" not in jm
    back, _ = jckpt.restore(str(td), 1, jstate)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.tobytes() == b.tobytes()
    # the reference route saves at step 2 and a new trainer resumes there
    start = convert.from_jax(jax_steps[0], device="cpu")
    cfg = TrainerConfig(global_batch=GB, seq_len=SEQ, ckpt_every=2,
                        ckpt_dir=str(tmp_path / "run"))
    tb = _models(5)[2]
    t = Trainer(tb, cfg, opt_cfg=adamw.AdamWConfig(**OPT), state=start,
                device="cpu")
    losses = t.run(3)["losses"]
    t.ckpt.wait()
    r = Trainer(tb, cfg, opt_cfg=adamw.AdamWConfig(**OPT), device="cpu")
    assert r.step == 2
    assert r.run(1)["losses"] == losses[2:]


def test_serve_and_train_clis_run_the_arch(capsys, tmp_path):
    """``--arch recurrentgemma-9b`` through both CLIs, with no new flag."""
    import json

    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["arch"] == "recurrentgemma-9b-smoke"
    assert out["tokens"]["generated"] > 0
    train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--seq",
                    "64", "--steps", "2", "--ckpt-dir", str(tmp_path)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps"] == 2 and np.isfinite(out["final_loss"])


# ----------------------------------------------------- what is refused ---
def test_hybrid_routes_refused_by_name():
    """pp: JAX asserts a uniform scanned stack, and the trainer raises
    before anything moves; tp and the rank routes (tp, dp, ZeRO-1) wait
    for A9g; a cp plan keeps the reference loss, as JAX's ``_cp_active``
    does."""
    _, _, tb, _ = _models(6)
    cfg = TrainerConfig(global_batch=4, seq_len=32)
    pp2 = ParallelPlan(stages=(StagePlacement(0, 3, 1, 1),
                               StagePlacement(1, 3, 1, 1, True)),
                       micro_bs=1, global_batch=4, seq_len=32)
    with pytest.raises(ValueError, match="uniform scanned stack"):
        Trainer(tb, cfg, plan=pp2, device="cpu")
    with pytest.raises(NotImplementedError, match="item A9g"):
        transformer.check_tp_supported(tb.cfg)
    dp2 = ParallelPlan(stages=(StagePlacement(0, 6, 2, 1, True),),
                       micro_bs=2, global_batch=4, seq_len=32)
    for plan in (dp2, dataclasses.replace(
            dp2, stages=(StagePlacement(0, 6, 1, 2, True),))):
        with pytest.raises(NotImplementedError, match="item A9g"):
            tpp.check_rank_plan(tb.cfg, plan)
    cp2 = ParallelPlan(stages=(StagePlacement(0, 6, 2, 1, True),),
                       micro_bs=4, global_batch=4, seq_len=32, cp=2,
                       cp_chunks=(20, 12))
    t = Trainer(tb, cfg, plan=cp2, device="cpu")
    assert not t._cp_active() and not t._pipeline_active()
    assert np.isfinite(t.run(1)["losses"]).all()
