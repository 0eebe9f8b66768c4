"""whisper-tiny (the enc-dec stack: an encoder, and a decoder with
cross-attention over its output) through the port against the JAX
package, fp32 SMOKE (2 + 2 layers, d 64) on the CPU, JAX's parameters
carried over by ``from_jax`` and the inputs made from numpy seeds.  The
JAX references are jitted once a module.

  * ``encode``, ``encdec_forward``, ``encdec_prefill``'s logits and every
    cache leaf, and 4 ``encdec_decode_step``s (``pos`` a scalar, as JAX's,
    and per row), 1e-4;
  * the reference loss and its gradients, remat on and off: loss 2e-5,
    gradients 1e-4; two ``Trainer`` steps against JAX's jitted
    ``make_train_step``: losses 2e-5, parameters 1e-4 where sqrt(v) >=
    1e-4 after every step (tests/test_torch_pipeline.py);
  * ``from_jax`` carries JAX's tree across unchanged, and the port's
    ``init_encdec`` makes the same tree;
  * the plain cross-attention (the flash forward without causality at Sq
    < Sk, Sq > Sk and Sq 1) and its gradient (the one-rank hop backward
    at the hop ``(Sk - Sq, 0, 0, Sk, Sq)``, whose offset is negative when
    Sq > Sk) against JAX's ``_sdpa`` under an all-true mask and its
    ``jax.vjp``, 1e-4;
  * ``launch/train.py --arch whisper-tiny`` trains on the plain route.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.data.pipeline import SyntheticTokens as JTokens  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.parallel.sharding import ShardingRules as JRules  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import convert, encdec  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

ARCH = "whisper-tiny"
TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_TOL, PARAM_TOL = 2e-5, 1e-4
OPT = dict(lr=1e-2, warmup_steps=2)
B, S_ENC, S_DEC, MAX_LEN = 2, 40, 12, 24
GB, SEQ = 2, 32


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


@pytest.fixture(scope="module")
def smoke():
    """(JAX bundle, JAX params, port bundle, port params, frames, tokens):
    the tokens hold S_DEC + 4, the prompt and 4 decode steps."""
    jb = jreg.get_bundle(ARCH, smoke=True)
    jp = jax.jit(jb.init, static_argnums=1)(jax.random.PRNGKey(0), jb.cfg)
    tp = convert.from_jax(_np(jp), device="cpu")
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((B, S_ENC, 64)).astype(np.float32)
    toks = rng.integers(0, 256, (B, S_DEC + 4), dtype=np.int32)
    return jb, jp, treg.get_bundle(ARCH, smoke=True), tp, frames, toks


def test_from_jax_carries_the_tree_and_init_makes_it(smoke):
    jb, jp, tb, tp, _, _ = smoke
    want = _flat(_np(jp))
    got = _flat(tp)
    assert sorted(got) == sorted(want)
    assert {"/dec_blocks/xattn/wq", "/dec_blocks/ln_x/scale",
            "/enc_blocks/mlp/w_up", "/enc_norm/scale"} <= set(got)
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == torch.float32
        assert np.array_equal(got[k].numpy(), w), k
    own = _flat(tb.init(tb.cfg, seed=0, device="cpu"))
    assert {k: (t.shape, t.dtype) for k, t in own.items()} == \
        {k: (t.shape, t.dtype) for k, t in got.items()}
    again = _flat(tb.init(tb.cfg, seed=0, device="cpu"))
    assert all(torch.equal(own[k], again[k]) for k in own)


def test_encode_and_forward_match_jax(smoke):
    jb, jp, tb, tp, frames, toks = smoke
    cfg = jb.cfg
    jf, jt = jnp.asarray(frames), jnp.asarray(toks[:, :S_DEC])
    _close(encdec.encode(tp, torch.from_numpy(frames), tb.cfg),
           jax.jit(lambda p, f: jencdec.encode(p, f, cfg))(jp, jf))
    jl, _ = jax.jit(lambda p, f, t: jb.forward(
        p, {"frames": f, "tokens": t}, cfg))(jp, jf, jt)
    tl, aux = tb.forward(tp, {"frames": torch.from_numpy(frames),
                              "tokens": torch.from_numpy(toks[:, :S_DEC])},
                         tb.cfg)
    assert tl.dtype == torch.float32 and float(aux) == 0.0
    _close(tl, jl)


@pytest.mark.parametrize("per_row", [False, True])
def test_prefill_cache_and_decode_match_jax(smoke, per_row):
    """The prefill's last logits and every cache leaf, then 4 decode steps
    (``pos`` a scalar, as JAX's, or (B,) as the engine keeps it)."""
    jb, jp, tb, tp, frames, toks = smoke
    cfg = jb.cfg
    prefill = jax.jit(lambda p, f, t: jb.prefill(
        p, {"frames": f, "tokens": t}, cfg, MAX_LEN))
    step = jax.jit(lambda p, t, c: jb.decode_step(p, t, c, cfg))
    jl, jc = prefill(jp, jnp.asarray(frames), jnp.asarray(toks[:, :S_DEC]))
    tl, tc = tb.prefill(tp, {"frames": torch.from_numpy(frames),
                             "tokens": torch.from_numpy(toks[:, :S_DEC])},
                        tb.cfg, MAX_LEN)
    treg.check_last_logits(tl, B, 256)
    _close(tl, jl)
    assert tc["kv"]["k"].shape == (2, B, MAX_LEN, 4, 16)
    assert tc["xkv"]["k"].shape == (2, B, S_ENC, 4, 16)
    assert int(tc["pos"]) == int(jc["pos"]) == S_DEC
    for part in ("kv", "xkv"):
        for kv in ("k", "v"):
            _close(tc[part][kv], jc[part][kv])
    if per_row:
        tc["pos"] = tc["pos"].expand(B).clone()
    for i in range(4):
        nxt = toks[:, S_DEC + i:S_DEC + i + 1]
        jl, jc = step(jp, jnp.asarray(nxt), jc)
        tl, tc = tb.decode_step(tp, torch.from_numpy(nxt), tc, tb.cfg)
        _close(tl, jl)
        _close(tc["kv"]["k"], jc["kv"]["k"])
        _close(tc["kv"]["v"], jc["kv"]["v"])
    assert tc["pos"].tolist() == ([S_DEC + 4] * B if per_row
                                  else S_DEC + 4)


# ------------------------------------------------------------ training ---
@pytest.fixture(scope="module")
def jax_loss(smoke):
    jb, jp, _, _, _, _ = smoke
    batch = jreg.make_batch(jb.cfg, batch=B, seq=SEQ)
    rules = JRules(jb.cfg, tp=1, dp_axes=("data",))
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        jsteps.make_loss_fn(jb, rules), has_aux=True))(jp, batch)
    return _np(batch), float(loss), float(metrics["ce"]), _flat(_np(grads))


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_gradients_match_jax(smoke, jax_loss, remat):
    _, _, tb, tp, _, _ = smoke
    batch, jl, jce, jgrads = jax_loss
    tb = treg.bundle_for(dataclasses.replace(tb.cfg, remat=remat))
    params = adamw.tree_map(lambda t: t.clone().requires_grad_(), tp)
    loss, metrics = tsteps.make_loss_fn(tb)(
        params, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    assert abs(float(loss.detach()) - jl) < LOSS_TOL
    assert abs(float(metrics["ce"].detach()) - jce) < LOSS_TOL
    leaves = adamw.tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    got = _flat(adamw.tree_map(lambda _: next(it), params))
    assert sorted(got) == sorted(jgrads)
    for k, w in jgrads.items():
        _close(got[k], w)


@pytest.fixture(scope="module")
def jax_steps(smoke):
    """JAX's jitted train step over the synthetic enc-dec batches: the
    state it starts from, each step's loss, the parameters after each
    step, and each element's sqrt(v) after it."""
    jb, jp, _, _, _, _ = smoke
    rules = JRules(jb.cfg, tp=1, dp_axes=("data",))
    step = jax.jit(jsteps.make_train_step(jb, rules,
                                          jadamw.AdamWConfig(**OPT)))
    state = {"params": jp, "opt": jadamw.init_opt_state(jp, False),
             "step": jnp.zeros((), jnp.int32)}
    start = _np(state)
    data = JTokens(vocab_size=256, seq_len=SEQ, global_batch=GB,
                   family="encdec", d_model=64)
    out = []
    for i in range(2):
        state, m = step(state, data.batch_at(i))
        out.append((float(m["loss"]), _flat(_np(state["params"])),
                    {k: np.sqrt(a) for k, a in
                     _flat(_np(state["opt"]["v"])).items()}))
    return start, out


def test_trainer_steps_match_jax(jax_steps):
    """Two AdamW steps of the reference route (``Trainer``, whose batch
    casts ``frames`` to the activation dtype) from JAX's state."""
    start, want = jax_steps
    t = Trainer(treg.get_bundle(ARCH, smoke=True),
                TrainerConfig(global_batch=GB, seq_len=SEQ),
                opt_cfg=adamw.AdamWConfig(**OPT),
                state=convert.from_jax(start, device="cpu"), device="cpu")
    assert not t._pipeline_active() and not t._cp_active()
    for i, (jl, jparams, rms) in enumerate(want):
        loss = t.run(1)["losses"][0]
        assert abs(loss - jl) < LOSS_TOL, i
        got = _flat(t.state["params"])
        assert sorted(got) == sorted(jparams)
        for k, w in jparams.items():
            err = np.abs(got[k].numpy() - w)
            assert err.max() < 2 * (i + 1) * OPT["lr"], k
            assert err[rms[k] >= PARAM_TOL].max(initial=0) < PARAM_TOL, k


# --------------------------------------------------- cross-attention ----
@pytest.mark.parametrize("sq,sk", [(24, 56), (56, 24), (1, 56)])
def test_plain_cross_attention_and_its_gradient_match_jax(sq, sk):
    """The flash forward without causality at Sq != Sk (its plain version
    on the CPU) and its gradient, the one-rank hop backward at the offset
    Sk - Sq, against JAX's ``_sdpa`` under an all-true mask."""
    rng = np.random.default_rng(sq * 100 + sk)
    q, do = (rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((2, sk, 2, 16)).astype(np.float32)
            for _ in range(2))
    cfg = jreg.get_config(ARCH, smoke=True)
    mask = jnp.ones((sq, sk), bool)
    jo, vjp = jax.vjp(lambda a, b, c: jlayers._sdpa(a, b, c, mask, cfg),
                      *map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = ops.flash_attention(*ts, causal=False)
    _close(got, jo)
    for g, w in zip(torch.autograd.grad(got, ts, torch.from_numpy(do)),
                    vjp(jnp.asarray(do))):
        _close(g, w)


def test_train_cli_runs_the_arch(capsys, tmp_path):
    """``--arch whisper-tiny`` through the train CLI, on the plain
    route."""
    import json

    from repro_torch.launch import train as train_cli
    train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--seq",
                    "32", "--steps", "2", "--ckpt-dir", str(tmp_path)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps"] == 2 and np.isfinite(out["final_loss"])
