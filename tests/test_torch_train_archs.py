"""Training the rest of the dense family on the port, against the JAX
package, fp32 on the CPU (SMOKE widths).

  * one reference-route train step of qwen3-14b, nemotron-4-15b and
    h2o-danube-3-4b (at S 64, past its SMOKE window of 32) against JAX's
    jitted ``make_train_step`` without a mesh: loss, every gradient and
    the gradient norm within 2e-5;
  * ``ops.flash_attention``'s backward with a window, a softcap and both
    (the plain ``ring_step_bwd`` on the CPU) against ``jax.vjp`` of JAX's
    ``_sdpa`` under ``_scores_mask``, within 2e-5;
  * ``cfg.remat`` on the reference and the cp loss: the same loss and
    gradients as without it, bit for bit, and the cp loss under remat
    against JAX's cp loss (2e-5, gradients 2e-4 as
    ``tests/test_torch_train.py``);
  * the tp route on one gloo run of 2 ranks: nemotron (``sq_relu``),
    llama at ``gelu`` and ``geglu``, qwen3 (qk_norm on split heads) and
    danube (window) against JAX's loss and gathered gradients, within
    2e-5;
  * the train CLI's ``--log-every``, at JAX's cadence.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.data.pipeline import SyntheticTokens as JTokens  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.parallel import context as jcontext  # noqa: E402
from repro.parallel.sharding import ShardingRules as JRules  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import context, rank_programs  # noqa: E402
from repro_torch.parallel import pipeline as tpp  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.parallel.launch import run_ranks  # noqa: E402
from repro_torch.train import steps  # noqa: E402

TOL = 2e-5
OPT = dict(lr=1e-2, warmup_steps=2)
GB = 2
SEQ = {"h2o-danube-3-4b": 64}      # past the SMOKE window of 32
NEW_ARCHS = ("qwen3-14b", "nemotron-4-15b", "h2o-danube-3-4b")


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


def _bundles(arch, **kw):
    jb = jreg.bundle_for(dataclasses.replace(
        jreg.get_config(arch, smoke=True), **kw))
    tb = treg.bundle_for(dataclasses.replace(
        treg.get_config(arch, smoke=True), **kw))
    return jb, tb


def _loss_and_grads(loss_fn, params, batch):
    leaves = adamw.tree_leaves(params)
    for t in leaves:
        t.requires_grad_()
    loss, _ = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    it = iter(grads)
    return loss.detach(), adamw.tree_map(lambda _: next(it), params)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


# ------------------------------------------- one train step against JAX ----
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_reference_train_step_matches_jax(arch):
    """JAX's ``Trainer._run`` without its mesh, one step: the jitted
    ``make_train_step`` from JAX's initial state on JAX's first synthetic
    batch, against the port's train step on the same state and batch;
    the loss's gradients against ``jax.value_and_grad`` of JAX's loss."""
    jb, tb = _bundles(arch)
    seq = SEQ.get(arch, 32)
    rules = JRules(jb.cfg, tp=1, dp_axes=("data",))
    jstate = jsteps.init_train_state(jb, jax.random.PRNGKey(0))
    start = _np(jstate)
    batch = JTokens(vocab_size=jb.cfg.vocab_size, seq_len=seq,
                    global_batch=GB).batch_at(0)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        jsteps.make_loss_fn(jb, rules), has_aux=True))(jstate["params"],
                                                       batch)
    _, jm = jax.jit(jsteps.make_train_step(
        jb, rules, jadamw.AdamWConfig(**OPT)))(jstate, batch)
    tstate = convert.from_jax(start, device="cpu")
    tbatch = _torch_batch(batch)
    tl, tg = _loss_and_grads(steps.make_loss_fn(tb), tstate["params"],
                             tbatch)
    _, tm = steps.make_train_step(tb, adamw.AdamWConfig(**OPT))(tstate,
                                                                tbatch)
    assert abs(float(tl) - float(jl)) < TOL
    assert abs(float(tm["loss"]) - float(jm["loss"])) < TOL
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) < TOL
    assert _max_err(tg, jg) < TOL


# ------------------------------------ the flash backward against JAX ----
@pytest.mark.parametrize("window,softcap,hd", [
    (8, None, 16), (None, 5.0, 16), (8, 5.0, 16), (8, 5.0, 120)],
    ids=["window", "softcap", "both", "both-hd120"])
def test_flash_backward_matches_jax_sdpa_vjp(window, softcap, hd):
    """The port's flash backward (the plain one-rank hop backward on the
    CPU, P recomputed from the forward's logsumexp) against ``jax.vjp`` of
    ``_sdpa`` under ``_scores_mask``: JAX differentiates its masked,
    capped softmax directly."""
    rng = np.random.default_rng(7)
    B, S, H, Hk = 2, 24, 4, 2
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((B, S, H, hd), (B, S, Hk, hd), (B, S, Hk, hd),
                             (B, S, H, hd)))
    pos = jnp.arange(S)
    mask = jlayers._scores_mask(pos, pos, window, True)
    cfg = types.SimpleNamespace(attn_logit_softcap=softcap)
    want_o, vjp = jax.vjp(lambda a, b, c: jlayers._sdpa(a, b, c, mask, cfg),
                          jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = ops.flash_attention(tq, tk, tv, causal=True, window=window,
                            softcap=softcap)
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(want_o),
                               rtol=TOL, atol=TOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


# ----------------------------------------------------------- remat ----
def _remat_pair(tb, loss_of, params, batch):
    """(loss, grads) of ``loss_of(bundle)`` with ``cfg.remat`` on, then
    off."""
    out = []
    for remat in (True, False):
        b = treg.bundle_for(dataclasses.replace(tb.cfg, remat=remat))
        out.append(_loss_and_grads(loss_of(b), params, batch))
    return out


def _bit_for_bit(a, b):
    (la, ga), (lb, gb) = a, b
    assert torch.equal(la, lb)
    fa, fb = _flat(ga), _flat(gb)
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k


@pytest.mark.parametrize("arch", ["llama3-8b", "h2o-danube-3-4b"])
def test_reference_loss_under_remat_is_bit_for_bit(arch):
    """Each block under ``torch.utils.checkpoint`` recomputes the same
    forward: the loss and every gradient equal the kept forward's."""
    jb, tb = _bundles(arch)
    params = convert.from_jax(_np(jb.init(jax.random.PRNGKey(1), jb.cfg)),
                              device="cpu")
    batch = _torch_batch(jreg.make_batch(jb.cfg, batch=GB,
                                         seq=SEQ.get(arch, 32)))
    _bit_for_bit(*_remat_pair(tb, steps.make_loss_fn, params, batch))


def test_cp_loss_under_remat_matches_jax():
    """The cp ring loss with each block under ``torch.utils.checkpoint``
    (JAX's cp loss wraps its block in ``jax.checkpoint``): bit for bit
    the loss without it, and JAX's loss and gradients."""
    chunks = (20, 12)
    jb, tb = _bundles("llama3-8b")
    assert jb.cfg.remat and tb.cfg.remat
    jparams = jb.init(jax.random.PRNGKey(2), jb.cfg)
    params = convert.from_jax(_np(jparams), device="cpu")
    batch = jreg.make_batch(jb.cfg, batch=GB, seq=sum(chunks))
    on, off = _remat_pair(tb, lambda b: context.make_cp_loss_fn(b.cfg,
                                                                chunks),
                          params, _torch_batch(batch))
    _bit_for_bit(on, off)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        jcontext.make_cp_loss_fn(jb.cfg, None, chunks), has_aux=True))(
            jparams, batch)
    assert abs(float(on[0]) - float(jl)) < TOL
    assert _max_err(on[1], jg) < 2e-4


# ---------------------------------------------- tp over the dense family ----
TP_CASES = [("nemotron-4-15b", {}), ("llama3-8b", {"act": "gelu"}),
            ("llama3-8b", {"act": "geglu"}), ("qwen3-14b", {}),
            ("h2o-danube-3-4b", {})]
TP_IDS = [a + "".join(f"-{v}" for v in kw.values()) for a, kw in TP_CASES]


@pytest.fixture(scope="module")
def tp_results():
    """Each case's 2 tp ranks' losses and gradients (one gloo run of 2
    ranks for all of them), and JAX's loss and gradients."""
    cases, jax_out = [], []
    for arch, kw in TP_CASES:
        jb, _ = _bundles(arch, **kw)
        jparams = jb.init(jax.random.PRNGKey(0), jb.cfg)
        batch = {k: np.asarray(v) for k, v in jreg.make_batch(
            jb.cfg, batch=GB, seq=SEQ.get(arch, 32)).items()}
        params = adamw.tree_map(lambda t: t.numpy(),
                                convert.from_jax(_np(jparams), device="cpu"))
        cases.append(dict(bundle_kw=dict(arch=arch, smoke=True, **kw),
                          params=params, batch=batch, layers=[
                              jb.cfg.num_layers], tp=2, transport="gpu",
                          slack=0, schedule="1f1b"))
        (jl, _), jg = jax.jit(jax.value_and_grad(
            jsteps.make_loss_fn(jb, JRules(jb.cfg, tp=1)), has_aux=True))(
                jparams, batch)
        jax_out.append((float(jl), convert.from_jax(_np(jg), device="cpu")))
    res = run_ranks(rank_programs.tp_loss_and_grads, 2, timeout_s=120,
                    device="cpu", args=(cases,))
    return [[r[i] for r in res] for i in range(len(cases))], jax_out


@pytest.mark.parametrize("i", range(len(TP_CASES)), ids=TP_IDS)
def test_tp_route_matches_jax(tp_results, i):
    """pp 1 x tp 2: the MLP's columns of ``w_up`` (and ``w_gate``) and
    rows of ``w_down`` a rank, qk_norm on each rank's heads, the window
    on each rank's heads: every rank's loss is JAX's, and the gathered
    gradients are JAX's."""
    arch, kw = TP_CASES[i]
    res, (jl, jg) = tp_results[0][i], tp_results[1][i]
    for r in res:
        assert abs(r["loss"] - jl) < TOL, (r["loss"], jl)
    rules = sharding.ShardingRules(
        treg.get_config(arch, smoke=True, **kw), tp=2)
    got = tpp.gather_stage_trees([sharding.gather_trees(
        [adamw.tree_map(torch.from_numpy, r["grads"]) for r in res],
        rules)])
    assert _max_err(got, jg) < TOL


# ------------------------------------------------------------- the CLI ----
@pytest.mark.parametrize("every,logged", [(1, [1, 2, 3]), (2, [2, 3])])
def test_train_cli_logs_every_n_steps(capsys, tmp_path, every, logged):
    """``--log-every``: a step line a chunk of ``min(every, steps left)``
    steps, as the JAX CLI prints them."""
    train_cli.main(["--smoke", "--device", "cpu", "--steps", "3",
                    "--global-batch", "2", "--seq", "16",
                    "--log-every", str(every),
                    "--ckpt-dir", str(tmp_path)])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[train] step=")]
    assert [int(ln.split()[1].split("=")[1]) for ln in lines] == logged
    with pytest.raises(SystemExit):
        train_cli.main(["--smoke", "--device", "cpu", "--log-every", "0"])
