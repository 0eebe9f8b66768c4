"""llama3-8b SMOKE through the port against the JAX package, fp32 on the
CPU, with the JAX parameters converted by ``from_jax``.

Tolerance: atol = rtol = 1e-4.  Both sides run fp32, but XLA and torch sum
the matmuls in other orders and compute RoPE's pow/cos/sin with other
libm code; over two layers and the 64-wide unembed that leaves a few
1e-6 on logits of magnitude ~4 (2.4e-6 measured for lm_forward), so 1e-4
holds with margin while a wrong mask, position or layout misses it.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import registry as jreg  # noqa: E402
from repro_torch.models import convert, transformer  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
MAX_LEN = 24


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's in-process port code (SMOKE
    sizes gain nothing from more), so that test workers running side by
    side do not oversubscribe the host's cores; restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def models():
    jb = jreg.get_bundle("llama3-8b", smoke=True)
    jp = jb.init(jax.random.PRNGKey(0), jb.cfg)
    tp = convert.from_jax(jax.tree_util.tree_map(np.asarray, jp),
                          device="cpu")
    tb = treg.get_bundle("llama3-8b", smoke=True)
    return jb, jp, tb, tp


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B, S),
                                                dtype=np.int32)


def _close(t, j):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **TOL)


def test_config_copied_field_for_field(models):
    jb, _, tb, _ = models
    for f in ("num_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab_size", "rope_theta", "act", "norm_eps", "hd"):
        assert getattr(tb.cfg, f) == getattr(jb.cfg, f), f
    full_j, full_t = jreg.get_config("llama3-8b"), treg.get_config(
        "llama3-8b")
    assert full_t.param_count() == full_j.param_count()
    assert full_t.flops_per_token(1000) == full_j.flops_per_token(1000)
    assert full_t.pdtype == torch.bfloat16 and full_t.adtype == torch.bfloat16


def test_init_lm_has_the_jax_tree_layout(models):
    """init_lm builds the same tree of shapes as JAX's init (minus the
    ``_stacked`` marker), so from_jax is the identity on layouts."""
    _, _, tb, tp = models
    mine = tb.init(tb.cfg, seed=0, device="cpu")

    def shapes(node):
        if isinstance(node, dict):
            return {k: shapes(v) for k, v in node.items()}
        return (tuple(node.shape), node.dtype)

    assert shapes(mine) == shapes(tp)


def test_from_jax_bf16_is_bit_exact():
    a = np.random.default_rng(1).standard_normal((3, 5)).astype(np.float32)
    leaf = np.asarray(jnp.asarray(a).astype(jnp.bfloat16))
    got = convert.from_jax({"w": leaf, "_stacked": np.zeros(())},
                           device="cpu")
    assert set(got) == {"w"}
    assert torch.equal(got["w"], torch.from_numpy(a).to(torch.bfloat16))


def test_lm_forward_matches_jax(models):
    jb, jp, tb, tp = models
    tok = _tokens(2, 12)
    jl, _ = jb.forward(jp, {"tokens": jnp.asarray(tok)}, jb.cfg)
    tl, aux = tb.forward(tp, {"tokens": torch.from_numpy(tok)}, tb.cfg)
    assert tl.dtype == torch.float32 and tl.shape == (2, 12, 256)
    assert float(aux) == 0.0
    _close(tl, jl)


def test_lm_prefill_and_cache_match_jax(models):
    jb, jp, tb, tp = models
    tok = _tokens(2, 11, seed=1)
    jl, jc = jb.prefill(jp, {"tokens": jnp.asarray(tok)}, jb.cfg, MAX_LEN)
    tl, tc = tb.prefill(tp, {"tokens": torch.from_numpy(tok)}, tb.cfg,
                        MAX_LEN)
    _close(tl, jl)
    _close(tc["kv"]["k"], jc["kv"]["k"])
    _close(tc["kv"]["v"], jc["kv"]["v"])
    assert int(tc["pos"]) == int(jc["pos"]) == 11


@pytest.mark.parametrize("per_row", [True, False])
def test_lm_decode_steps_match_jax(models, per_row):
    """4 decode steps after a prefill.  per_row: the serving engine's (B,)
    positions, here unequal ([S, S-3]: row 1 rewrites slot S-3); else the
    scalar position of the whole batch."""
    jb, jp, tb, tp = models
    S = 9
    tok = _tokens(2, S, seed=2)
    _, jc = jb.prefill(jp, {"tokens": jnp.asarray(tok)}, jb.cfg, MAX_LEN)
    _, tc = tb.prefill(tp, {"tokens": torch.from_numpy(tok)}, tb.cfg,
                       MAX_LEN)
    if per_row:
        jc["pos"] = jnp.asarray([S, S - 3], jnp.int32)
        tc["pos"] = torch.tensor([S, S - 3])
    step_toks = _tokens(4, 2, seed=3)
    for t in range(4):
        nxt = step_toks[t][:, None]
        jl, jc = jb.decode_step(jp, jnp.asarray(nxt), jc, jb.cfg)
        tl, tc = tb.decode_step(tp, torch.from_numpy(nxt), tc, tb.cfg)
        assert tl.shape == (2, 256)
        _close(tl, jl)
    _close(tc["kv"]["k"], jc["kv"]["k"])
    _close(tc["kv"]["v"], jc["kv"]["v"])
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_unported_options_raise():
    """What the port still refuses, each by its reason.  The enc-dec stack
    (A9e) trains on one process's reference route only: a pp plan (JAX's
    pp loss reads ``params["blocks"]``), a cp plan (JAX's cp loss takes
    tokens only), tp and the rank routes (A9h) raise before anything
    runs, and the decoder-only stack does not admit it.  The VLM (A9f)
    has no cp route.  The serving engine refuses both families with
    JAX's reason (``tests/test_serve.py:180-187``).  A config whose family
    and experts disagree raises.  Every arch id of the registry loads:
    the dense family's window, qk_norm and activations
    (tests/test_torch_archs.py), the MoE family (tests/test_torch_moe.py),
    the hybrid stack (tests/test_torch_griffin.py), the enc-dec stack
    (tests/test_torch_encdec.py) and the VLM (tests/test_torch_vlm.py)."""
    from repro_torch.core.plan import ParallelPlan, StagePlacement
    from repro_torch.parallel import context
    from repro_torch.parallel import pipeline as tpp
    from repro_torch.serve import ServeEngine
    from repro_torch.train import steps as tsteps
    from repro_torch.train.trainer import Trainer, TrainerConfig
    wb = treg.get_bundle("whisper-tiny", smoke=True)
    vb = treg.get_bundle("phi-3-vision-4.2b", smoke=True)
    ed = wb.cfg
    with pytest.raises(ValueError, match="runs models/encdec.py"):
        transformer.init_cache(
            treg.get_config("llama3-8b", smoke=True, family="encdec"), 1, 16,
            "cpu")
    with pytest.raises(ValueError, match="moe family, and only it"):
        transformer.init_lm(
            treg.get_config("llama3-8b", smoke=True, family="moe"),
            device="cpu")
    cfg = TrainerConfig(global_batch=4, seq_len=32)
    pp2 = ParallelPlan(stages=(StagePlacement(0, 1, 1, 1),
                               StagePlacement(1, 1, 1, 1, True)),
                       micro_bs=1, global_batch=4, seq_len=32)
    with pytest.raises(ValueError, match=r"params\['blocks'\]"):
        tpp.make_pp_loss_fn(ed, 2, 4)
    with pytest.raises(ValueError, match=r"params\['blocks'\]"):
        Trainer(wb, cfg, plan=pp2, device="cpu")
    cp2 = ParallelPlan(stages=(StagePlacement(0, 2, 2, 1, True),),
                       micro_bs=4, global_batch=4, seq_len=32, cp=2,
                       cp_chunks=(20, 12))
    with pytest.raises(NotImplementedError, match="also reads frames"):
        context.make_cp_loss_fn(ed, (20, 12))
    with pytest.raises(NotImplementedError, match="also reads frames"):
        Trainer(wb, cfg, plan=cp2, device="cpu")
    with pytest.raises(NotImplementedError, match="item A9h"):
        transformer.check_tp_supported(ed)
    with pytest.raises(NotImplementedError, match="item A9h"):
        tsteps.make_loss_fn(wb, model=object())
    dp2 = ParallelPlan(stages=(StagePlacement(0, 2, 2, 1, True),),
                       micro_bs=2, global_batch=4, seq_len=32)
    for plan in (dp2, pp2, dataclasses.replace(
            dp2, stages=(StagePlacement(0, 2, 1, 2, True),))):
        with pytest.raises(NotImplementedError, match="item A9h"):
            tpp.check_rank_plan(ed, plan)
    with pytest.raises(NotImplementedError, match="also reads image_embeds"):
        context.check_cp_supported(vb.cfg)
    # a replan to such a plan raises before anything moves: the trainer
    # keeps its plan and its state
    for b, plan, err, msg in ((wb, pp2, ValueError, r"params\['blocks'\]"),
                              (wb, cp2, NotImplementedError, "reads frames"),
                              (vb, cp2, NotImplementedError,
                               "reads image_embeds")):
        t = Trainer(b, cfg, device="cpu")
        state = t.state
        with pytest.raises(err, match=msg):
            t._adopt(types.SimpleNamespace(plan=plan), None)
        assert t.plan is None and t.replans == 0 and t.state is state
    for b in (wb, vb):
        with pytest.raises(ValueError, match="enc-dec needs a cross-"):
            ServeEngine(b, None, max_batch=2, max_len=16, device="cpu")
    for arch in treg.ARCH_IDS:
        assert treg.get_bundle(arch, smoke=True).cfg.family in (
            "dense", "moe", "ssm", "hybrid", "encdec", "vlm")
    assert not hasattr(treg, "UNPORTED")
    assert not hasattr(transformer, "UNPORTED")
