"""The port's tensor parallelism within a stage against the JAX package, on
gloo CPU ranks.

Every rank runs in a process of its own through
``repro_torch.parallel.launch.run_ranks`` (each run under a timeout of
60 s or less), running a program of ``repro_torch.parallel.rank_programs``;
the JAX references are unsharded, computed in this process
(``steps.make_loss_fn``, ``make_pp_loss_fn(cfg, None, ...)``), on JAX's
SMOKE llama3-8b at 4 layers, fp32 (4 q heads, 2 kv heads, d_ff 128,
vocab 256):

  * (a) the port's rule table (``parallel/sharding.ShardingRules``)
    against JAX's ``ShardingRules(cfg, tp=t).param_specs`` on every leaf
    of every config of JAX's registry at t in {1, 2, 4, 8, 16};
  * (a') the port's ZeRO-1 rule (``ShardingRules.zero_dim``) against
    JAX's ``opt_state_spec`` over ``param_specs`` on the same leaves at
    tp in {1, 2} and data widths 1-16;
  * (b) ``shard_tree``/``gather_trees`` and a rank's own initialisation
    reproduce the whole state bit for bit;
  * (c) the loss and the gathered gradients of pp 1 at tp 2 (kv heads
    split), tp 4 (kv replicated: the ranks' partial k/v gradients summed
    over ``model``) and tp 2 with ``loss_chunk``, and of pp 2 x tp 2 under
    1f1b and gpipe, against JAX's within 2e-5; the replicated leaves'
    gradients are the same on every model rank; the all-reduces a pp 1
    call makes;
  * (d) three ``Trainer`` steps on pp 2 x dp 2 x tp 2 (8 ranks) against
    JAX's train step at global batch 4, parameters screened by sqrt(v)
    after every step, and the global gradient norm against JAX's;
  * (e) the errors: mixed stage tps, ``world != pp * dp * tp``, a tp the
    trainer was not given, and NCCL on a shared card;
  * (f) ``profile.runner.bench_layers`` at tp 2 on gloo ranks writes the
    JAX runner's entries.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.data.pipeline import SyntheticTokens as JTokens  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.parallel import pipeline as jpp  # noqa: E402
from repro.parallel.sharding import ShardingRules as JRules  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch.core.plan import ParallelPlan, StagePlacement  # noqa: E402
from repro_torch.iccl.communicator import AxisGroup  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import pipeline as tpp  # noqa: E402
from repro_torch.parallel import rank_programs  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.parallel.launch import run_ranks  # noqa: E402
from repro_torch.profile import runner  # noqa: E402
from repro_torch.profile.store import ProfileStore  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

TIMEOUT = 60
F32_TOL, GRAD_TOL = 2e-5, 1e-4
L, M, BT, SEQ = 4, 4, 2, 32
SMOKE4 = dict(arch="llama3-8b", smoke=True, num_layers=L)
CHUNKED = dict(SMOKE4, loss_chunk=8)
OPT = dict(lr=1e-2, warmup_steps=2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_np(tree):
    return adamw.tree_map(lambda t: t.numpy(),
                          convert.from_jax(_np(tree), device="cpu"))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: x for k, v in tree.items()
                for p, x in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


def _torch(tree):
    return adamw.tree_map(torch.from_numpy, tree)


# ------------------------------------------------------ (a) the rules ----
@pytest.mark.parametrize("tp", [1, 2, 4, 8, 16])
def test_rules_match_jax_on_every_registry_config(tp):
    """For every leaf, the dim the port splits is the dim where JAX's spec
    names ``model`` (or neither splits)."""
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    n_split = 0
    for arch in jreg.ARCH_IDS:
        jb = jreg.get_bundle(arch)
        shapes = jax.eval_shape(lambda: jb.init(jax.random.PRNGKey(0),
                                                jb.cfg))
        specs = jax.tree_util.tree_leaves(
            JRules(jb.cfg, tp=tp).param_specs(shapes),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        cfg = ModelConfig(**{k: v for k, v in
                             dataclasses.asdict(jb.cfg).items()
                             if k in fields})
        rules = sharding.ShardingRules(cfg, tp=tp)
        flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
        assert len(flat) == len(specs)
        for (kp, leaf), spec in zip(flat, specs):
            path = tuple(k.key if hasattr(k, "key") else str(k) for k in kp)
            want = list(spec).index("model") if "model" in spec else None
            got = rules.split_dim(path, len(leaf.shape))
            assert got == want, (arch, tp, path, leaf.shape, spec)
            n_split += got is not None
    assert n_split > 0      # JAX names model at tp 1 too: its size is 1


@pytest.mark.parametrize("tp", [1, 2])
def test_zero1_rule_matches_jax_on_every_registry_config(tp):
    """For every leaf and data width 1-16, the dim along which the port
    splits the AdamW moments and master over ``data`` is the dim where
    JAX's ``opt_state_spec`` of its ``param_specs`` names ``data`` (or
    neither splits)."""
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    n_split = n_whole = 0
    for arch in jreg.ARCH_IDS:
        jb = jreg.get_bundle(arch)
        shapes = jax.eval_shape(lambda: jb.init(jax.random.PRNGKey(0),
                                                jb.cfg))
        jrules = JRules(jb.cfg, tp=tp)
        specs = jax.tree_util.tree_leaves(
            jrules.param_specs(shapes),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        cfg = ModelConfig(**{k: v for k, v in
                             dataclasses.asdict(jb.cfg).items()
                             if k in fields})
        rules = sharding.ShardingRules(cfg, tp=tp)
        flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
        for (kp, leaf), spec in zip(flat, specs):
            path = tuple(k.key if hasattr(k, "key") else str(k) for k in kp)
            for dp in range(1, 17):
                zspec = jrules.opt_state_spec(spec, leaf.shape, dp)
                want = (list(zspec).index("data") if "data" in zspec
                        else None)
                got = rules.zero_dim(path, leaf.shape, dp)
                assert got == want, (arch, tp, dp, path, leaf.shape, zspec)
                n_split += got is not None
                n_whole += got is None
    assert n_split > 0 and n_whole > 0


# -------------------------------------------- (b) shard, gather, init ----
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("layers", [(4,), (3, 1)])
def test_shard_gather_and_rank_init(tp, layers):
    """One replica's ranks' states gather back to the whole bf16 state bit
    for bit (params, fp32 masters, m, v), each split leaf is cut into tp
    contiguous slices, and each rank's own initialisation equals its
    share of the whole one."""
    b = treg.get_bundle(**SMOKE4, param_dtype="bfloat16", dtype="bfloat16")
    rules = sharding.ShardingRules(b.cfg, tp=tp)
    whole = tsteps.init_train_state(b, seed=0, device="cpu")
    for t in adamw.tree_leaves(whole["opt"]["m"]):
        t.normal_()     # moments with content, so a misplaced slice shows
    ranks = [(s, r) for s in range(len(layers)) for r in range(tp)]
    parts = [tpp.split_state_for_rank(whole, layers, s, rules, r)
             for s, r in ranks]
    back = tpp.gather_rank_states(parts, rules)
    got, want = _flat(back), _flat(whole)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
    hd = b.cfg.hd
    wq = parts[0]["params"]["blocks"]["attn"]["wq"]
    assert wq.shape[-1] == b.cfg.n_heads * hd // tp
    wk = parts[0]["params"]["blocks"]["attn"]["wk"]
    assert wk.shape[-1] == (b.cfg.n_kv_heads * hd // tp if tp == 2
                            else b.cfg.n_kv_heads * hd)
    assert parts[0]["params"]["embed"].shape[0] == b.cfg.vocab_size // tp
    for (s, r), part in zip(ranks, parts):
        own = tpp.init_rank_state(b, layers, s, device="cpu", rules=rules,
                                  model_rank=r)
        g, w = _flat(own), _flat(part)
        assert sorted(g) == sorted(w)
        for k in w:
            if "/m/" in k:
                continue        # the whole state's moments were filled
            assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k


# ------------------------------------- (c) loss and gradients vs JAX ----
W2_CASES = [("tp2", SMOKE4, 2, (L,)), ("tp2-chunk", CHUNKED, 2, (L,))]
W4_CASES = [("tp4", SMOKE4, 4, (L,)), ("pp2tp2-1f1b", SMOKE4, 2, (3, 1)),
            ("pp2tp2-gpipe", SMOKE4, 2, (3, 1))]
TP_CASES = W2_CASES + W4_CASES


@pytest.fixture(scope="module")
def tp_results():
    """{case id: [rank results]}, the two worlds in turn, and JAX's loss
    and gradients {case id: (loss, port-layout grads)}."""
    jb = jreg.get_bundle("llama3-8b", smoke=True, num_layers=L)
    jparams = jb.init(jax.random.PRNGKey(0), jb.cfg)
    flat_batch = {k: np.asarray(v) for k, v in
                  jreg.make_batch(jb.cfg, batch=M * BT, seq=SEQ).items()}
    pp_batch = {k: v.reshape(M, BT, *v.shape[1:])
                for k, v in flat_batch.items()}
    params = _port_np(jparams)

    def case(cid, kw, tp, layers):
        return dict(bundle_kw=kw, params=params,
                    batch=flat_batch if len(layers) == 1 else pp_batch,
                    layers=list(layers), tp=tp, transport="gpu", slack=0,
                    schedule="gpipe" if cid.endswith("gpipe") else "1f1b")

    ranks = {}
    for world, cases in ((2, W2_CASES), (4, W4_CASES)):
        res = run_ranks(rank_programs.tp_loss_and_grads, world,
                        timeout_s=TIMEOUT, device="cpu",
                        args=([case(*c) for c in cases],))
        for i, c in enumerate(cases):
            ranks[c[0]] = [r[i] for r in res]
    jax_out = {}
    for chunk in (0, 8):
        jbc = jreg.get_bundle("llama3-8b", smoke=True, num_layers=L,
                              loss_chunk=chunk)
        loss = jsteps.make_loss_fn(jbc, JRules(jbc.cfg, tp=1))
        (jl, _), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            jparams, flat_batch)
        jax_out["chunk" if chunk else "pp1"] = (
            float(jl), convert.from_jax(_np(jg), device="cpu"))
    ploss = jpp.make_pp_loss_fn(jb.cfg, None, 2, M, layers_per_stage=[3, 1])
    stacked = jpp.stack_blocks_for_stages(jparams, 2, [3, 1])
    (jl, _), jg = jax.jit(jax.value_and_grad(ploss, has_aux=True))(
        stacked, pp_batch)
    jax_out["pp2"] = (float(jl), tpp.unstack_blocks_for_stages(
        convert.from_jax(_np(jg), device="cpu"), 2, [3, 1]))
    return ranks, jax_out


@pytest.mark.parametrize("case", TP_CASES, ids=[c[0] for c in TP_CASES])
def test_tp_loss_and_grads_match_jax(tp_results, case):
    cid, kw, tp, layers = case
    res = tp_results[0][cid]
    jl, jg = tp_results[1]["chunk" if "chunk" in cid else
                           "pp1" if len(layers) == 1 else "pp2"]
    pp = len(layers)
    assert [(r["stage"], r["model_rank"]) for r in res] == \
        [(s, i) for s in range(pp) for i in range(tp)]
    for r in res:   # every rank reports the loss of the whole model
        assert abs(r["loss"] - jl) < F32_TOL, (r["loss"], jl)
    cfg = treg.get_config(**kw)
    rules = sharding.ShardingRules(cfg, tp=tp)
    stages = [sharding.gather_trees(
        [_torch(r["grads"]) for r in res[s * tp:(s + 1) * tp]], rules)
        for s in range(pp)]
    got, want = _flat(tpp.gather_stage_trees(stages)), _flat(jg)
    assert {k: g.shape for k, g in got.items()} == \
        {k: w.shape for k, w in want.items()}
    err = max(float((got[k] - want[k]).abs().max()) for k in want)
    assert err < F32_TOL, err
    # the replicated leaves' gradients (the norm scales, and k/v under
    # split q heads at tp 4) are the same on every model rank
    for s in range(pp):
        own = [_flat(r["grads"]) for r in res[s * tp:(s + 1) * tp]]
        for k, g in own[0].items():
            path = tuple(k.strip("/").split("/"))
            if rules.split_dim(path, g.ndim) is None:
                for o in own[1:]:
                    np.testing.assert_array_equal(o[k], g, err_msg=k)
    if cid == "tp4":
        assert not rules.shard_kv and rules.partial_grad(
            ("blocks", "attn", "wk"))
    if pp == 1:
        # forward: the embedding and each block's two row-parallel
        # products; backward: each block's recomputed forward (cfg.remat)
        # up to its last saved tensor, so its attention output's
        # reduction again but not the MLP's, which follows the block's
        # last saved tensor (checkpoint's early stop), each block's two
        # column-parallel inputs and the unembedding's; a CE call's sum
        # of exp and gold logit (and an iallgather of its maxima): once,
        # or with loss_chunk once a chunk and again in its recompute; at
        # tp 4 the partial wk and wv gradients
        ce_calls = 2 * (SEQ // CHUNKED["loss_chunk"]) if "chunk" in cid \
            else 1
        for r in res:
            ops = [n[0] for n in r["notes"]]
            assert ops.count("iallgather") == ce_calls
            assert ops.count("iallreduce") == \
                5 * L + 2 + ce_calls + 2 * (cid == "tp4"), ops
    else:
        hops = M * 2 * (pp - 1)
        assert sum(1 for r in res for n in r["notes"]
                   if n[0] == "isend_irecv") == hops * tp


# --------------------------------- (d) pp 2 x dp 2 x tp 2 trainer ----
def test_trainer_pp2_dp2_tp2_ranks_match_jax_train_step():
    """8 ranks, B_tick 2 (a row a replica), m 2; parameters held as
    tests/test_torch_ranks.py holds pp 2 x dp 2: screened by sqrt(v)
    after every step.  Every rank's losses and gradient norms are JAX's."""
    jb = jreg.get_bundle("llama3-8b", smoke=True, num_layers=L)
    vl, gb, dp, tp = [3, 1], 4, 2, 2
    plan = ParallelPlan(stages=(StagePlacement(0, 3, dp, tp),
                                StagePlacement(1, 1, dp, tp, True)),
                        micro_bs=1, global_batch=gb, seq_len=SEQ,
                        schedule="1f1b-eager", eager_slack=1)
    m, bt = plan.micro_batches, plan.tokens_per_tick
    assert (m, bt) == (2, 2)
    start = jsteps.init_train_state(jb, jax.random.PRNGKey(0))
    rules = JRules(jb.cfg, tp=1, dp_axes=("data",))
    jloss = jpp.make_pp_loss_fn(jb.cfg, None, 2, m, layers_per_stage=vl,
                                stage_tp=[tp, tp])
    step = jax.jit(jsteps.make_train_step(jb, rules,
                                          jadamw.AdamWConfig(**OPT),
                                          loss_fn=jloss))
    stack = lambda tree: jpp.stack_blocks_for_stages(tree, 2, vl)  # noqa
    state = dict(start, params=stack(start["params"]),
                 opt=dict(start["opt"], m=stack(start["opt"]["m"]),
                          v=stack(start["opt"]["v"])))
    unstack = lambda tree: tpp.unstack_blocks_for_stages(  # noqa: E731
        convert.from_jax(_np(tree), device="cpu"), 2, vl)
    res = run_ranks(rank_programs.trainer_steps, 2 * dp * tp,
                    timeout_s=TIMEOUT, device="cpu",
                    args=(SMOKE4, plan.to_dict(), _port_np(start), 3, OPT))
    data = JTokens(vocab_size=jb.cfg.vocab_size, seq_len=SEQ,
                   global_batch=gb)
    want, norms, rms_min = [], [], None
    for i in range(3):
        batch = {k: v.reshape(m, bt, *v.shape[1:])
                 for k, v in data.batch_at(i).items()}
        state, metrics = step(state, batch)
        want.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        rms = {k: v.sqrt() for k, v in _flat(unstack(state["opt"]["v"]))
               .items()}
        rms_min = rms if rms_min is None else {
            k: torch.minimum(rms_min[k], rms[k]) for k in rms}
    assert [(r["stage"], r["replica"], r["model_rank"]) for r in res] == \
        [(s, d, i) for s in range(2) for d in range(dp) for i in range(tp)]
    for r in res:
        assert r["step"] == 3
        np.testing.assert_allclose(r["losses"], want, rtol=0, atol=F32_TOL)
        np.testing.assert_allclose(r["grad_norms"], norms, rtol=F32_TOL,
                                   atol=0)
    replica0 = [r for r in res if r["replica"] == 0]
    for a, b in zip(replica0, [r for r in res if r["replica"] == 1]):
        for x, y in zip(adamw.tree_leaves(a["params"]),
                        adamw.tree_leaves(b["params"])):
            np.testing.assert_array_equal(x, y)
    trules = sharding.ShardingRules(treg.get_config(**SMOKE4), tp=tp)

    def gather(key):
        return tpp.gather_stage_trees([sharding.gather_trees(
            [_torch(r[key]) for r in replica0[s * tp:(s + 1) * tp]], trules)
            for s in range(2)])

    got, want_p = _flat(gather("params")), _flat(unstack(state["params"]))
    assert sorted(got) == sorted(want_p) == sorted(rms_min)
    for k in want_p:
        err = (got[k] - want_p[k]).abs()
        assert float(err.max()) < 2 * 3 * OPT["lr"]
        held = rms_min[k] >= GRAD_TOL
        assert not held.any() or float(err[held].max()) < GRAD_TOL, k


# -------------------------------------------------------- (e) errors ----
def _plan(layers=(3, 1), tps=(2, 2), dp=1, **kw):
    stages = tuple(StagePlacement(s, n, dp, t, s == len(layers) - 1)
                   for s, (n, t) in enumerate(zip(layers, tps)))
    return ParallelPlan(stages=stages, micro_bs=1, global_batch=4,
                        seq_len=SEQ, **kw)


def test_mixed_stage_tps_raise_and_equal_ones_do_not():
    cfg = treg.get_config(**SMOKE4)
    tpp.check_rank_plan(cfg, _plan())
    tpp.check_rank_plan(cfg, _plan((4,), (4,)))
    with pytest.raises(ValueError, match=r"stage tp \(2, 1\).*pp_reshard"):
        tpp.check_rank_plan(cfg, _plan(tps=(2, 1)))


@pytest.mark.parametrize("plan,tp,match", [
    (_plan(), 0, "world size 2 is not pp 2 x dp 1 x tp 2"),
    (_plan((4,), (1,)), 2, r"stage tp \(1,\), the trainer tp 2"),
    (_plan((4,), (2,), dp=2), 0, "world size 2 is not pp 1 x dp 2 x tp 2"),
], ids=["pp2tp2-on-2", "plan-tp1-trainer-tp2", "dp2tp2-on-2"])
def test_rank_route_errors_on_ranks(plan, tp, match):
    with pytest.raises(RuntimeError, match=match):
        run_ranks(rank_programs.trainer_steps, 2, timeout_s=TIMEOUT,
                  device="cpu",
                  args=(SMOKE4, plan.to_dict(), None, 1, OPT, tp))


def test_trainer_tp_without_ranks_raises():
    with pytest.raises(ValueError, match="tp 2 runs on ranks"):
        Trainer(treg.get_bundle(**SMOKE4),
                TrainerConfig(global_batch=4, seq_len=SEQ, tp=2),
                device="cpu")


def test_gpu_transport_on_a_shared_card_raises_on_the_model_axis():
    """A tp plan whose two model ranks drive one card cannot use NCCL: the
    communicator names the host-staged transport instead of taking it."""
    shared = AxisGroup(None, (0, 1), ("h/cuda:0", "h/cuda:0"), nccl=True)
    with pytest.raises(ValueError, match="axis 'model'.*transport='cpu'"):
        shared.check_gpu("model", "gpu")


# ---------------------------------------------------- (f) the runner ----
def test_bench_layers_at_tp2_writes_the_jax_runners_entries():
    store = ProfileStore()
    runner.bench_layers(store, "cpu", "llama3-8b", (32,), (1,), tp=2,
                        warmup=0, reps=1, verbose=False, device="cpu")
    probes = store.entries("cpu", "loss_probe")
    assert sorted(e.shape["n_layers"] for e in probes) == [1, 2]
    for e in probes:
        assert e.shape == {"arch": "llama3-8b", "seq_len": 32,
                           "micro_bs": 1, "tp": 2,
                           "n_layers": e.shape["n_layers"]}
        assert sorted(e.value) == ["fwd_s", "step_s"]
        assert e.value["fwd_s"] > 0 and e.value["step_s"] > 0
    step, = store.entries("cpu", "layer_step")
    assert step.shape == {"arch": "llama3-8b", "seq_len": 32, "micro_bs": 1,
                          "tp": 2}
    assert sorted(step.value) == ["bwd_s", "fwd_s"]
