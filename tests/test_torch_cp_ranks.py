"""The cp ring across ranks against the JAX package, on gloo CPU ranks.

A pp 1, cp > 1 plan on the rank route runs one ring rank a process: each
embeds its chunk of the sequence, passes K and V one hop a ring step over
the ``pod`` axis's ``Communicator`` (``ops.ring_attention_ranks``) in the
forward and again in the backward, and the trainer sums the ranks'
partial gradients over ``pod`` (``pipeline.PPRankStep``).  Every rank
runs in a process of its own through ``parallel/launch.run_ranks`` (each
run under a timeout of 60 s), running a program of
``repro_torch.parallel.rank_programs``; the JAX references are computed
in this process on JAX's SMOKE llama3-8b at 4 layers, fp32 (4 q heads,
2 kv heads, d_ff 128, vocab 256):

  * the loss and the gradients summed over the ring, at cp 2 (``(20,
    12)``, S 32) and cp 3 (``(40, 31, 25)``, S 96), remat on and off, and
    at cp 2 x tp 2, against JAX's ``make_cp_loss_fn(cfg, None, chunks)``
    and ``jax.grad`` of it within 2e-5, and against the port's one-process
    cp loss; each rank's ring hops (ICCL ``isend_irecv`` notes);
  * the ring function alone against ``ops.ring_attention`` on the stacked
    layout, outputs and dq/dk/dv within 2e-5, with a one-row chunk whose
    rank sees every later block masked;
  * three ``Trainer`` steps on cp 2 x dp 2 (4 ranks, batch 2, ZeRO-1 over
    the two data groups) against JAX's jitted train step with its cp
    loss: losses within 1e-4, parameters within 1e-4 where sqrt(v) says
    their gradient was more than rounding noise; the two ring ranks of a
    group equal bit for bit; each rank's optimizer state half of the
    split leaves';
  * a checkpoint of cp 2 ranks at step 2 resumed on the same ranks (the
    next loss bit for bit) and on the one-process cp route (the state bit
    for bit, the loss within 2e-5);
  * the scope: a pp > 1, cp > 1 plan raises naming A8b, in process and on
    ranks; ``migrate.redistribute`` from a cp plan and onto one moves
    every element bit for bit against the checkpoint and
    ``split_state_for_rank``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from concurrent.futures import ThreadPoolExecutor  # noqa: E402

from repro.data.pipeline import SyntheticTokens as JTokens  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.parallel import context as jcontext  # noqa: E402
from repro.parallel.sharding import ShardingRules as JRules  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch.core.plan import ParallelPlan, StagePlacement  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ring_attention import pad_chunks  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import context  # noqa: E402
from repro_torch.parallel import migrate  # noqa: E402
from repro_torch.parallel import pipeline as tpp  # noqa: E402
from repro_torch.parallel import rank_programs, sharding  # noqa: E402
from repro_torch.parallel.launch import run_ranks  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

TIMEOUT = 60
F32_TOL, GRAD_TOL = 2e-5, 1e-4
L = 4
SMOKE4 = dict(arch="llama3-8b", smoke=True, num_layers=L)
OPT = dict(lr=1e-2, warmup_steps=2)
CP2, CP3 = (20, 12), (40, 31, 25)
# (id, chunks, tp, remat)
CASES = [("cp2", CP2, 1, True), ("cp2-no-remat", CP2, 1, False),
         ("cp3", CP3, 1, True), ("cp3-no-remat", CP3, 1, False),
         ("cp2-tp2", CP2, 2, True)]


def _deadline(world: int) -> float:
    """``run_ranks``' wait for ``world`` ranks: TIMEOUT for two, scaled with
    the ranks beyond (each starts an interpreter and a process group, and
    shares the host's cores with the other test workers)."""
    return TIMEOUT * max(1.0, world / 2)


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


def _port_np(tree):
    return adamw.tree_map(lambda t: t.numpy(),
                          convert.from_jax(_np(tree), device="cpu"))


def _torch(tree):
    return adamw.tree_map(torch.from_numpy, tree)


def _flat(tree, prefix=""):
    """{key path: leaf} (jax orders a dict's keys, the port keeps them)."""
    if isinstance(tree, dict):
        return {p: x for k, v in tree.items()
                for p, x in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


def _max_err(got, want) -> float:
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    return max(float(np.abs(np.asarray(got[k], np.float32)
                            - np.asarray(want[k], np.float32)).max())
               for k in want)


def _meanwhile(*runs):
    """Start each ``(fn, world, args)`` on ranks from a thread, so the JAX
    reference compiles while they run; returns the futures."""
    pool = ThreadPoolExecutor(max_workers=len(runs))
    futures = [pool.submit(run_ranks, fn, world, timeout_s=_deadline(world),
                           device="cpu", args=args)
               for fn, world, args in runs]
    pool.shutdown(wait=False)
    return futures


def _cp_plan(chunks, dp=None, global_batch=2, pp=1, **kw):
    cp = len(chunks)
    dp = dp or cp
    layers = [L // pp] * pp
    return ParallelPlan(
        stages=tuple(StagePlacement(s, n, dp, 1, s == pp - 1)
                     for s, n in enumerate(layers)),
        micro_bs=global_batch // (dp // cp), global_batch=global_batch,
        seq_len=sum(chunks), cp=cp, cp_chunks=tuple(chunks), **kw)


def _hops(cp: int, remat: bool) -> int:
    """A ring rank's ``isend_irecv`` notes a layer: the forward's cp - 1 KV
    hops (again in remat's recompute), the backward's cp - 1 KV hops and
    cp dK/dV hops (the last one home)."""
    return (cp - 1) * (2 if remat else 1) + 2 * (cp - 1) + 1


# ------------------------------------------- the loss and gradients ----
@pytest.fixture(scope="module")
def cp_results():
    """{case id: [rank results]} of ``rank_programs.cp_loss_and_grads``,
    and {(chunks, remat): (JAX's loss, its gradients in the port's
    layout, the port's one-process cp loss and gradients)}."""
    jb = jreg.get_bundle(**SMOKE4)
    jparams = jb.init(jax.random.PRNGKey(0), jb.cfg)
    params = _port_np(jparams)
    batches = {S: {k: np.asarray(v) for k, v in
                   jreg.make_batch(jb.cfg, batch=2, seq=S).items()}
               for S in (sum(CP2), sum(CP3))}

    def case(chunks, tp, remat):
        return dict(bundle_kw=dict(SMOKE4, remat=remat), params=params,
                    batch=batches[sum(chunks)], chunks=chunks, tp=tp)

    worlds = {}
    for cid, chunks, tp, remat in CASES:
        worlds.setdefault(len(chunks) * tp, []).append(
            (cid, case(chunks, tp, remat)))
    futures = {w: f for w, f in zip(worlds, _meanwhile(*(
        (rank_programs.cp_loss_and_grads, w, ([c for _, c in cs],))
        for w, cs in worlds.items())))}
    refs = {}
    for chunks, remat in {(c[1], c[3]) for c in CASES}:
        jbr = jreg.get_bundle(**SMOKE4, remat=remat)
        batch = batches[sum(chunks)]
        (jl, _), jg = jax.jit(jax.value_and_grad(
            jcontext.make_cp_loss_fn(jbr.cfg, None, chunks),
            has_aux=True))(jparams, batch)
        tb = treg.get_bundle(**SMOKE4, remat=remat)
        p = adamw.tree_map(lambda a: torch.from_numpy(a).requires_grad_(),
                           params)
        tl, _ = context.make_cp_loss_fn(tb.cfg, chunks)(p, _torch(batch))
        it = iter(torch.autograd.grad(tl, adamw.tree_leaves(p)))
        tg = adamw.tree_map(lambda _: next(it).numpy(), p)
        refs[(chunks, remat)] = (float(jl), _port_np(jg),
                                 float(tl.detach()), tg)
    ranks = {}
    for w, cs in worlds.items():
        res = futures[w].result()
        for i, (cid, _) in enumerate(cs):
            ranks[cid] = [r[i] for r in res]
    return ranks, refs


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_cp_ranks_loss_and_grads_match_jax(cp_results, case):
    """Every rank reports the ring's whole loss; the gradients summed over
    ``pod`` (at tp 2 gathered over ``model``) are JAX's, and equal on
    every ring rank."""
    cid, chunks, tp, remat = case
    res = cp_results[0][cid]
    jl, jg, tl, tg = cp_results[1][(chunks, remat)]
    cp = len(chunks)
    assert [(r["ring"], r["model_rank"]) for r in res] == \
        [(c, i) for c in range(cp) for i in range(tp)]
    for r in res:
        assert abs(r["loss"] - jl) < F32_TOL, (r["loss"], jl)
        assert abs(r["loss"] - tl) < F32_TOL, (r["loss"], tl)
    # each ring rank holds a part of the loss, as many parts as ranks
    parts = [r["part"] for r in res[::tp]]
    assert abs(sum(parts) - jl) < F32_TOL and min(parts) > 0
    rules = sharding.ShardingRules(treg.get_config(**SMOKE4), tp=tp)
    got = sharding.gather_trees([_torch(r["grads"]) for r in res[:tp]],
                                rules)
    got = adamw.tree_map(lambda t: t.numpy(), got)
    assert _max_err(got, jg) < F32_TOL
    assert _max_err(got, tg) < F32_TOL
    for c in range(1, cp):      # the sums over pod agree bit for bit
        for a, b in zip(res[:tp], res[c * tp:(c + 1) * tp]):
            for x, y in zip(adamw.tree_leaves(a["grads"]),
                            adamw.tree_leaves(b["grads"])):
                np.testing.assert_array_equal(x, y)
    # the ring's hops: K and V stacked into one message, dK/dV in another,
    # both of this model rank's kv heads padded to the largest chunk
    cfg = treg.get_config(**SMOKE4)
    kv_bytes = 2 * 2 * max(chunks) * (cfg.n_kv_heads // tp) * cfg.hd * 4
    for r in res:
        hops = [n for n in r["notes"] if n[0] == "isend_irecv"]
        assert len(hops) == L * _hops(cp, remat), len(hops)
        assert {n[2] for n in hops} == {kv_bytes}


@pytest.mark.parametrize("chunks", [CP2, (1, 24, 7)],
                         ids=["cp2", "cp3-one-row"])
def test_ring_function_matches_the_stacked_ring(chunks):
    """``ops.ring_attention_ranks`` on ranks against ``ops.ring_attention``
    on the stacked layout of one process: each rank's output and its
    chunk's dq, dk and dv within 2e-5.  Rank 0 of ``(1, 24, 7)`` holds one
    row and every later block it sees lies in its future (a masked
    hop)."""
    cp, S, B, H, Hk, hd = len(chunks), sum(chunks), 2, 4, 2, 16
    rng = np.random.default_rng(0)
    q, dout = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(2))
    k, v = (rng.standard_normal((B, S, Hk, hd)).astype(np.float32)
            for _ in range(2))
    res = run_ranks(rank_programs.ring_ranks_attention, cp,
                    timeout_s=_deadline(cp), device="cpu",
                    args=(q, k, v, dout, chunks))
    qt, kt, vt = (pad_chunks(torch.from_numpy(a), chunks).requires_grad_()
                  for a in (q, k, v))
    o = ops.ring_attention(qt, kt, vt, chunks)
    grads = torch.autograd.grad(
        o, (qt, kt, vt), grad_outputs=pad_chunks(torch.from_numpy(dout),
                                                 chunks))
    for r, c in enumerate(chunks):
        want = {"o": o.detach()[r, :, :c],
                **{n: g[r, :, :c] for n, g in zip(("dq", "dk", "dv"),
                                                  grads)}}
        for n, w in want.items():
            np.testing.assert_allclose(res[r][n], w.numpy(), rtol=0,
                                       atol=F32_TOL, err_msg=f"{n} {r}")
        hops = [x for x in res[r]["notes"] if x[0] == "isend_irecv"]
        assert len(hops) == _hops(cp, remat=False)


# ------------------------------------------------ the trainer ----
def test_trainer_cp2_dp2_ranks_match_jax_train_step():
    """cp 2 x dp 2: four ranks, two data groups of a row each (batch 2),
    ZeRO-1 over the groups; three steps against JAX's jitted train step
    with its cp loss, looped without a mesh as tests/test_torch_train.py
    does."""
    jb = jreg.get_bundle(**SMOKE4)
    plan = _cp_plan(CP2, dp=4, global_batch=2)
    assert (plan.micro_batches, plan.tokens_per_tick) == (1, 2)
    start = jsteps.init_train_state(jb, jax.random.PRNGKey(0))
    ranks, = _meanwhile((rank_programs.trainer_steps, 4,
                         (SMOKE4, plan.to_dict(), _port_np(start), 3, OPT)))
    step = jax.jit(jsteps.make_train_step(
        jb, JRules(jb.cfg, tp=1, dp_axes=("data",)),
        jadamw.AdamWConfig(**OPT),
        loss_fn=jcontext.make_cp_loss_fn(jb.cfg, None, CP2)))
    data = JTokens(vocab_size=jb.cfg.vocab_size, seq_len=sum(CP2),
                   global_batch=2)
    state, want, rms_min = start, [], None
    for i in range(3):
        state, metrics = step(state, data.batch_at(i))
        want.append(float(metrics["loss"]))
        rms = {k: np.sqrt(v) for k, v in _flat(_port_np(state["opt"]["v"]))
               .items()}
        rms_min = rms if rms_min is None else {
            k: np.minimum(rms_min[k], rms[k]) for k in rms}
    res = ranks.result()
    assert [(r["ring"], r["replica"]) for r in res] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in res:
        assert r["step"] == 3
        np.testing.assert_allclose(r["losses"], want, rtol=1e-4, atol=1e-4)
        # ZeRO-1 over the two groups: half of each split leaf's m and v
        assert r["opt_bytes"] - r["opt_whole_bytes"] == \
            (4 * r["n_params"] * len(r["opt_trees"])
             - r["opt_whole_bytes"]) // 2
        assert r["n_zero_split"] > 0
    for a, b in ((res[0], res[2]), (res[1], res[3]), (res[0], res[1])):
        for x, y in zip(adamw.tree_leaves(a["params"]),
                        adamw.tree_leaves(b["params"])):
            np.testing.assert_array_equal(x, y)
    got, want_p = _flat(res[0]["params"]), _flat(_port_np(state["params"]))
    assert sorted(got) == sorted(want_p) == sorted(rms_min)
    for k in want_p:
        err = np.abs(got[k] - want_p[k])
        assert float(err.max()) < 2 * 3 * OPT["lr"]
        held = rms_min[k] >= GRAD_TOL
        assert not held.any() or float(err[held].max()) < 1e-4, k


# --------------------------------------------------- checkpoints ----
def test_cp_ranks_checkpoint_resumes_on_ranks_and_one_process(tmp_path):
    """cp 2 ranks save at step 2 and take a third step; new cp 2 ranks
    resume from the checkpoint and take it again, equal bit for bit; a
    one-process cp trainer restores the ranks' step-2 state bit for bit
    and its third loss is the ranks' within 2e-5."""
    plan = _cp_plan(CP2)
    d = str(tmp_path / "ck")
    first = run_ranks(rank_programs.pp_train, 2, timeout_s=TIMEOUT,
                      device="cpu",
                      args=(SMOKE4, plan.to_dict(), 2, OPT, False, d, 2, 0,
                            1, True))
    again = run_ranks(rank_programs.pp_train, 2, timeout_s=TIMEOUT,
                      device="cpu",
                      args=(SMOKE4, plan.to_dict(), 1, OPT, False, d, 2, 2))
    assert [r["ring"] for r in first] == [0, 1]
    assert first[0]["ring_equal"] and first[1]["ring_equal"]
    third = first[0]["after_losses"][0]
    assert [r["losses"][0] for r in again] == [third, third]
    # ring rank 1 writes nothing: ring rank 0 writes the group's state
    assert first[1]["ckpt"]["bytes"] == 0 < first[0]["ckpt"]["bytes"]
    one = Trainer(treg.get_bundle(**SMOKE4),
                  TrainerConfig(global_batch=2, seq_len=sum(CP2),
                                ckpt_dir=d),
                  plan=plan, opt_cfg=adamw.AdamWConfig(**OPT), device="cpu")
    assert one.step == 2 and one._cp_active()
    at2 = first[0]["states"][1]
    for (k, x), (k2, y) in zip(sorted(_flat(at2).items()),
                               sorted(_flat(one.state).items())):
        assert k == k2
        np.testing.assert_array_equal(x, y.numpy(), err_msg=k)
    assert abs(one.run(1)["losses"][0] - third) < F32_TOL


# ---------------------------------------------------------- scope ----
def test_cp_at_pp2_raises_naming_a8b_in_process_and_on_ranks():
    cfg = treg.get_config(**SMOKE4)
    plan = _cp_plan(CP2, dp=2, pp=2)
    with pytest.raises(ValueError, match="A8b"):
        tpp.check_rank_plan(cfg, plan)
    tpp.check_rank_plan(cfg, _cp_plan(CP2))
    with pytest.raises(RuntimeError, match="A8b"):
        run_ranks(rank_programs.trainer_steps, 4, timeout_s=_deadline(4),
                  device="cpu", args=(SMOKE4, plan.to_dict(), None, 1, OPT))


def test_redistribute_to_and_from_a_cp_plan_moves_bit_for_bit(tmp_path):
    """``migrate.redistribute`` between cp 2 (one group of two ring ranks)
    and pp 1 x dp 2 (ZeRO-1), both ways, on two ranks: each rank's moved
    state equals its ``restore_rank`` of the old plan's checkpoint under
    the new plan and ``split_state_for_rank`` of the whole state, bit for
    bit; a move onto cp 2 gives both ring ranks the whole optimizer
    state."""
    kw = dict(SMOKE4, param_dtype="bfloat16", dtype="bfloat16")
    b = treg.get_bundle(**kw)
    whole = tsteps.init_train_state(b, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    whole["opt"] = adamw.tree_map(     # moments that are not all zero
        lambda t: t + torch.rand(t.shape, generator=gen).to(t.dtype)
        if t.is_floating_point() else t, whole["opt"])
    cp2, dp2 = _cp_plan(CP2), dataclasses.replace(
        _cp_plan(CP2), cp=1, cp_chunks=None, micro_bs=1)
    cases = [(cp2.to_dict(), dp2.to_dict()), (dp2.to_dict(), cp2.to_dict())]
    wnp = rank_programs._numpy_tree(whole)
    res = run_ranks(rank_programs.migrate_cases, 2, timeout_s=TIMEOUT,
                    device="cpu", args=(kw, wnp, cases, str(tmp_path)))
    for i, (_, new_d) in enumerate(cases):
        new = ParallelPlan.from_dict(new_d)
        rules = sharding.ShardingRules(b.cfg, tp=1)
        for rank in range(2):
            got = res[rank][i]
            assert got["unequal_to_checkpoint"] == []
            stage, replica, mr = migrate.rank_coords(new, rank)
            want = tpp.split_state_for_rank(whole, new, stage, rules, mr,
                                            replica=replica)
            want = rank_programs._numpy_tree(want)
            for (k, x), (k2, y) in zip(sorted(_flat(got["state"]).items()),
                                       sorted(_flat(want).items())):
                assert k == k2
                np.testing.assert_array_equal(x, y, err_msg=k)
        if new.cp > 1:      # ring ranks: one state, every element twice
            assert _max_err(res[0][i]["state"], res[1][i]["state"]) == 0
