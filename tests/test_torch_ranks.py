"""The port's multi-rank runtime against the JAX package, on gloo CPU ranks.

Every rank runs in a process of its own through
``repro_torch.parallel.launch.run_ranks``, with a timeout of 60 s or less,
running a program of ``repro_torch.parallel.rank_programs``; the JAX
references are computed in this process (or in a subprocess that owns a
4-device host farm):

  * (a) the ICCL ``Communicator`` on 4 ranks against the JAX
    ``Communicator`` under ``shard_map`` on 4 host devices, the same numpy
    inputs: fp32 within 2e-5, bf16 (``compress``) within 2e-2, moves equal;
  * (b) a pp 2 and a pp 3 rank step's loss and every rank's gradients
    against JAX's ``make_pp_loss_fn`` and its gradient (unsharded, SMOKE
    llama3-8b, fp32) within 2e-5, for (3, 1), (2, 2) and (2, 1, 1) under
    1f1b, 1f1b-eager and gpipe, and under interleaved-1f1b at vpp 2 for
    virtual layers (2, 1, 1, 0) and (1, 1, 1, 1) (pp 2, m 4) and
    (1, 1, 0, 1, 1, 0) (pp 3, m 3); each rank's in-flight peak equals the
    simulator's, and each hop is noted once, by its sender; every order
    under strict rendezvous with untagged messages matched in posting
    order: no deadlock, every receive gets its message, and the
    interleaved orders accepted exactly where that holds;
  * (c) three ``Trainer`` steps on pp 2 x dp 2 ranks (1f1b-eager, and
    interleaved-1f1b at vpp 2) and on pp 1 x dp 2 ranks, ZeRO-1 over
    ``data``, against JAX's jitted train step on the same global batches,
    as ``tests/test_torch_pipeline.py`` holds the one-card route; the
    replicas' parameters equal bit for bit;
  * (d) ``split_state_for_rank`` and its gather bit for bit, interleaved
    chunks and ZeRO-1 slices included, and a rank's own initialisation
    equal to the slice of the whole one;
  * (e) the rank route's errors, and ranks that raise or block end within
    their timeout;
  * (f) ``profile.runner.bench_collectives`` on 2 ranks writes the JAX
    runner's entries;
  * (g) the train CLI under ``torchrun`` on 2 CPU ranks, with ``--pp 2``
    and without (dp 2).
"""
import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.data.pipeline import SyntheticTokens as JTokens  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.parallel import pipeline as jpp  # noqa: E402
from repro.parallel.sharding import ShardingRules  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch.core import simulator  # noqa: E402
from repro_torch.core.plan import ParallelPlan, StagePlacement  # noqa: E402
from repro_torch.iccl.communicator import (AxisGroup,  # noqa: E402
                                           Communicator)
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import pipeline as tpp  # noqa: E402
from repro_torch.parallel import rank_programs, sharding  # noqa: E402
from repro_torch.parallel.launch import run_ranks  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 60
F32_TOL, BF16_TOL, GRAD_TOL = 2e-5, 2e-2, 1e-4
M, BT, SEQ = 4, 2, 32
SMOKE4 = dict(arch="llama3-8b", smoke=True, num_layers=4)
SCHEDULES = ("1f1b", "1f1b-eager", "gpipe")
SLACK = 1


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


def _ranks_meanwhile(*runs):
    """Start each ``(fn, world, args)`` on ranks from a thread, so the JAX
    reference compiles while they run; returns the futures."""
    pool = ThreadPoolExecutor(max_workers=len(runs))
    futures = [pool.submit(run_ranks, fn, world, timeout_s=_deadline(world),
                           device="cpu", args=args)
               for fn, world, args in runs]
    pool.shutdown(wait=False)
    return futures


def _port_np(tree):
    """A JAX tree as the port's numpy leaves (``convert.from_jax``: the
    ``_stacked`` marker dropped)."""
    return adamw.tree_map(lambda t: t.numpy(),
                          convert.from_jax(_np(tree), device="cpu"))


def _flat(tree, prefix=""):
    """{key path: leaf} (jax orders a dict's keys, the port keeps them)."""
    if isinstance(tree, dict):
        return {p: x for k, v in tree.items()
                for p, x in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


# ------------------------------------------ (a) the communicator ----
N_DEV, N_EL = 4, 32
JAX_COMM = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json, sys
sys.path.insert(0, "src")
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.iccl.communicator import Communicator
from repro.profile import runner
from repro.profile.store import ProfileStore
from repro.utils import compat
n = 4
xs = np.array(json.loads(sys.stdin.read()), np.float32)
mesh = jax.make_mesh((n,), ("x",))
comm = Communicator("x")
rev = [(i, n - 1 - i) for i in range(n)]
bodies = {
    "iallreduce": comm.iallreduce,
    "iallreduce_compress": Communicator("x", compress=True).iallreduce,
    "iallgather": comm.iallgather,
    "iallgather_stacked": lambda y: comm.iallgather(y, 0, tiled=False),
    "ireducescatter": comm.ireducescatter,
    "ialltoall": lambda y: comm.ialltoall(y.reshape(n, -1), 1, 0),
    "isend_irecv": lambda y: comm.isend_irecv(y, rev),
    "shift": lambda y: comm.shift(y, 1),
    "shift_wrap": lambda y: comm.shift(y, 1, wrap=True),
}
out = {}
for name, body in bodies.items():
    f = jax.jit(compat.shard_map(body, mesh=mesh, in_specs=(P("x"),),
                                 out_specs=P("x"), check_vma=False))
    g = np.asarray(f(jnp.asarray(xs.reshape(-1))))
    out[name] = g.reshape((n, -1) + g.shape[1:]).tolist()
store = ProfileStore()
runner.bench_collectives(store, "cpu", (4096,), warmup=0, reps=1,
                         verbose=False)
out["entries"] = [e.to_dict() for e in store.entries()]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def comm_inputs():
    return np.random.default_rng(0).standard_normal(
        (N_DEV, N_EL)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_comm(comm_inputs):
    r = subprocess.run([sys.executable, "-c", JAX_COMM], cwd=str(ROOT),
                       input=json.dumps(comm_inputs.tolist()),
                       capture_output=True, text=True, timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def torch_comm(comm_inputs):
    return run_ranks(rank_programs.comm_ops, N_DEV,
                     timeout_s=_deadline(N_DEV),
                     device="cpu",
                     args=(comm_inputs, N_EL))


COMM_OPS = ("iallreduce", "iallreduce_compress", "iallgather",
            "iallgather_stacked", "ireducescatter", "ialltoall",
            "isend_irecv", "shift", "shift_wrap")


@pytest.mark.parametrize("op", COMM_OPS)
def test_communicator_matches_jax(jax_comm, torch_comm, op):
    """Each rank's result equals the JAX device's shard: sums within fp32
    (bf16 with ``compress``: the wire is bf16 in both), moves exactly;
    ``shift`` without ``wrap`` leaves rank 0 zeros, as ``ppermute``."""
    want = np.array(jax_comm[op], np.float32)
    got = np.stack([r[op] for r in torch_comm])
    assert got.shape == want.shape, (op, got.shape, want.shape)
    if op.startswith(("iallreduce", "ireducescatter")):
        tol = BF16_TOL if op.endswith("compress") else F32_TOL
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    else:
        np.testing.assert_array_equal(got, want)
    if op == "shift":
        assert not got[0].any()
    assert [(r["index"], r["size"]) for r in torch_comm] == \
        [(i, N_DEV) for i in range(N_DEV)]


def test_communicator_shapes_match_the_jax_shard_shapes(torch_comm):
    """One rank's results from a (32,) input, as the JAX methods give them
    per device on a 4-device farm."""
    shapes = {op: np.asarray(torch_comm[0][op]).shape for op in COMM_OPS}
    assert shapes == {
        "iallreduce": (32,), "iallreduce_compress": (32,),
        "iallgather": (128,), "iallgather_stacked": (4, 32),
        "ireducescatter": (8,), "ialltoall": (16, 2), "isend_irecv": (32,),
        "shift": (32,), "shift_wrap": (32,)}


# ----------------------------------------- (b) the rank step vs JAX ----
IL = "interleaved-1f1b"
PP_CASES = {2: [((3, 1), s) for s in SCHEDULES]
            + [((2, 2), s) for s in SCHEDULES]
            + [((2, 1, 1, 0), IL), ((1, 1, 1, 1), IL)],
            3: [((2, 1, 1), s) for s in SCHEDULES]
            + [((1, 1, 0, 1, 1, 0), IL)]}
STEP_CASES = [(pp, layers, s) for pp, cases in PP_CASES.items()
              for layers, s in cases]


def _vpp_m(pp, layers):
    """(vpp, m) of a case: the virtual layers' vpp, and M microbatches,
    or pp where M would be a ragged interleaved count (refused on ranks)."""
    vpp = len(layers) // pp
    return vpp, (pp if vpp > 1 and M > pp and M % pp else M)


@pytest.fixture(scope="module")
def smoke4():
    jb = jreg.get_bundle("llama3-8b", smoke=True, num_layers=4)
    jparams = jb.init(jax.random.PRNGKey(0), jb.cfg)
    batch = jreg.make_batch(jb.cfg, batch=M * BT, seq=SEQ)
    pp_batch = {k: np.asarray(v).reshape(M, BT, *v.shape[1:])
                for k, v in batch.items()}
    return jb, jparams, pp_batch


@pytest.fixture(scope="module")
def pp_results(smoke4):
    """Each pp's cases in one run of ``pp`` ranks, {(pp, layers, schedule):
    [rank results]}, and JAX's loss and gradients, {(pp, layers): ...}."""
    jb, jparams, pp_batch = smoke4
    futures = _ranks_meanwhile(*[
        (rank_programs.pp_loss_and_grads, pp,
         (SMOKE4, _port_np(jparams), pp_batch,
          [(list(l), s, SLACK, *_vpp_m(pp, l)) for l, s in cases]))
        for pp, cases in PP_CASES.items()])
    jax_out = {}
    for pp, layers, _ in STEP_CASES:
        if (pp, layers) in jax_out:
            continue
        vpp, m = _vpp_m(pp, layers)
        jloss = jpp.make_pp_loss_fn(jb.cfg, None, pp, m,
                                    layers_per_stage=list(layers), vpp=vpp)
        stacked = jpp.stack_blocks_for_stages(jparams, pp, list(layers),
                                              vpp=vpp)
        (jl, _), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
            stacked, {k: v[:m] for k, v in pp_batch.items()})
        jax_out[(pp, layers)] = (float(jl), tpp.unstack_blocks_for_stages(
            convert.from_jax(_np(jg), device="cpu"), pp, list(layers),
            vpp=vpp))
    ranks = {}
    for (pp, cases), fut in zip(PP_CASES.items(), futures):
        res = fut.result()
        for i, (layers, s) in enumerate(cases):
            ranks[(pp, layers, s)] = [r[i] for r in res]
    return ranks, jax_out


@pytest.mark.parametrize("case", STEP_CASES,
                         ids=[f"pp{p}-{'-'.join(map(str, l))}-{s}"
                              for p, l, s in STEP_CASES])
def test_rank_step_loss_and_grads_match_jax(smoke4, pp_results, case):
    pp, layers, schedule = case
    vpp, m = _vpp_m(pp, layers)
    V = pp * vpp
    res = pp_results[0][case]
    jl, jg = pp_results[1][(pp, layers)]
    assert [r["stage"] for r in res] == list(range(pp))
    for r in res:   # every rank reports the last stage's loss
        assert abs(r["loss"] - jl) < F32_TOL
    grads = tpp.gather_stage_trees([
        adamw.tree_map(torch.from_numpy, r["grads"]) for r in res], layers)
    got, want = _flat(grads), _flat(jg)
    assert {k: g.shape for k, g in got.items()} == \
        {k: w.shape for k, w in want.items()}
    assert max(float((got[k] - want[k]).abs().max()) for k in want) \
        < F32_TOL
    for r in res:
        s = r["stage"]
        assert r["peak_inflight"] == simulator.peak_activation_microbatches(
            s, pp, m, schedule, SLACK, vpp=vpp)
        assert [op[0] for op in r["order"]].count("F") == m * vpp
        # each hop noted once, by its sender: the activations forward
        # (every virtual stage but the last, the wrap from the last stage
        # to stage 0 included) and their gradients back (every virtual
        # stage but the first), B_tick x S x D fp32 each
        hops = m * sum((vs < V - 1) + (vs > 0) for vs in range(s, V, pp))
        nbytes = BT * SEQ * smoke4[0].cfg.d_model * 4
        assert [tuple(n) for n in r["notes"]] == \
            [("isend_irecv", "gpu", nbytes)] * hops


def test_rank_schedule_orders():
    """The static orders the simulator prices: cap forwards, one backward
    and one forward in turn, the remaining backwards."""
    F = lambda *js: [("F", j) for j in js]  # noqa: E731
    assert tpp.rank_schedule(0, 2, 4, "1f1b") == \
        F(0, 1) + [("B", 0)] + F(2) + [("B", 1)] + F(3) + \
        [("B", 2), ("B", 3)]
    assert tpp.rank_schedule(1, 2, 4, "1f1b") == [
        x for j in range(4) for x in (("F", j), ("B", j))]
    assert tpp.rank_schedule(0, 2, 4, "gpipe") == \
        F(0, 1, 2, 3) + [("B", j) for j in range(4)]
    # the cap never exceeds m
    assert tpp.rank_schedule(0, 3, 2, "1f1b-eager", 2) == \
        F(0, 1) + [("B", 0), ("B", 1)]
    # at vpp 1 a unit is one op (chunk 0), and the batch before it holds
    # the previous op's send and this op's receive
    assert tpp.rank_boundaries(1, 3, 4, "1f1b")[:3] == [
        ([("recv", 0, ("F", 1, 0))], (("F", 0, 0),)),
        ([("send", 2, ("F", 2, 0)), ("recv", 0, ("F", 1, 1))],
         (("F", 0, 1),)),
        ([("send", 2, ("F", 2, 1)), ("recv", 2, ("B", 1, 0))],
         (("B", 0, 0),))]


def test_interleaved_rank_schedule_order():
    """Megatron's units on stage 0 of pp 2, vpp 2, m 4: W = 2 + 2 = 4
    warmup forwards, (F, B) units, the cooldown backwards; ops from the
    simulator's streams."""
    F = lambda c, j: ("F", c, j)  # noqa: E731
    B = lambda c, j: ("B", c, j)  # noqa: E731
    units = tpp.interleaved_units(0, 2, 4, 2)
    assert units == [(F(0, 0),), (F(0, 1),), (F(1, 0),), (F(1, 1),),
                     (F(0, 2), B(1, 0)), (F(0, 3), B(1, 1)),
                     (F(1, 2), B(0, 0)), (F(1, 3), B(0, 1)),
                     (B(1, 2),), (B(1, 3),), (B(0, 2),), (B(0, 3),)]
    assert tpp.rank_schedule(0, 2, 4, IL, vpp=2) == \
        [op for u in units for op in u]
    # the batch before unit 6: its sends (the activation, then the
    # gradient) and then unit 6's receives, the same order
    batch, unit = tpp.rank_boundaries(0, 2, 4, IL, vpp=2)[6]
    assert unit == (F(1, 2), B(0, 0))
    assert batch == [("send", 1, ("F", 1, 3)), ("send", 1, ("B", 1, 1)),
                     ("recv", 1, ("F", 2, 2)), ("recv", 1, ("B", 0, 0))]


def _strict_rendezvous(batches):
    """Every rank posts its boundary batches in turn under the strictest
    rendezvous (a send and its receive complete only when both are
    posted, and a rank moves on only when its whole batch has); messages
    of one directed pair match in posting order, with no tags, as NCCL
    and gloo's default tag match them.  None when every rank reaches its
    end and every receive got the message it expects, else what went
    wrong (NCCL's grouped sends are this strict; gloo less)."""
    pp = len(batches)
    numbered = []       # (op, peer, message, its index on the pair)
    for s, bs in enumerate(batches):
        seen, mine = {}, []
        for b in bs:
            row = []
            for op, peer, msg in b:
                k = seen.get((op, peer), 0)
                seen[(op, peer)] = k + 1
                row.append((op, peer, msg, k))
            mine.append(row)
        numbered.append(mine)
    at, done = [0] * pp, set()
    while True:
        posted = {s: b[at[s]] for s, b in enumerate(numbered)
                  if at[s] < len(b)}
        for s, ops in posted.items():
            for op, peer, msg, k in ops:
                if op != "send":
                    continue
                for op2, src, want, k2 in posted.get(peer, ()):
                    if (op2, src, k2) == ("recv", s, k):
                        if want != msg:
                            return (f"stage {peer}'s receive {k} from {s} "
                                    f"expects {want}, gets {msg}")
                        done.add((s, peer, k))
        moved = [s for s, ops in posted.items()
                 if all(((s, p, k) if op == "send" else (p, s, k)) in done
                        for op, p, _, k in ops)]
        for s in moved:
            at[s] += 1
        if not moved:
            break
    if at != [len(b) for b in numbered]:
        return f"deadlock at batches {at} of {[len(b) for b in numbered]}"
    return None


@pytest.mark.parametrize("schedule", SCHEDULES + (IL,))
def test_rank_schedules_cannot_deadlock(schedule):
    """Every stage's boundaries (``rank_boundaries``, the batches the rank
    step posts) under strict rendezvous, for pp 2-5 and m
    1-8 (vpp 1), and under interleaved-1f1b for vpp 1-4 and m 1-16: all
    ranks reach the end, every message to its receive.  ``check_rank_plan``
    accepts an interleaved plan at vpp > 1 exactly where m <= pp or m is a
    multiple of pp, and the refused orders do fail here."""
    cfg = treg.get_config(**SMOKE4)
    refused_fail = 0
    for pp in range(2, 6):
        for vpp in ((1, 2, 3, 4) if schedule == IL else (1,)):
            for m in range(1, (17 if schedule == IL else 9)):
                for slack in ((1, 2, 3) if schedule == "1f1b-eager"
                              else (0,)):
                    batches = [[b for b, _ in tpp.rank_boundaries(
                        s, pp, m, schedule, slack, vpp) if b]
                        for s in range(pp)]
                    if schedule == IL:
                        plan = ParallelPlan(
                            stages=tuple(StagePlacement(s, vpp, 1, 1,
                                                        s == pp - 1)
                                         for s in range(pp)),
                            micro_bs=1, global_batch=m, seq_len=SEQ,
                            schedule=IL, vpp=vpp)
                        try:
                            tpp.check_rank_plan(cfg, plan)
                            accepted = True
                        except ValueError as e:
                            assert "A5c" in str(e)
                            accepted = False
                        assert accepted == (vpp == 1 or m <= pp
                                            or m % pp == 0), (pp, vpp, m)
                    else:
                        accepted = True
                    fault = _strict_rendezvous(batches)
                    if accepted:
                        assert fault is None, (pp, vpp, m, slack, fault)
                    else:
                        refused_fail += fault is not None
    if schedule == IL:
        assert refused_fail > 0     # the refusal guards orders that fail


# ------------------------------------------ (c) pp 2 x dp 2 trainer ----
OPT = dict(lr=1e-2, warmup_steps=2)
DP = 2


def _trainer_ranks_match_jax(plan):
    """Three ``Trainer`` steps of ``plan`` (dp ``DP``, ZeRO-1) on ranks
    against JAX's jitted train step and the one-process route on the same
    global batches.  Parameters are held as tests/test_torch_pipeline.py
    holds the one-card route at a global batch of 8: screened by sqrt(v)
    after every step."""
    jb = jreg.get_bundle("llama3-8b", smoke=True, num_layers=4)
    pp, vpp, vl = plan.pp, plan.vpp, list(plan.virtual_layers)
    m, bt, gb = plan.micro_batches, plan.tokens_per_tick, plan.global_batch
    start = jsteps.init_train_state(jb, jax.random.PRNGKey(0))
    ranks, = _ranks_meanwhile((rank_programs.trainer_steps, pp * DP,
                               (SMOKE4, plan.to_dict(), _port_np(start), 3,
                                OPT)))
    rules = ShardingRules(jb.cfg, tp=1, dp_axes=("data",))
    jloss, stack, shape = None, (lambda tree: tree), (lambda v: v)
    if pp > 1:
        jloss = jpp.make_pp_loss_fn(jb.cfg, None, pp, m, layers_per_stage=vl,
                                    vpp=vpp, stage_tp=[1] * pp)
        stack = lambda tree: jpp.stack_blocks_for_stages(  # noqa: E731
            tree, pp, vl, vpp=vpp)
        shape = lambda v: v.reshape(m, bt, *v.shape[1:])  # noqa: E731
    step = jax.jit(jsteps.make_train_step(jb, rules,
                                          jadamw.AdamWConfig(**OPT),
                                          loss_fn=jloss))
    state = dict(start, params=stack(start["params"]),
                 opt=dict(start["opt"], m=stack(start["opt"]["m"]),
                          v=stack(start["opt"]["v"])))
    data = JTokens(vocab_size=jb.cfg.vocab_size, seq_len=SEQ,
                   global_batch=gb)

    def unstack(tree):
        tree = convert.from_jax(_np(tree), device="cpu")
        return tree if pp == 1 else tpp.unstack_blocks_for_stages(
            tree, pp, vl, vpp=vpp)

    want, rms_min = [], None
    for i in range(3):
        batch = {k: shape(v) for k, v in data.batch_at(i).items()}
        state, metrics = step(state, batch)
        want.append(float(metrics["loss"]))
        rms = {k: v.sqrt() for k, v in _flat(unstack(state["opt"]["v"]))
               .items()}
        rms_min = rms if rms_min is None else {
            k: torch.minimum(rms_min[k], rms[k]) for k in rms}

    one = Trainer(treg.get_bundle(**SMOKE4),
                  TrainerConfig(global_batch=gb, seq_len=SEQ), plan=plan,
                  opt_cfg=adamw.AdamWConfig(**OPT),
                  state=convert.from_jax(_np(start), device="cpu"),
                  device="cpu").run(3)["losses"]
    res = ranks.result()
    assert [(r["stage"], r["replica"]) for r in res] == \
        [(s, r) for s in range(pp) for r in range(DP)]
    zrules = sharding.ShardingRules(treg.get_config(**SMOKE4), tp=1)
    for r in res:
        assert r["step"] == 3
        np.testing.assert_allclose(r["losses"], want, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(r["losses"], one, rtol=0, atol=F32_TOL)
        # ZeRO-1: the replica's v is its slice of each leaf's zero dim
        for k, p in _flat(r["params"]).items():
            v, shp = _flat(r["v"])[k], list(p.shape)
            d = zrules.zero_dim(tuple(k.split("/")[1:]), p.shape, DP)
            if d is not None:
                shp[d] //= DP
            assert list(v.shape) == shp, (k, v.shape, p.shape)
    for a, b in zip(res[0::DP], res[1::DP]):    # the replicas agree
        for x, y in zip(adamw.tree_leaves(a["params"]),
                        adamw.tree_leaves(b["params"])):
            np.testing.assert_array_equal(x, y)
    gather = lambda key: tpp.gather_stage_trees([  # noqa: E731
        adamw.tree_map(torch.from_numpy, r[key]) for r in res[0::DP]], vl)
    # parameters whose gradient was rounding noise at some step (sqrt(v)
    # < GRAD_TOL after it) move by up to lr a step in a direction the
    # rounding picks; the rest are held to GRAD_TOL
    got, want = _flat(gather("params")), _flat(unstack(state["params"]))
    assert sorted(got) == sorted(want) == sorted(rms_min)
    for k in want:
        err = (got[k] - want[k]).abs()
        assert float(err.max()) < 2 * 3 * OPT["lr"]
        held = rms_min[k] >= GRAD_TOL
        assert not held.any() or float(err[held].max()) < GRAD_TOL


@pytest.mark.parametrize("gb", [4, 8])
def test_trainer_pp2_dp2_ranks_match_jax_train_step(gb):
    """B_tick 2 (one row a replica), m gb / 2, 1f1b-eager, ZeRO-1."""
    plan = ParallelPlan(stages=(StagePlacement(0, 3, DP, 1),
                                StagePlacement(1, 1, DP, 1, True)),
                        micro_bs=1, global_batch=gb, seq_len=SEQ,
                        schedule="1f1b-eager", eager_slack=SLACK)
    assert (plan.micro_batches, plan.tokens_per_tick) == (gb // 2, 2)
    _trainer_ranks_match_jax(plan)


@pytest.mark.parametrize("case", ["pp2-vpp2", "pp1"])
def test_trainer_dp2_zero1_ranks_match_jax_train_step(case):
    """pp 2 at vpp 2 (virtual layers (2, 1, 1, 0), m 4 of B_tick 2) and
    pp 1 (4 rows a replica) over dp 2, ZeRO-1, at global batch 8."""
    if case == "pp1":
        plan = ParallelPlan(stages=(StagePlacement(0, 4, DP, 1, True),),
                            micro_bs=4, global_batch=8, seq_len=SEQ)
    else:
        plan = ParallelPlan(stages=(StagePlacement(0, 3, DP, 1),
                                    StagePlacement(1, 1, DP, 1, True)),
                            micro_bs=1, global_batch=8, seq_len=SEQ,
                            schedule=IL, vpp=2, chunk_layers=(2, 1, 1, 0))
        assert plan.micro_batches == 4
    _trainer_ranks_match_jax(plan)


def test_pp_train_records_the_zero1_update_against_one_process():
    """``rank_programs.pp_train`` on pp 1 x dp 2 ranks, bf16, ZeRO-1, at
    AdamW's defaults (what ``chip_smoke.py``'s dp_ranks reads on the
    card): every step's gradient
    norm and each leaf's fp32 master move from the initial parameters,
    the replicas' slices together, within 1e-2 of the one-process
    reference route's at the same global batch (``run_steps``), relative;
    the replicas' parameters equal bit for bit."""
    kw = dict(SMOKE4, param_dtype="bfloat16", dtype="bfloat16")
    plan = ParallelPlan(stages=(StagePlacement(0, 4, DP, 1, True),),
                        micro_bs=1, global_batch=DP, seq_len=SEQ)
    res = run_ranks(rank_programs.pp_train, DP, timeout_s=TIMEOUT,
                    device="cpu", args=(kw, plan.to_dict(), 3, None, True))
    one = Trainer(treg.get_bundle(**kw),
                  TrainerConfig(global_batch=DP, seq_len=SEQ), device="cpu")
    out, moved = rank_programs.run_steps(one, 3, moves=True)
    assert [r["replicas_equal"] for r in res] == [True] * DP
    for r in res:
        assert r["grad_norms"] == res[0]["grad_norms"]
        np.testing.assert_allclose(r["grad_norms"], out["grad_norms"],
                                   rtol=1e-2)
    assert len(moved) == 3 and len(moved[0]) == res[0]["n_leaves"]
    got = np.sqrt(np.sum([r["master_moves"] for r in res], axis=0))
    np.testing.assert_allclose(got, np.sqrt(moved), rtol=1e-2)
    # a replica that left its slice of a split leaf unchanged would show
    half = np.sqrt(np.asarray(res[0]["master_moves"]))
    assert np.abs(half / np.sqrt(moved) - 1).max() > 0.2


# ------------------------------------------------- (d) split, gather ----
@pytest.mark.parametrize("layers", [(3, 1), (1, 3), (2, 1, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_gather_and_rank_init(layers, dtype):
    """The stages' states gather back to the whole state bit for bit, and
    each rank's own initialisation equals its slice of the whole one (the
    bf16 state carries fp32 masters)."""
    b = treg.get_bundle("llama3-8b", smoke=True, num_layers=4,
                        param_dtype=dtype, dtype=dtype)
    whole = tsteps.init_train_state(b, seed=0, device="cpu")
    assert ("master" in whole["opt"]) == (dtype == "bfloat16")
    parts = [tpp.split_state_for_rank(whole, layers, s)
             for s in range(len(layers))]
    back = tpp.gather_rank_states(parts)
    for g, w in zip(adamw.tree_leaves(back), adamw.tree_leaves(whole)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert list(back["params"]) == list(whole["params"])
    for s, part in enumerate(parts):
        assert part["params"]["blocks"]["ln1"]["scale"].shape[0] == \
            layers[s]
        assert ("embed" in part["params"]) == (s == 0)
        assert ("unembed" in part["params"]) == (s == len(layers) - 1)
        own = tpp.init_rank_state(b, layers, s, device="cpu")
        got, want = adamw.tree_leaves(own), adamw.tree_leaves(part)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("case", [
    ("vpp2", (2, 1, 1, 0), 2, 1, 1), ("vpp2-dp2", (1, 2, 0, 1), 2, 2, 1),
    ("pp1-dp4", (4,), 1, 4, 1), ("pp2-dp2-tp2", (3, 1), 1, 2, 2),
    ("vpp2-dp2-tp2", (1, 1, 1, 1), 2, 2, 2)], ids=lambda c: c[0])
def test_split_gather_vpp_zero1_and_rank_init(case):
    """Every rank's state, (stage, replica, model rank) in rank order,
    gathers back to the whole bf16 state bit for bit: interleaved chunks
    in virtual order, ZeRO-1 slices of the fp32 master, m and v over
    ``data``; each rank's own initialisation equals its slice, and
    allocates only that slice of the optimizer state."""
    _, vl, vpp, dp, tp = case
    b = treg.get_bundle("llama3-8b", smoke=True, num_layers=4,
                        param_dtype="bfloat16", dtype="bfloat16")
    rules = sharding.ShardingRules(b.cfg, tp=tp)
    whole = tsteps.init_train_state(b, seed=0, device="cpu")
    for t in adamw.tree_leaves(whole["opt"]["m"]):
        t.normal_()     # moments with content, so a misplaced slice shows
    pp = len(vl) // vpp
    plan = ParallelPlan(
        stages=tuple(StagePlacement(s, sum(vl[s::pp]), dp, tp, s == pp - 1)
                     for s in range(pp)),
        micro_bs=1, global_batch=4, seq_len=SEQ,
        schedule=IL if vpp > 1 else "1f1b", vpp=vpp,
        chunk_layers=tuple(vl) if vpp > 1 else None)
    ranks = [(s, q, r) for s in range(pp) for q in range(dp)
             for r in range(tp)]
    parts = [tpp.split_state_for_rank(whole, plan, s, rules, r, replica=q)
             for s, q, r in ranks]
    back = tpp.gather_rank_states(parts, rules, plan)
    got, want = _flat(back), _flat(whole)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
    # stage 0 holds its chunks, virtual stages 0, pp, ..., in that order
    ln1 = whole["params"]["blocks"]["ln1"]["scale"]
    own = torch.cat([ln1[sum(vl[:v]):sum(vl[:v + 1])]
                     for v in range(0, len(vl), pp)])
    assert torch.equal(parts[0]["params"]["blocks"]["ln1"]["scale"], own)
    opt_el = par_el = 0
    for (s, q, r), part in zip(ranks, parts):
        mine = tpp.init_rank_state(b, plan, s, device="cpu", rules=rules,
                                   model_rank=r, replica=q)
        g, w = _flat(mine), _flat(part)
        assert list(g) == list(w)
        for k in w:
            assert g[k].shape == w[k].shape, k
            if "/m/" not in k:      # the whole state's moments were filled
                assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k])
        if (s, r) == (0, 0):
            opt_el += sum(x.numel() for x in adamw.tree_leaves(
                part["opt"]["v"]))
            par_el = sum(x.numel() for x in adamw.tree_leaves(
                part["params"]))
    # the stage's replicas together hold one copy of its moments: at SMOKE
    # widths dp divides a dim of every leaf, so ZeRO-1 leaves none whole
    assert opt_el == par_el


# -------------------------------------------------------- (e) errors ----
def _plan(layers=(3, 1), tps=(1, 1), gb=4, **kw):
    stages = tuple(StagePlacement(s, n, 1, tp, s == len(layers) - 1)
                   for s, (n, tp) in enumerate(zip(layers, tps)))
    return ParallelPlan(stages=stages, micro_bs=1, global_batch=gb,
                        seq_len=SEQ, **kw)


def test_rank_route_scope_errors_name_a5c():
    """Interleaved plans run on ranks, save a ragged microbatch count (m >
    pp, m % pp != 0), which stays refused, naming A5c, as the other
    limits do."""
    cfg = treg.get_config("llama3-8b", smoke=True, num_layers=4)
    tpp.check_rank_plan(cfg, _plan())
    tpp.check_rank_plan(cfg, _plan((2, 1), vpp=2, schedule=IL))
    with pytest.raises(ValueError, match="interleaved-1f1b with vpp=2 .*A5c"):
        tpp.check_rank_plan(cfg, _plan((2, 1), gb=3, vpp=2, schedule=IL))
    with pytest.raises(ValueError, match=r"stage tp \(2, 1\).*A5c"):
        tpp.check_rank_plan(cfg, _plan(tps=(2, 1)))
    tied = dataclasses.replace(cfg, tie_embeddings=True)
    with pytest.raises(ValueError, match="tied embeddings.*A5c"):
        tpp.check_rank_plan(tied, _plan())
    # falcon's plan runs on ranks (tests/test_torch_mamba_train.py); MoE
    # at dp > 1 raises A9c: a replica's aux is not JAX's batch aux
    tpp.check_rank_plan(treg.get_config("falcon-mamba-7b", smoke=True,
                                        num_layers=4), _plan())
    moe = treg.get_config("mixtral-8x7b", smoke=True, num_layers=4)
    tpp.check_rank_plan(moe, _plan())
    two = ParallelPlan(stages=tuple(StagePlacement(s, n, 2, 1, s == 1)
                                    for s, n in enumerate((3, 1))),
                       micro_bs=1, global_batch=8, seq_len=SEQ)
    with pytest.raises(ValueError, match="dp > 1 waits for .*item A9c"):
        tpp.check_rank_plan(moe, two)


def test_gpu_transport_on_a_shared_card_raises():
    """Two ranks that drive one card cannot use NCCL: the communicator
    names the host-staged transport instead of taking it."""
    shared = AxisGroup(None, (0, 1), ("h/cuda:0", "h/cuda:0"), nccl=True)
    with pytest.raises(ValueError, match="transport='cpu'"):
        shared.check_gpu("pod", "gpu")
    gloo = AxisGroup(None, (0, 1), ("h/cuda:0", "h/cuda:1"), nccl=False)
    with pytest.raises(ValueError, match="needs an NCCL process group"):
        gloo.check_gpu("pod", "rdma")
    AxisGroup(None, (0, 1), ("h/cuda:0", "h/cuda:1"), True).check_gpu(
        "pod", "ici")
    with pytest.raises(ValueError, match="unknown transport"):
        Communicator("pod", transport="cpu_staged")


def test_ranks_that_raise_end_the_run():
    """An interleaved plan of a ragged microbatch count raises on every
    rank; ``run_ranks`` raises with the ranks' message well within its
    timeout."""
    plan = _plan((2, 1), gb=3, vpp=2, schedule=IL)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="A5c"):
        run_ranks(rank_programs.trainer_steps, 2, timeout_s=TIMEOUT,
                  device="cpu",
                  args=(SMOKE4, plan.to_dict(), None, 1, OPT))
    assert time.monotonic() - t0 < TIMEOUT / 2


def test_a_blocked_rank_ends_within_its_timeout():
    """Rank 0 waits for a receive that rank 1 never sends: the run ends
    with an error by its timeout instead of hanging."""
    t0 = time.monotonic()
    with pytest.raises((RuntimeError, TimeoutError)):
        run_ranks(rank_programs.p2p_once, 2, timeout_s=5, device="cpu",
                  args=([[(1, 0)], []],))
    assert time.monotonic() - t0 < 5 + 10


def test_run_ranks_defaults_to_cuda(monkeypatch):
    """Asked for no device, the ranks want the card, as every entry point
    of the port does, and no process starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_ranks(rank_programs.p2p_once, 2, args=([[], []],))


def test_p2p_pairs_and_zeros():
    """Ranks pass only the pairs they are in; a rank that receives nothing
    gets zeros."""
    res = run_ranks(rank_programs.p2p_once, 3, timeout_s=_deadline(3),
                    device="cpu",
                    args=([[(0, 2)], [(1, 1)], [(0, 2)]],))
    np.testing.assert_array_equal(np.stack(res),
                                  [[0.0] * 4, [2.0] * 4, [1.0] * 4])


# ------------------------------------------ (f) bench_collectives -----
def test_bench_collectives_writes_the_jax_runners_entries(jax_comm):
    res = run_ranks(rank_programs.collectives, 2, timeout_s=TIMEOUT,
                    device="cpu",
                    args=((4096,),))

    def layout(entries):
        return [(e["op"], sorted(e["shape"]), sorted(e["value"]))
                for e in entries]

    want = layout(jax_comm["entries"])
    assert want[-2:] == [("link", ["scope"], ["gbps"]),
                         ("ring_hop", ["scope"], ["gbps"])]
    for entries in res:
        assert layout(entries) == want
        by_op = {e["op"]: e for e in entries}
        assert by_op["collective_psum"]["shape"] == {"nbytes": 2048,
                                                     "n_dev": 2}
        assert by_op["link"]["shape"] == {"scope": "intra"}
        assert all(e["value"]["gbps"] > 0 for e in entries)
        assert all(e["value"]["time_s"] > 0 for e in entries
                   if e["op"].startswith("collective"))
    # every rank writes the same numbers
    assert [e["value"] for e in res[0]] == [e["value"] for e in res[1]]


# --------------------------------------------------- (g) the CLI ----
CLI = ["--smoke", "--device", "cpu", "--pp", "2", "--global-batch", "4",
       "--seq", "16", "--steps", "2"]


def test_train_cli_under_torchrun(capsys, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *CLI,
         "--ckpt-dir", str(tmp_path / "ranks")],
        cwd=str(ROOT), env=env, capture_output=True, text=True,
        timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert sum(ln.startswith("[train] plan: pp=2 ") for ln in lines) == 1
    summary = json.loads(lines[-1])
    assert (summary["world"], summary["dp"], summary["pp"]) == (2, 1, 2)
    assert summary["transport"] == "gpu"
    assert summary["rank_peak_mem_gb"] == [None, None]
    # the one-process pipeline on the same plan, state and batches
    train_cli.main(CLI + ["--ckpt-dir", str(tmp_path / "one")])
    one = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert one["world"] == 1
    assert abs(summary["final_loss"] - one["final_loss"]) < F32_TOL


CLI_DP = ["--smoke", "--device", "cpu", "--global-batch", "4", "--seq",
          "16", "--steps", "2"]


def test_train_cli_under_torchrun_without_pp(capsys, tmp_path):
    """No ``--pp``: the two processes are dp 2 replicas of the reference
    loss, ZeRO-1 over ``data`` (the JAX CLI's plain route over its
    ``data`` axis), and reach the one-process CLI's loss."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         *CLI_DP, "--ckpt-dir", str(tmp_path / "ranks")], cwd=str(ROOT),
        env=env, capture_output=True, text=True,
        timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert not any(ln.startswith("[train] plan:") for ln in lines)
    summary = json.loads(lines[-1])
    assert (summary["world"], summary["dp"], summary["pp"]) == (2, 2, None)
    assert summary["transport"] == "gpu"
    assert summary["rank_peak_mem_gb"] == [None, None]
    train_cli.main(CLI_DP + ["--ckpt-dir", str(tmp_path / "one")])
    one = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (one["world"], one["dp"]) == (1, 1)
    assert abs(summary["final_loss"] - one["final_loss"]) < F32_TOL
