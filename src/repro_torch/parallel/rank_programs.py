"""Programs for ``launch.run_ranks``: what the tests and ``chip_smoke.py``
run on local ranks.

Each is a module-level function ``fn(rank, world, *args)`` (spawn pickles
it by name) that takes numpy or plain Python and returns the same, so a
rank imports nothing but ``repro_torch``.  The device is the one
``run_ranks`` set: the current CUDA device, or the CPU.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.plan import ParallelPlan, StagePlacement
from repro_torch.iccl import communicator
from repro_torch.iccl.communicator import Communicator
from repro_torch.kernels import ops
from repro_torch.models import registry
from repro_torch.optim.adamw import AdamWConfig, tree_leaves, tree_map
from repro_torch.parallel import groups, pipeline
from repro_torch.parallel.sharding import shard_tree, zero_dims
from repro_torch.profile import runner
from repro_torch.profile.store import ProfileStore
from repro_torch.train.trainer import Trainer, TrainerConfig


def _device() -> torch.device:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _torch_tree(tree, device):
    return tree_map(lambda a: torch.as_tensor(np.asarray(a)).to(device),
                    tree)


def _numpy_tree(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


class _Notes(list):
    """The ICCL tap's notes while installed (a ``with`` block)."""

    def __enter__(self):
        communicator.set_collective_sink(lambda *note: self.append(note))
        return self

    def __exit__(self, *exc):
        communicator.set_collective_sink(None)


def comm_ops(rank: int, world: int, xs: np.ndarray,
             split: int) -> Dict[str, np.ndarray]:
    """Every ``Communicator`` method over axis ``x`` (all ranks), rank r
    holding ``xs[r]``: iallreduce with and without ``compress``,
    iallgather tiled and stacked, ireducescatter, ialltoall of ``xs[r]``
    reshaped ``(world, -1)`` (split 1, concat 0), isend_irecv over a
    reversing permutation, and shift by 1 with and without ``wrap``.
    ``split`` is the length ireducescatter splits (a length that does not
    divide over the ranks makes this rank raise)."""
    groups.bind_world_axis("x", _device())
    comm = Communicator("x")
    x = torch.as_tensor(xs[rank]).to(_device())
    rev = [(i, world - 1 - i) for i in range(world)]
    out = {
        "iallreduce": comm.iallreduce(x),
        "iallreduce_compress": Communicator("x", compress=True).iallreduce(x),
        "iallgather": comm.iallgather(x),
        "iallgather_stacked": comm.iallgather(x, axis=0, tiled=False),
        "ireducescatter": comm.ireducescatter(x[:split]),
        "ialltoall": comm.ialltoall(x.reshape(world, -1), 1, 0),
        "isend_irecv": comm.isend_irecv(x, rev),
        "shift": comm.shift(x, 1),
        "shift_wrap": comm.shift(x, 1, wrap=True),
    }
    out = {k: v.cpu().numpy() for k, v in out.items()}
    out["index"], out["size"] = comm.index(), comm.size()
    return out


def p2p_once(rank: int, world: int, perms: Sequence[Sequence[Tuple[int, int]]]
             ) -> np.ndarray:
    """One ``isend_irecv`` of four ``rank + 1``s over axis ``x``, rank r
    passing ``perms[r]``: what it received."""
    groups.bind_world_axis("x", _device())
    x = torch.full((4,), rank + 1.0, device=_device())
    return Communicator("x").isend_irecv(x, perms[rank]).cpu().numpy()


def _loss_and_grads(world: int, bundle_kw: Dict[str, Any],
                    params: Dict[str, Any], batch: Dict[str, np.ndarray],
                    layers: Sequence[int], schedule: str, slack: int,
                    transport: str, tp: int, vpp: int = 1,
                    m: Optional[int] = None) -> Dict[str, Any]:
    """One case of ``pp_loss_and_grads`` on a one-replica grid of
    ``len(layers) / vpp`` stages of ``tp`` model ranks (``layers`` per
    virtual stage; ``m``: the batch's first m microbatches, None all; a
    pp 1 case takes the batch unmicrobatched, ``(B, S)``)."""
    if m is not None:
        batch = {k: v[:m] for k, v in batch.items()}
    bundle = registry.get_bundle(**bundle_kw)
    dev = _device()
    pp = len(layers) // vpp
    grid = groups.make_rank_grid(pp, 1, dev, tp=tp)
    tb = _torch_tree(batch, dev)
    rows = batch["tokens"].shape[-2]
    n = 1 if pp == 1 else batch["tokens"].shape[0]
    plan = ParallelPlan(
        stages=tuple(StagePlacement(s, sum(layers[s::pp]), 1, tp,
                                    s == pp - 1) for s in range(pp)),
        micro_bs=rows, global_batch=n * rows,
        seq_len=batch["tokens"].shape[-1], transport=transport,
        schedule=schedule, eager_slack=slack, vpp=vpp,
        chunk_layers=tuple(layers) if vpp > 1 else None)
    step = pipeline.PPRankStep(bundle.cfg, plan, grid)
    own = shard_tree(pipeline.stage_tree(_torch_tree(params, dev), layers,
                                         grid.stage, vpp),
                     step.rules, grid.model_rank)
    with _Notes() as notes:
        loss, grads = step.loss_and_grads(own, tb)
    if pp > 1:
        loss = step.pod.iallreduce(loss)
    return {"loss": float(loss), "grads": _numpy_tree(grads),
            "stage": grid.stage, "model_rank": grid.model_rank,
            "peak_inflight": step.peak_inflight, "order": step.order,
            "notes": list(notes)}


def pp_loss_and_grads(rank: int, world: int, bundle_kw: Dict[str, Any],
                      params: Dict[str, Any], batch: Dict[str, np.ndarray],
                      cases: Sequence[Tuple], transport: str = "gpu"
                      ) -> List[Dict[str, Any]]:
    """``PPRankStep.loss_and_grads`` of a pp = ``world`` pipeline, one
    replica, on the whole canonical ``params`` (numpy) and the microbatched
    ``batch`` ``(m, B_tick, S)``, for each case (virtual layers, schedule,
    eager slack[, vpp[, m]]) with its hops on ``transport``: the loss every
    rank reports, this rank's gradients, its in-flight peak and schedule,
    and the ICCL notes it made."""
    return [_loss_and_grads(world, bundle_kw, params, batch, case[0],
                            case[1], case[2], transport, 1, *case[3:])
            for case in cases]


def tp_loss_and_grads(rank: int, world: int,
                      cases: Sequence[Dict[str, Any]]
                      ) -> List[Dict[str, Any]]:
    """``pp_loss_and_grads`` for cases with tensor parallelism, each a dict
    of ``bundle_kw``, ``params``, ``batch``, ``layers`` (``world / tp``
    stages), ``schedule``, ``slack``, ``transport`` and ``tp``; each
    rank's gradients are its model rank's share of its stage."""
    return [_loss_and_grads(world, **case) for case in cases]


def trainer_steps(rank: int, world: int, bundle_kw: Dict[str, Any],
                  plan: Dict[str, Any], state: Dict[str, Any], steps: int,
                  opt: Dict[str, Any], tp: int = 0) -> Dict[str, Any]:
    """``steps`` ``Trainer`` steps on the rank route from the whole
    ``state`` (numpy), at ``TrainerConfig.tp`` ``tp`` (0: the plan's
    stage tp): the losses and gradient norms, and this rank's parameters
    and second moments afterwards."""
    bundle = registry.get_bundle(**bundle_kw)
    p = ParallelPlan.from_dict(plan)
    t = Trainer(bundle, TrainerConfig(global_batch=p.global_batch,
                                      seq_len=p.seq_len, tp=tp or p.tps[0]),
                plan=p, opt_cfg=AdamWConfig(**opt),
                state=(None if state is None
                       else _torch_tree(state, torch.device("cpu"))),
                device=_device())
    out = t.run(steps)
    return {"losses": out["losses"], "grad_norms": out["grad_norms"],
            "step": out["step"], "stage": t.grid.stage,
            "replica": t.grid.replica, "model_rank": t.grid.model_rank,
            "params": _numpy_tree(t.state["params"]),
            "v": _numpy_tree(t.state["opt"]["v"])}


def collectives(rank: int, world: int, payloads: Sequence[int]
                ) -> List[Dict[str, Any]]:
    """``profile.runner.bench_collectives`` on every rank into a store of
    its own: the entries written."""
    store = ProfileStore()
    runner.bench_collectives(store, "cpu", payloads, warmup=0, reps=1,
                             verbose=False, device=_device())
    return [e.to_dict() for e in store.entries()]


def _master_moves(state: Dict[str, Any], start: Dict[str, Any], dims: Any,
                  dp: int, replica: int) -> List[float]:
    def sq(p0, master, d):
        p0 = p0.to(master.device)
        if d is not None:
            p0 = p0.chunk(dp, d)[replica]
        return float(torch.sub(master, p0).square().sum(dtype=torch.float64))

    return tree_leaves(tree_map(sq, start, state["opt"]["master"], dims))


def run_steps(t: Trainer, steps: int, moves: bool = False
              ) -> Tuple[Dict[str, List[float]], List[List[float]]]:
    """``t.run(steps)`` one step at a time: (the losses, gradient norms
    and step times; with ``moves``, after every step each leaf's squared
    norm of its fp32 master's move from the bf16 parameters the run began
    from, over this rank's ZeRO-1 slice, so that the replicas' values sum
    to the whole leaf's).  The start is kept in host memory, so the
    card's peak is the run's own."""
    params = t.state["params"]
    dp, replica = (t.grid.dp, t.grid.replica) if t.grid else (1, 0)
    dims = (zero_dims(params, t.train_step.rules, dp) if dp > 1
            else tree_map(lambda _: None, params))
    start = tree_map(lambda x: x.cpu(), params) if moves else None
    out: Dict[str, List[float]] = {"losses": [], "grad_norms": [],
                                   "step_s": []}
    moved = []
    for _ in range(steps):
        ran = t.run(1)
        for k, v in out.items():
            v += ran[k]
        if moves:
            moved.append(_master_moves(t.state, start, dims, dp, replica))
    return out, moved


def pp_train(rank: int, world: int, bundle_kw: Dict[str, Any],
             plan: Dict[str, Any], steps: int,
             opt: Optional[Dict[str, Any]] = None,
             moves: bool = False) -> Dict[str, Any]:
    """``steps`` ``Trainer`` steps of a plan on the rank route from a fresh
    state (seed 0; ``opt``: the ``AdamWConfig`` fields, None its
    defaults), with what this rank saw: the losses, gradient norms and
    step times, its kernel launches, the ICCL notes, its in-flight peak,
    its state's bytes (parameters; optimizer state, and of that the
    leaves ZeRO-1 keeps whole), its leaves and how many ZeRO-1 splits, and
    its state and peak memory (GB, on the card); with ``moves``,
    ``run_steps``'s moves of its fp32 master.  At dp > 1, whether its
    parameters equal every other replica's bit for bit after the run
    (gathered over ``data``)."""
    dev = _device()
    bundle = registry.get_bundle(**bundle_kw)
    p = ParallelPlan.from_dict(plan)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    t = Trainer(bundle, TrainerConfig(global_batch=p.global_batch,
                                      seq_len=p.seq_len, tp=p.tps[0]),
                plan=p, opt_cfg=AdamWConfig(**(opt or {})), device=dev)
    if cuda:
        torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    state_gb = torch.cuda.memory_allocated(dev) / 1e9 if cuda else None
    ops.reset_launch_counts()
    with _Notes() as notes:
        out, moved = run_steps(t, steps, moves)
    launches = ops.launch_counts()
    params = t.state["params"]
    dp = t.grid.dp
    dims = (zero_dims(params, t.train_step.rules, dp) if dp > 1
            else tree_map(lambda _: None, params))
    same = None
    if dp > 1:
        data = t.train_step.data
        same = all(all(torch.equal(x, part) for part in
                       data.iallgather(x, tiled=False).unbind(0))
                   for x in tree_leaves(params))
    opt_state = {k: v for k, v in t.state["opt"].items() if k != "count"}
    whole = tree_map(lambda _, d: d is None, params, dims)
    return {"rank": rank, "stage": t.grid.stage, "replica": t.grid.replica,
            "model_rank": t.grid.model_rank, **out, "launches": launches,
            "notes": list(notes), "peak_inflight": t.train_step.peak_inflight,
            "order": t.train_step.order, "init_s": init_s,
            "master_moves": moved, "replicas_equal": same,
            "n_params": sum(x.numel() for x in tree_leaves(params)),
            "n_leaves": len(tree_leaves(params)),
            "n_zero_split": tree_leaves(whole).count(False),
            "param_bytes": _nbytes(params), "opt_trees": sorted(opt_state),
            "opt_bytes": _nbytes(opt_state),
            "opt_whole_bytes": sum(
                a.numel() * a.element_size() for o in opt_state.values()
                for a, w in zip(tree_leaves(o), tree_leaves(whole)) if w),
            "state_gb": state_gb,
            "peak_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                        if cuda else None)}


def hop_times(rank: int, world: int, shape: Sequence[int], dtype: str,
              transport: str, reps: int) -> Dict[str, Any]:
    """One-way hop times of a ``shape`` tensor of ``dtype`` between ranks
    0 and 1 over axis ``pod`` on ``transport``, from ``reps`` round trips
    timed on rank 0 (host clock, the card synchronized), after two
    untimed; and whether every hop copied the tensor bit for bit."""
    dev = _device()
    groups.make_rank_grid(world, 1, dev)
    comm = Communicator("pod", transport)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    x = torch.randn(tuple(shape), generator=gen, device=dev).to(
        getattr(torch, dtype))
    exact, times = True, []
    for i in range(reps + 2):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        y = comm.isend_irecv(x, [(0, 1)])       # rank 0 -> 1
        y = comm.isend_irecv(y if rank == 1 else x, [(1, 0)])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if i >= 2:
            times.append((time.perf_counter() - t0) / 2)
        exact = exact and (rank != 0 or torch.equal(y, x))
    return {"rank": rank, "hop_s": times, "exact": exact,
            "nbytes": x.numel() * x.element_size()}


def allreduce_times(rank: int, world: int, shape: Sequence[int], dtype: str,
                    transport: str, reps: int) -> Dict[str, Any]:
    """Times of one ``iallreduce`` of a ``shape`` tensor of ``dtype`` over
    a ``model`` axis of every rank on ``transport``, ``reps`` calls timed
    on each rank (host clock, the card synchronized) after two untimed;
    and whether every sum was exact (each rank adds ``rank + 1`` times
    one tensor of small integers)."""
    dev = _device()
    groups.make_rank_grid(1, 1, dev, tp=world)
    comm = Communicator("model", transport)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    x = torch.randint(-4, 5, tuple(shape), generator=gen, device=dev).to(
        getattr(torch, dtype))
    mine, want = x * (rank + 1), x * (world * (world + 1) // 2)
    exact, times = True, []
    for i in range(reps + 2):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        y = comm.iallreduce(mine)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if i >= 2:
            times.append(time.perf_counter() - t0)
        exact = exact and torch.equal(y, want)
    return {"rank": rank, "s": times, "exact": exact,
            "nbytes": x.numel() * x.element_size()}


def layer_probes(rank: int, world: int, arch: str, seqs: Sequence[int],
                 micro_bss: Sequence[int], warmup: int, reps: int,
                 smoke: bool, transport: str):
    """``profile.runner.probe_times`` of the tensor-parallel loss on a
    ``model`` axis of every rank over ``transport``: this rank's times."""
    dev = _device()
    groups.make_rank_grid(1, 1, dev, tp=world)
    return runner.probe_times(arch, seqs, micro_bss, warmup, reps, smoke,
                              dev, model=Communicator("model", transport))
