"""Programs for ``launch.run_ranks``: what the tests and ``chip_smoke.py``
run on local ranks.

Each is a module-level function ``fn(rank, world, *args)`` (spawn pickles
it by name) that takes numpy or plain Python and returns the same, so a
rank imports nothing but ``repro_torch``.  The device is the one
``run_ranks`` set: the current CUDA device, or the CPU.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import cluster as C
from repro_torch.core.cluster import cli_cluster, cli_search_kw
from repro_torch.core.plan import ParallelPlan, StagePlacement
from repro_torch.iccl import communicator
from repro_torch.iccl.communicator import Communicator
from repro_torch.kernels import ops
from repro_torch.models import registry
from repro_torch.optim.adamw import AdamWConfig, tree_leaves, tree_map
from repro_torch.parallel import groups, pipeline
from repro_torch.parallel.sharding import _at, shard_tree, zero_dims
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
    """numpy copies of the leaves, bf16 widened to fp32 (exact)."""
    return tree_map(lambda t: t.detach().to(
        "cpu", torch.float32 if t.dtype == torch.bfloat16 else t.dtype,
        copy=True).numpy(), tree)


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


def cp_loss_and_grads(rank: int, world: int,
                      cases: Sequence[Dict[str, Any]]
                      ) -> List[Dict[str, Any]]:
    """``PPRankStep.loss_and_grads`` of pp 1 cp plans on ``world`` ranks
    of ``cp`` ring ranks and ``tp`` model ranks each (one data group),
    for each case, a dict of ``bundle_kw``, ``params`` (the whole
    canonical tree, numpy), ``batch`` ``(B, S)``, ``chunks`` (the ring's),
    ``tp`` and optionally ``transport`` (default "gpu"; two ranks on one
    card take "cpu"): this rank's part of the loss and the sum over
    ``pod`` (the whole loss), its gradients summed over ``pod`` (its
    model rank's share of the whole gradient), its place and the ICCL
    notes it made."""
    out = []
    dev = _device()
    for case in cases:
        bundle = registry.get_bundle(**case["bundle_kw"])
        chunks, tp = tuple(case["chunks"]), case["tp"]
        cp = len(chunks)
        batch = case["batch"]
        rows, seq = batch["tokens"].shape
        plan = ParallelPlan(
            stages=(StagePlacement(0, bundle.cfg.num_layers, cp, tp, True),),
            micro_bs=rows, global_batch=rows, seq_len=seq, cp=cp,
            cp_chunks=chunks, transport=case.get("transport", "gpu"))
        grid = groups.make_rank_grid(1, 1, dev, tp=tp, cp=cp)
        step = pipeline.PPRankStep(bundle.cfg, plan, grid)
        own = shard_tree(_torch_tree(case["params"], dev), step.rules,
                         grid.model_rank)
        with _Notes() as notes:
            part, grads = step.loss_and_grads(own, _torch_tree(batch, dev))
        grads = tree_map(step.pod.iallreduce, grads)
        out.append({"part": float(part),
                    "loss": float(step.pod.iallreduce(part)),
                    "grads": _numpy_tree(grads), "ring": grid.ring,
                    "model_rank": grid.model_rank, "notes": list(notes)})
        groups.destroy_rank_grid(grid)
    return out


def ring_ranks_attention(rank: int, world: int, q: np.ndarray,
                         k: np.ndarray, v: np.ndarray, dout: np.ndarray,
                         chunks: Sequence[int]) -> Dict[str, np.ndarray]:
    """``ops.ring_attention_ranks`` of ring rank ``rank`` over a ``pod``
    axis of every rank: this rank's chunk of the whole ``(B, S, h, hd)``
    q, k, v, padded to the largest chunk, its output and the gradients of
    ``sum(o * dout)`` for its chunk of q, k and v (pad rows dropped)."""
    groups.make_rank_grid(1, 1, _device(), cp=world)
    pod = Communicator("pod")
    lo = sum(chunks[:rank])
    n, cmax = chunks[rank], max(chunks)

    def mine(a):
        t = torch.as_tensor(a[:, lo:lo + n]).to(_device())
        return torch.nn.functional.pad(
            t, (0, 0, 0, 0, 0, cmax - n))[None].requires_grad_()

    qc, kc, vc = mine(q), mine(k), mine(v)
    with _Notes() as notes:
        o = ops.ring_attention_ranks(
            qc, kc, vc, chunks, rank,
            lambda x: pod.shift(x, 1, wrap=True))
        dq, dk, dv = torch.autograd.grad(
            o, (qc, kc, vc), grad_outputs=mine(dout).detach())
    return {"o": o.detach()[0, :, :n].cpu().numpy(),
            **{name: g[0, :, :n].cpu().numpy()
               for name, g in (("dq", dq), ("dk", dk), ("dv", dv))},
            "notes": list(notes)}


def _opt_stats(params: Dict[str, Any], opt: Dict[str, Any],
               dims: Any) -> Dict[str, Any]:
    """A rank's state sizes: its parameters, its optimizer trees and
    their bytes, and of those the leaves that ZeRO-1 keeps whole."""
    opt_state = {k: v for k, v in opt.items() if k != "count"}
    whole = tree_map(lambda _, d: d is None, params, dims)
    return {"n_params": sum(x.numel() for x in tree_leaves(params)),
            "n_leaves": len(tree_leaves(params)),
            "n_zero_split": tree_leaves(whole).count(False),
            "param_bytes": _nbytes(params), "opt_trees": sorted(opt_state),
            "opt_bytes": _nbytes(opt_state),
            "opt_whole_bytes": sum(
                a.numel() * a.element_size() for o in opt_state.values()
                for a, w in zip(tree_leaves(o), tree_leaves(whole)) if w)}


def _zero_dims_of(t: Trainer) -> Any:
    params, dp = t.state["params"], t.grid.dp
    return (zero_dims(params, t.train_step.rules, dp) if dp > 1
            else tree_map(lambda _: None, params))


def _equal_over(comm: Communicator, params: Dict[str, Any]) -> bool:
    """Whether every rank of ``comm``'s axis holds ``params`` bit for
    bit."""
    return all(all(torch.equal(x, part) for part in
                   comm.iallgather(x, tiled=False).unbind(0))
               for x in tree_leaves(params))


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
            "ring": t.grid.ring, "params": _numpy_tree(t.state["params"]),
            "v": _numpy_tree(t.state["opt"]["v"]),
            **_opt_stats(t.state["params"], t.state["opt"],
                         _zero_dims_of(t))}


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
             moves: bool = False, ckpt_dir: Optional[str] = None,
             ckpt_every: int = 10, start_step: int = 0, after: int = 0,
             states: bool = False,
             replan: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """``steps`` ``Trainer`` steps of a plan on the rank route from a fresh
    state (seed 0) or a checkpoint (below; ``opt``: the ``AdamWConfig``
    fields, None its defaults), with what this rank saw: the losses,
    gradient norms and step times, its kernel launches, the ICCL notes, its
    in-flight peak, its state's bytes (parameters; optimizer state, and of
    that the leaves ZeRO-1 keeps whole), its leaves and how many ZeRO-1
    splits, and its state and peak memory (GB, on the card); with
    ``moves``, ``run_steps``'s moves of its fp32 master.  At dp > 1, whether
    its parameters equal every other replica's bit for bit after the run
    (gathered over ``data``); at cp > 1, whether they equal its ring's
    (over ``pod``).  With ``ckpt_dir``, the trainer starts from
    the latest checkpoint there, which must be of step ``start_step`` (no
    checkpoint: 0), saves there every ``ckpt_every`` steps, and ``ckpt``
    holds the last save's timings.  ``after`` more steps follow the run,
    outside its launch counts, notes and step times (``after_losses``,
    ``after_step_s``).  With ``states``, this rank's state (numpy, bf16
    widened to fp32) at the start, after the run and after the ``after``
    steps.  With ``replan`` (``replan_after_run``'s arguments), the trainer
    runs with the train CLI's cluster and a profile store, and replans
    between the run and the ``after`` steps (``replanned``)."""
    dev = _device()
    bundle = registry.get_bundle(**bundle_kw)
    p = ParallelPlan.from_dict(plan)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    t = Trainer(bundle, TrainerConfig(global_batch=p.global_batch,
                                      seq_len=p.seq_len, tp=p.tps[0],
                                      ckpt_dir=ckpt_dir,
                                      ckpt_every=ckpt_every),
                plan=p, opt_cfg=AdamWConfig(**(opt or {})), device=dev,
                cluster=cli_cluster() if replan is not None else None,
                profile_store=ProfileStore() if replan is not None else None)
    if t.step != start_step:
        raise ValueError(f"{ckpt_dir}: started at step {t.step}, not "
                         f"{start_step}")
    if cuda:
        torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    state_gb = torch.cuda.memory_allocated(dev) / 1e9 if cuda else None
    kept = [_numpy_tree(t.state)] if states else []
    ops.reset_launch_counts()
    with _Notes() as notes:
        out, moved = run_steps(t, steps, moves)
    launches = ops.launch_counts()
    ckpt = dict(t.ckpt.timings) if t.ckpt is not None else None
    if states:
        kept.append(_numpy_tree(t.state))
    params = t.state["params"]
    stats = _opt_stats(params, t.state["opt"], _zero_dims_of(t))
    same = (_equal_over(t.train_step.data, params) if t.grid.dp > 1
            else None)
    ring_same = (_equal_over(t.train_step.pod, params) if t.grid.cp > 1
                 else None)
    replanned = (replan_after_run(t, **replan) if replan is not None
                 else None)
    later = t.run(after)
    if states:
        kept.append(_numpy_tree(t.state))
    return {"rank": rank, "stage": t.grid.stage, "replica": t.grid.replica,
            "model_rank": t.grid.model_rank, "ring": t.grid.ring, **out,
            "launches": launches, "notes": list(notes),
            "peak_inflight": t.train_step.peak_inflight,
            "order": t.train_step.order, "init_s": init_s,
            "master_moves": moved, "replicas_equal": same,
            "ring_equal": ring_same, **stats, "state_gb": state_gb,
            "peak_gb": (max(torch.cuda.max_memory_allocated(dev) / 1e9,
                            (replanned or {}).get("peak_gb_before") or 0.0)
                        if cuda else None),
            "ckpt": ckpt, "after_losses": later["losses"],
            "after_step_s": later["step_s"], "states": kept,
            "replanned": replanned}


def replan_after_run(t: Trainer, kind: str, factor: float,
                     search_kw: Dict[str, Any]) -> Dict[str, Any]:
    """``t.replan`` onto the train CLI's cluster with ``kind`` degraded by
    ``factor``, searched with ``search_kw``, the state moved in memory:
    what the trainer observed before (the gathered stage ticks, the
    bubble, ``schedule_health``, its profile store's entries), the plan
    and the search's log, the seconds of the search and of ``_adopt``, the
    move's bytes and seconds, and this rank's memory after it.  Every box
    the move received from another rank is held against the checkpoint of
    this step in ``t.cfg.ckpt_dir`` bit for bit: ``unequal`` names the
    leaves that differ."""
    dev = t.device
    cuda = dev.type == "cuda"
    before = {"stage_ticks": t._stage_tick_obs(),
              "bubble": t.telemetry.bubble() if t.telemetry else None,
              "health": t.schedule_health(),
              "entries": [e.to_dict() for e in t.profile_store.entries()],
              "profiled": t.profiled_cost_source(
                  t.cluster.degrade(kind, factor)) is not None}
    peak_before = None
    if cuda:    # the move's own peak; ``pp_train`` keeps the run's
        peak_before = torch.cuda.max_memory_allocated(dev) / 1e9
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res = t.plan_for(t.cluster.degrade(kind, factor),
                     global_batch=t.cfg.global_batch,
                     seq_len=t.cfg.seq_len, **search_kw)
    search_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    t._adopt(res, t.cluster.degrade(kind, factor))
    adopt_s = time.perf_counter() - t1
    mig = dict(t.last_migration or {})
    moved = mig.pop("moved", [])
    t2 = time.perf_counter()
    unequal = _compare_with_checkpoint(t, moved)
    compare_s = time.perf_counter() - t2
    # the ranks compare apart; the next step starts on all at once
    torch.distributed.barrier()
    return {"plan": res.plan.describe(), "plan_dict": res.plan.to_dict(),
            "rank_plan": t.run_plan.describe(),
            "log": [list(x) for x in res.log],
            "baseline_time": res.baseline_time,
            "iter_time": res.prediction.iter_time,
            "search_s": search_s, "adopt_s": adopt_s, "migration": mig,
            "moved_boxes": len(moved), "unequal": unequal,
            "compare_s": compare_s,
            "stage": t.grid.stage, "migrations": dict(t.migrations),
            "replans": t.replans, **before,
            "n_params_after": sum(x.numel() for x in
                                  tree_leaves(t.state["params"])),
            "mem_gb_after": (torch.cuda.memory_allocated(dev) / 1e9
                             if cuda else None),
            "peak_gb_move": (torch.cuda.max_memory_allocated(dev) / 1e9
                             if cuda else None),
            "peak_gb_before": peak_before}


def _compare_with_checkpoint(t: Trainer, moved) -> List[str]:
    """The leaves of ``t.state`` whose boxes in ``moved`` (``(path, box in
    the leaf, box in the whole)``) are unequal, bit for bit, to the
    checkpoint of ``t.step``, read from it one box at a time."""
    from repro_torch.ckpt import checkpoint as ckpt
    bad = set()
    for path, box, whole in moved:
        got = ckpt.read_box(t.cfg.ckpt_dir, t.step, "/".join(path), whole)
        x = _at(t.state, path)[box].cpu()
        if not (x.dtype == got.dtype and torch.equal(x, got)):
            bad.add("/".join(path))
    return sorted(bad)


def _unequal(got, want) -> List[str]:
    """The leaves of ``got`` not equal bit for bit to ``want``'s (on the
    host)."""
    from repro_torch.parallel.migrate import _flat
    ys = _flat(want)
    return sorted("/".join(p) for p, x in _flat(got).items()
                  if not (x.dtype == ys[p].dtype
                          and torch.equal(x.cpu(), ys[p].cpu())))


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


def migrate_cases(rank: int, world: int, bundle_kw: Dict[str, Any],
                  whole: Dict[str, Any], cases: Sequence[Tuple],
                  ckpt_dir: str) -> List[Dict[str, Any]]:
    """For each (old plan, new plan) of ``cases`` (dicts): this rank's
    part of the whole state ``whole`` (numpy, bf16 leaves widened) under
    the old plan, written as one ``save_rank`` checkpoint by every rank
    and moved by ``migrate.redistribute`` onto the new plan: the moved
    state (numpy), the leaves unequal to this rank's ``restore_rank`` of
    the checkpoint under the new plan, and the bytes sent and received."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.parallel import migrate
    from repro_torch.parallel.sharding import ShardingRules
    from repro_torch.train import steps as steps_mod
    bundle = registry.get_bundle(**bundle_kw)
    meta = steps_mod.train_state_shapes(bundle)
    state = tree_map(lambda a, m: torch.as_tensor(np.asarray(a)).to(m.dtype),
                     whole, meta)
    out = []
    for i, (old_d, new_d) in enumerate(cases):
        old, new = ParallelPlan.from_dict(old_d), ParallelPlan.from_dict(new_d)
        rules = [ShardingRules(bundle.cfg, tp=p.tps[0]) for p in (old, new)]
        stage, replica, mr = migrate.rank_coords(old, rank)
        mine = pipeline.split_state_for_rank(state, old, stage, rules[0], mr,
                                             replica=replica)
        d = f"{ckpt_dir}/case{i}"
        part = ckpt.RankPart(migrate.plan_slices(meta, old, rules[0], rank),
                             meta, rank, world)
        ckpt.save_rank(d, 1, mine, part)
        torch.distributed.barrier()     # rank 0 renamed the checkpoint
        moved, stats = migrate.redistribute(mine, meta, old, new, bundle.cfg,
                                            torch.device("cpu"), "cpu")
        want, _ = ckpt.restore_rank(
            d, 1, migrate.plan_slices(meta, new, rules[1], rank))
        out.append({"state": _numpy_tree(moved),
                    "unequal_to_checkpoint": _unequal(moved, want),
                    "sent_bytes": stats["sent_bytes"],
                    "recv_bytes": stats["recv_bytes"]})
    return out


def _card_used_gb(dev: torch.device) -> Optional[float]:
    """The card's memory in use, the caching allocator's and NCCL's
    buffers included (None on the CPU)."""
    if dev.type != "cuda":
        return None
    torch.cuda.synchronize(dev)
    free, total = torch.cuda.mem_get_info(dev)
    return (total - free) / 1e9


def replan_cases(rank: int, world: int, bundle_kw: Dict[str, Any],
                 plan: Dict[str, Any], ckpt_dir: str) -> Dict[str, Any]:
    """The rank route's closed loop on ``plan``: 2 steps with telemetry
    off (their ICCL notes), 2 with the train CLI's cluster and a store
    (their notes, the store's entries, the gathered stage ticks and
    bubble, ``schedule_health`` and the plan the ranks run), a replan off
    gpu-a slowed 4x moved in memory (the process groups alive and the
    card's memory in use before and after), and one step on the new plan beside one step of a fresh rank
    trainer of the new plan on the gathered state; then a replan onto a
    3-stage plan of a 3-accelerator cluster, which must raise
    (``world_error``)."""
    from repro_torch.parallel.sharding import ShardingRules
    bundle = registry.get_bundle(**bundle_kw)
    p = ParallelPlan.from_dict(plan)
    dev = _device()
    cfg = TrainerConfig(global_batch=p.global_batch, seq_len=p.seq_len)
    off = Trainer(bundle, dataclasses.replace(cfg, telemetry="off"), plan=p,
                  device=dev)
    with _Notes() as notes_off:
        off.run(2)
    del off
    t = Trainer(bundle, cfg, plan=p, device=dev, cluster=cli_cluster(),
                profile_store=ProfileStore())
    with _Notes() as notes:
        t.run(2)
    entries = sorted(
        (e.device_kind, e.op, json.dumps(e.shape, sort_keys=True),
         json.dumps(e.value, sort_keys=True), e.meta.get("telemetry"),
         e.meta.get("provenance")) for e in t.profile_store.entries())
    ticks, bubble = t._stage_tick_obs(), t.telemetry.bubble()
    health, run_plan = t.schedule_health(), t.run_plan.to_dict()
    n_groups = len(torch.distributed.distributed_c10d._world.pg_map)
    used = _card_used_gb(dev)
    t.replan(t.cluster.degrade("gpu-a", 4.0), global_batch=p.global_batch,
             seq_len=p.seq_len, **cli_search_kw(p.pp))
    n_groups = (n_groups,
                len(torch.distributed.distributed_c10d._world.pg_map))
    used = (used, _card_used_gb(dev))
    parts: List[Any] = [None] * world
    torch.distributed.all_gather_object(parts, _numpy_tree(t.state))
    rplan = t.train_step.plan
    whole = pipeline.gather_rank_states(
        [_torch_tree(s, torch.device("cpu")) for s in parts],
        ShardingRules(bundle.cfg, tp=rplan.tps[0]), rplan)
    nxt = t.run(1)["losses"]
    fresh = Trainer(bundle, cfg, plan=t.plan, state=whole, device=dev)
    fresh_losses = fresh.run(1)["losses"]
    big = C.ClusterSpec(groups=(C.NodeGroup(C.AMD, 1, accel_per_node=2),
                                C.NodeGroup(C.GPU_A, 1, accel_per_node=1)))
    err = None
    try:
        # no baseline: the incumbent of 2 stages could win on 3 devices
        t.replan(big, global_batch=p.global_batch, seq_len=p.seq_len,
                 baseline_plan=None, **cli_search_kw(3))
    except ValueError as e:
        err = str(e)
    return {"notes": list(notes), "notes_off": list(notes_off),
            "entries": entries, "stage_ticks": ticks, "bubble": bubble,
            "health": health, "run_plan": run_plan, "n_groups": n_groups,
            "card_used_gb": used,
            "plan": t.plan.describe(), "migrations": dict(t.migrations),
            "next_losses": nxt, "fresh_losses": fresh_losses,
            "world_error": err}


def elastic_ranks(rank: int, world: int, bundle_kw: Dict[str, Any],
                  plan: Dict[str, Any], cluster: Sequence[Dict[str, Any]],
                  search_kw: Dict[str, Any], script: Sequence[Any],
                  ckpt_dir: Optional[str] = None,
                  lr: float = 3e-4) -> Dict[str, Any]:
    """A rank trainer on ``plan`` and ``cluster`` (its groups' ``to_dict``)
    under the aggregator over the ranks, its membership searches
    constrained by ``search_kw``, driven by ``script``: ``(steps, op,
    kind, mark)`` runs ``steps`` steps, then tells every rank ``op``
    ("lose", "join" or None) of island ``kind`` (``mark``: the aggregator
    rank passed along).  After each run: this rank's losses, its grid
    (None outside the plan), the plan the ranks run, the adaptation
    events so far, the process groups alive, this rank's state (numpy;
    None outside the plan) and, when the run moved the state, the move's
    stats and, with ``ckpt_dir``, the leaves of this rank's state unequal
    bit for bit to ``split_state_for_rank`` of the checkpoint of the move's
    step (``_adopt`` writes it before moving)."""
    from repro_torch.adapt import ProcessAllGatherAggregator
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.parallel.sharding import ShardingRules
    from repro_torch.train import steps as steps_mod
    bundle = registry.get_bundle(**bundle_kw)
    p = ParallelPlan.from_dict(plan)
    dev = _device()
    agg = ProcessAllGatherAggregator()
    t = Trainer(bundle, TrainerConfig(global_batch=p.global_batch,
                                      seq_len=p.seq_len, ckpt_dir=ckpt_dir,
                                      ckpt_every=1000,
                                      replan_profile_min_obs=4),
                plan=p, opt_cfg=AdamWConfig(lr=lr), device=dev,
                cluster=C.ClusterSpec(groups=tuple(
                    C.NodeGroup.from_dict(g) for g in cluster)),
                profile_store=ProfileStore(), aggregator=agg,
                adapt_search_kw=search_kw)
    pg_map = torch.distributed.distributed_c10d._world.pg_map
    out: List[Dict[str, Any]] = []
    for steps, op, kind, mark in script:
        last = t.last_migration
        r = t.run(steps)
        rec: Dict[str, Any] = {
            "losses": r["losses"], "step": t.step,
            "grid": (None if t.grid is None else
                     [t.grid.stage, t.grid.replica, t.grid.rank,
                      list(t.grid.ranks)]),
            "run_plan": t.run_plan.to_dict(), "plan": t.plan.describe(),
            "events": [e.to_dict() for e in t.adapt_log],
            "n_groups": len(pg_map), "leader": agg.leader_rank(),
            "state": None if t.state is None else _numpy_tree(t.state),
            "migrations": dict(t.migrations)}
        if t.last_migration is not last:
            mig = dict(t.last_migration)
            moved = mig.pop("moved", [])
            rec["move"] = {**mig, "boxes": len(moved)}
            if ckpt_dir and t.state is not None:
                whole = steps_mod.train_state_shapes(bundle)
                full, _ = ckpt.restore_rank(
                    ckpt_dir, t.step, pipeline.rank_leaf_slices(
                        whole, [bundle.cfg.num_layers], 0),
                    torch.device("cpu"))
                g, rplan = t.grid, t.run_plan
                want = pipeline.split_state_for_rank(
                    full, rplan, g.stage, ShardingRules(bundle.cfg,
                                                        tp=rplan.tps[0]),
                    g.model_rank, replica=g.replica)
                rec["unequal"] = _unequal(t.state, want)
        out.append(rec)
        if op == "lose":
            t.lose_node(kind, rank=mark)
        elif op == "join":
            t.join_node(kind, rank=mark)
    return {"records": out}


def aggregate_ranks(rank: int, world: int,
                    entries: Sequence[Sequence[Any]]) -> Dict[str, Any]:
    """``adapt.ProcessAllGatherAggregator`` on the ranks: this rank's store
    of ``entries[rank]`` (``(device kind, op, shape, value, meta)`` puts), its
    wire payload, the entries of its gathered view, and three broadcasts
    — from rank 0, of None, and from rank 1 once rank 0 is lost — with
    the leader before and after the loss."""
    from repro_torch.adapt import ProcessAllGatherAggregator
    a = ProcessAllGatherAggregator()
    store = ProfileStore()
    for dev, op, shape, value, meta in entries[rank]:
        store.put(dev, op, shape, value, meta=meta)
    view = a.gather(store)
    leaders = [a.leader_rank()]
    got = [a.broadcast({"from": 0} if rank == 0 else None),
           a.broadcast(None)]
    a.lose_rank(0)
    leaders.append(a.leader_rank())
    got.append(a.broadcast({"from": rank} if a.is_leader() else None))
    return {"wire": a._encode(store), "directives": got, "leaders": leaders,
            "entries": sorted(
                (e.device_kind, e.op, json.dumps(e.shape, sort_keys=True),
                 json.dumps(e.value, sort_keys=True))
                for e in view.entries())}
