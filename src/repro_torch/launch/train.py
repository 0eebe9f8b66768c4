"""Training CLI (port of the plain and ``--pp`` routes of
``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --layers 4 \
        --seq 4096 --global-batch 1
    PYTHONPATH=src python -m repro_torch.launch.train --layers 4 \
        --seq 4096 --global-batch 4 --pp 2
    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \
        -m repro_torch.launch.train --smoke --device cpu --pp 2
    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \
        -m repro_torch.launch.train --smoke --device cpu

Trains ``--arch`` (random weights from seed 0) on the synthetic token
pipeline with AdamW (``--lr``, 20 warmup steps, as the JAX CLI) on
``--device`` (default ``cuda``; no silent fall back to the CPU), through
the reference loss.  ``--pp N`` asks the planner for an N-stage plan on
the JAX CLI's two-kind cluster (one AMD and one GPU-A accelerator; tp 1,
micro_bs 1 or 2), prints it as ``[train] plan: ...`` and trains through
its pipeline on this one device.  Under ``torchrun`` (``WORLD_SIZE`` > 1)
each process is one rank: it joins the process group (gloo, with NCCL
beside it when the transport is a card's on the cards), runs on
``cuda:LOCAL_RANK % device_count`` (or the CPU with ``--device cpu``)
and holds its part of the state, at dp > 1 only its replica's ZeRO-1
slice of the AdamW moments and master.  Without ``--pp`` the processes
are ``WORLD_SIZE`` data-parallel replicas of the reference loss, each on
its rows of the batch, the JAX CLI's plain route over a ``("data",
"model")`` mesh of ``(n_dev, 1)`` (transport ``gpu``); with ``--pp`` they
hold the plan's stages (the interleaved plans included) times dp =
``WORLD_SIZE / pp`` replicas, the stages hopping over the plan's
transport.  The search's cluster has one accelerator of each kind, so its
plan places dp 1 a stage; with dp > 1 each stage is widened to dp
replicas of the same microbatch size.  The cp ring is reached, as in the
JAX package, through ``Trainer(plan=...)``.  Rank 0 prints ``[train]
step=.. loss=.. tok/s=..`` every ``LOG_EVERY`` steps and, last, a JSON
summary (with its start step and step times, and every rank's losses and
peak memory under torchrun).

Checkpoints as in the JAX CLI: ``--ckpt-dir`` (default ``repro_train``
in the temporary directory, ``$TMPDIR`` or the JAX CLI's
``/tmp/repro_train``) gets one every ``--ckpt-every`` steps (default 50),
written in the background; a run starts from the latest one there, prints
``start_step=``, and then takes ``--steps`` more.  Under ``torchrun``
every rank writes its own part of one checkpoint in the same directory,
and any plan, any world size or one process resumes from it.  Left for
ROADMAP A6b and A6c: ``--degrade``, ``--adapt``, ``--lose``/``--join``,
telemetry and observability.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.core import cluster as cluster_mod
from repro_torch.core import planner
from repro_torch.kernels import ops
from repro_torch.models import registry
from repro_torch.optim.adamw import AdamWConfig, tree_leaves
from repro_torch.train.trainer import (PLAIN_TRANSPORT, Trainer,
                                       TrainerConfig)
from repro_torch.utils.device import resolve_device

LOG_EVERY = 10


def search_plan(cfg, pp: int, global_batch: int, seq_len: int):
    """The planner's best ``pp``-stage plan for this workload on the JAX
    CLI's cluster (one AMD and one GPU-A node, one accelerator each),
    searched as the JAX CLI searches (``repro/launch/train.py:182-195``)."""
    cluster = cluster_mod.ClusterSpec(groups=(
        cluster_mod.NodeGroup(cluster_mod.AMD, 1, accel_per_node=1),
        cluster_mod.NodeGroup(cluster_mod.GPU_A, 1, accel_per_node=1)))
    return planner.search(
        cluster, cfg, global_batch=global_batch, seq_len=seq_len,
        pp_options=[pp], tp_options=[1], micro_bs_options=[1, 2],
        require_fit=False, include_tp_comm=False).plan


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3-8b", choices=registry.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--layers", type=int, default=0,
                    help="override the arch's layer count (0 = default)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--pp", type=int, default=0,
                    help="train a planner-searched pp-stage pipeline "
                         "(0 = the reference loss)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        if args.pp and world % args.pp:
            ap.error(f"under torchrun WORLD_SIZE {world} must be a multiple "
                     f"of --pp (got {args.pp})")
        if not args.pp and args.global_batch % world:
            ap.error(f"--global-batch {args.global_batch} does not split "
                     f"over WORLD_SIZE {world} replicas")
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                               % torch.cuda.device_count())
            torch.cuda.set_device(dev)
    overrides = {"num_layers": args.layers} if args.layers else {}
    bundle = registry.get_bundle(args.arch, smoke=args.smoke, **overrides)
    plan = None
    if args.pp:
        plan = search_plan(bundle.cfg, args.pp, args.global_batch, args.seq)
        dp = world // args.pp
        if dp > 1:
            plan = dataclasses.replace(plan, stages=tuple(
                dataclasses.replace(st, dp=dp) for st in plan.stages))
            if args.global_batch % plan.tokens_per_tick:
                ap.error(f"--global-batch {args.global_batch} does not "
                         f"split into dp {dp} x micro_bs {plan.micro_bs}")
    if world > 1:
        transport = plan.transport if plan is not None else PLAIN_TRANSPORT
        dist.init_process_group(
            "gloo" if dev.type == "cpu" or transport == "cpu"
            else "cpu:gloo,cuda:nccl")
    try:
        _train(args, bundle, plan, dev, world)
    finally:
        if world > 1:
            dist.destroy_process_group()


def _train(args, bundle, plan, dev, world: int) -> None:
    rank = dist.get_rank() if world > 1 else 0
    log = print if rank == 0 else (lambda *a, **k: None)
    if plan is not None:
        log(f"[train] plan: {plan.describe()}", flush=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    t = Trainer(bundle, TrainerConfig(global_batch=args.global_batch,
                                      seq_len=args.seq,
                                      ckpt_dir=args.ckpt_dir,
                                      ckpt_every=args.ckpt_every),
                plan=plan, opt_cfg=AdamWConfig(lr=args.lr, warmup_steps=20),
                device=dev)
    init_s, start_step = time.time() - t0, t.step
    if world > 1 and t.grid is None:
        raise RuntimeError("this process is not one rank of the run")
    rplan = t.train_step.plan if t.grid is not None else plan
    n_params = sum(x.numel() for x in tree_leaves(t.state["params"]))
    log(f"[train] arch={bundle.cfg.name} params={n_params / 1e6:.1f}M "
        f"device={dev} start_step={t.step}"
        + (f" rank 0 of {world}" if world > 1 else ""), flush=True)
    ops.reset_launch_counts()
    t0 = time.time()
    done, losses, step_s = 0, [], []
    while done < args.steps:
        chunk = min(LOG_EVERY, args.steps - done)
        out = t.run(chunk)
        losses += out["losses"]
        step_s += out["step_s"]
        done += chunk
        tok_s = done * args.global_batch * args.seq / (time.time() - t0)
        log(f"[train] step={t.step} loss={losses[-1]:.4f} "
            f"tok/s={tok_s:.0f}", flush=True)
    tok_s = done * args.global_batch * args.seq / (time.time() - t0)
    peak = (torch.cuda.max_memory_allocated(dev) / 1e9
            if dev.type == "cuda" else None)
    peaks, rank_losses = [peak], [losses]
    if world > 1:
        peaks, rank_losses = [None] * world, [None] * world
        dist.all_gather_object(peaks, peak)
        dist.all_gather_object(rank_losses, losses)
    summary = {
        "final_loss": losses[-1], "start_step": start_step, "steps": t.step,
        "params_m": round(n_params / 1e6, 1), "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "tok_s": tok_s, "peak_mem_gb": peak,
        # the CPU runs the plain versions: no kernel launches there
        "kernel_launches": ops.launch_counts(),
        "pp": plan.pp if plan else None,
        "virtual_layers": list(plan.virtual_layers) if plan else None,
        "micro_batches": plan.micro_batches if plan else None,
        "world": world, "dp": rplan.dps[0] if rplan else 1,
        "transport": rplan.transport if rplan else None,
        "rank_peak_mem_gb": peaks, "rank_losses": rank_losses,
        "step_s": step_s,
        # the trainer's init (a restore included) and the last save's
        # timings (rank 0's write waits for every rank's part)
        "init_s": init_s, "ckpt": t.ckpt.timings if t.ckpt else None,
    }
    log(json.dumps(summary))


if __name__ == "__main__":
    main()
