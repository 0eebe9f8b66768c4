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
``start_step=``, and then takes ``--steps`` more (``--ckpt-dir ''``: no
checkpoints, the degrade replan's included).  Under ``torchrun``
every rank writes its own part of one checkpoint in the same directory,
and any plan, any world size or one process resumes from it.

The closed loop as the JAX CLI drives it without ``--adapt``: with
``--pp`` the trainer records stage telemetry (``--telemetry``, default
``auto``: tick marks on one process, CUDA events on the card; each rank's
ops under ``torchrun``) into a profile store, and ``--degrade
KIND:FACTOR[@STEP]`` (default STEP: half the steps) degrades KIND of the
cluster at STEP and replans the run onto it with the initial search's
constraints, moving the live state in memory (every rank's elements to
their new ranks under ``torchrun``).  It prints ``[train] degraded
KIND:FACTOR -> replanned: <plan> (migrations=...)``, and after each
chunk of steps ``[train] bubble observed=... predicted=...``; the summary
has ``replans`` and ``migrations``, and its ``pp`` and
``virtual_layers`` are the plan after the last replan.  Left for ROADMAP
A6c: ``--adapt``, ``--lose``/``--join`` and observability.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.core import planner
from repro_torch.core.cluster import cli_cluster, cli_search_kw
from repro_torch.kernels import ops
from repro_torch.models import registry
from repro_torch.optim.adamw import AdamWConfig, tree_leaves
from repro_torch.profile.store import ProfileStore
from repro_torch.train.trainer import (PLAIN_TRANSPORT, Trainer,
                                       TrainerConfig, widen_plan)
from repro_torch.utils.device import resolve_device

LOG_EVERY = 10


def search_plan(cfg, pp: int, global_batch: int, seq_len: int):
    """The planner's best ``pp``-stage plan for this workload on the JAX
    CLI's cluster, searched as the JAX CLI searches."""
    return planner.search(cli_cluster(), cfg, global_batch=global_batch,
                          seq_len=seq_len, **cli_search_kw(pp)).plan


def degrade_spec(text: str):
    """Validated ``--degrade`` value: KIND:FACTOR[@STEP] -> (kind, factor,
    step or None).  A malformed spec fails at the flag with the expected
    shape spelled out, not deep in the run with a bare ValueError."""
    err = argparse.ArgumentTypeError(
        f"expected KIND:FACTOR[@STEP] (e.g. gpu-a:8@6), got {text!r}")
    spec, _, at = text.partition("@")
    kind, sep, factor_s = spec.partition(":")
    if not kind or not sep:
        raise err
    try:
        factor = float(factor_s)
        step = int(at) if at else None
    except ValueError:
        raise err from None
    if not (factor > 0 and math.isfinite(factor)):
        raise argparse.ArgumentTypeError(
            f"degrade FACTOR must be a finite number > 0, got {factor_s!r}")
    if step is not None and step < 0:
        raise argparse.ArgumentTypeError(
            f"degrade @STEP must be >= 0, got {at!r}")
    return kind, factor, step


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
    ap.add_argument("--telemetry", default="auto",
                    choices=["auto", "callback", "timer", "off"])
    ap.add_argument("--degrade", type=degrade_spec, default=None,
                    help="KIND:FACTOR[@STEP] degradation (default STEP: "
                         "half the steps) -> live replan + migration "
                         "(needs --pp)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.degrade is not None and not args.pp:
        ap.error("--degrade needs --pp (a plan and a cluster to replan)")

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
        wide = widen_plan(plan, world)
        if args.global_batch % wide.tokens_per_tick:
            ap.error(f"--global-batch {args.global_batch} does not split "
                     f"into dp {wide.dps[0]} x micro_bs {wide.micro_bs}")
    if world > 1:
        transport = plan.transport if plan is not None else PLAIN_TRANSPORT
        dist.init_process_group(
            "gloo" if dev.type == "cpu" or transport == "cpu"
            else "cpu:gloo,cuda:nccl")
    try:
        _train(args, bundle, plan, dev, world)
    except BaseException:
        if world > 1:
            # the other ranks wait on this one in their collectives, and
            # destroy_process_group may wait on them: report and exit at
            # once, and torchrun ends the others
            traceback.print_exc()
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(1)
        raise
    if world > 1:
        dist.destroy_process_group()


def _train(args, bundle, plan, dev, world: int) -> None:
    rank = dist.get_rank() if world > 1 else 0
    log = print if rank == 0 else (lambda *a, **k: None)
    if plan is not None:
        log(f"[train] plan: {widen_plan(plan, world).describe()}",
            flush=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    # the telemetry folds land in the store, so the degrade replan
    # searches against observed (scaled) costs once dense enough
    t = Trainer(bundle, TrainerConfig(global_batch=args.global_batch,
                                      seq_len=args.seq,
                                      ckpt_dir=args.ckpt_dir,
                                      ckpt_every=args.ckpt_every,
                                      telemetry=args.telemetry),
                plan=plan, opt_cfg=AdamWConfig(lr=args.lr, warmup_steps=20),
                device=dev, cluster=cli_cluster() if plan else None,
                profile_store=ProfileStore() if plan else None)
    init_s, start_step = time.time() - t0, t.step
    if world > 1 and t.grid is None:
        raise RuntimeError("this process is not one rank of the run")
    n_params = sum(x.numel() for x in tree_leaves(t.state["params"]))
    log(f"[train] arch={bundle.cfg.name} params={n_params / 1e6:.1f}M "
        f"device={dev} start_step={t.step}"
        + (f" rank 0 of {world}" if world > 1 else ""), flush=True)
    degrade_kind, degrade_factor, degrade_step = args.degrade or (None, 1.0,
                                                                  None)
    if degrade_kind is not None and degrade_step is None:
        degrade_step = args.steps // 2
    ops.reset_launch_counts()
    t0 = time.time()
    done, losses, step_s = 0, [], []
    while done < args.steps:
        chunk = min(LOG_EVERY, args.steps - done)
        # land the chunk boundary on the degrade step
        if degrade_kind is not None and done < degrade_step < done + chunk:
            chunk = degrade_step - done
        out = t.run(chunk)
        losses += out["losses"]
        step_s += out["step_s"]
        done += chunk
        tok_s = done * args.global_batch * args.seq / (time.time() - t0)
        log(f"[train] step={t.step} loss={losses[-1]:.4f} "
            f"tok/s={tok_s:.0f}", flush=True)
        if degrade_kind is not None and done >= degrade_step:
            t.replan(t.cluster.degrade(degrade_kind, degrade_factor),
                     global_batch=args.global_batch, seq_len=args.seq,
                     **cli_search_kw(args.pp))
            # the plan the ranks run (under torchrun widened to the world)
            log(f"[train] degraded {degrade_kind}:{degrade_factor} -> "
                f"replanned: {t.run_plan.describe()} "
                f"(migrations={t.migrations})", flush=True)
            degrade_kind = None
        health = t.schedule_health()
        if health is not None:
            log(f"[train] bubble observed={health['observed_bubble']:.3f} "
                f"predicted={health['predicted_bubble']:.3f}", flush=True)
    plan = t.plan
    rplan = t.run_plan
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
        "micro_batches": rplan.micro_batches if rplan else None,
        "replans": t.replans, "migrations": t.migrations,
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
