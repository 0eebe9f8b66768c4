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
step=.. loss=.. tok/s=..`` every ``--log-every`` steps (default 10, as
the JAX CLI's; a chunk also ends at an injection step) and, last, a JSON
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

The closed loop as the JAX CLI drives it: with ``--pp`` the trainer
records stage telemetry (``--telemetry``, default ``auto``: tick marks on
one process, CUDA events on the card; each rank's ops under
``torchrun``) into a profile store, and ``--degrade KIND:FACTOR[@STEP]``
(default STEP: half the steps) degrades KIND of the cluster at STEP and
replans the run onto it with the initial search's constraints, moving
the live state in memory (every rank's elements to their new ranks under
``torchrun``).  It prints ``[train] degraded KIND:FACTOR -> replanned:
<plan> (migrations=...)``, and after each chunk of steps ``[train] bubble
observed=... predicted=...``.  ``--adapt`` hands that decision to the
autonomous controller (``adapt/``; JAX's ``--adapt-*`` knobs): the
injected degradation only distorts the telemetry, and the policy
detects it, replans, gain-gates and migrates by itself; every decision
prints as an ``AdaptEvent`` line, and under ``torchrun`` the ranks'
telemetry is gathered on its own (``adapt.default_aggregator``).
``--lose KIND@STEP`` / ``--join KIND@STEP`` (repeatable; they let the
controller search ``pp`` 1 to ``--pp``) make island KIND leave or rejoin
the cluster at STEP: the controller replans onto the edited topology and
moves the state live; under ``torchrun`` the ranks of KIND's stages leave
the plan, and come back on the join.  Observability as in the JAX CLI
(``obs/``): ``--trace-out`` (Chrome trace), ``--metrics-out`` (JSONL),
``--events-out`` (the AdaptEvent log), ``--prom-out`` (Prometheus
textfile), ``--flight-out`` (the flight recorder's dump, default
``flight.json`` in ``--ckpt-dir``, or the temporary directory with
``--ckpt-dir ''``); under ``torchrun`` every rank shares rank 0's run
id, rank 0 writes each path and rank r the same path with ``.rank<r>``
before its suffix.  The summary has ``replans``, ``migrations`` and the
``adapt_events``; its ``pp`` and ``virtual_layers`` are the plan after
the last replan.
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
from pathlib import Path

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


def membership_spec(text: str):
    """Validated ``--lose``/``--join`` value: KIND@STEP -> (kind, step).
    The step is mandatory — a membership event is a scheduled fact, not a
    half-the-run default."""
    err = argparse.ArgumentTypeError(
        f"expected KIND@STEP (e.g. gpu-a@6), got {text!r}")
    kind, sep, at = text.partition("@")
    if not kind or not sep:
        raise err
    try:
        step = int(at)
    except ValueError:
        raise err from None
    if step < 0:
        raise argparse.ArgumentTypeError(
            f"membership @STEP must be >= 0, got {at!r}")
    return kind, step


def rank_path(path, rank: int):
    """``path`` for rank ``rank`` of a run: rank 0's as it is, rank r's
    with ``.rank<r>`` before the suffix."""
    if path is None or rank == 0:
        return path
    p = Path(path)
    return str(p.with_name(f"{p.stem}.rank{rank}{p.suffix}"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3-8b", choices=registry.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--layers", type=int, default=0,
                    help="override the arch's layer count (0 = default)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
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
    ap.add_argument("--lose", type=membership_spec, action="append",
                    default=[], metavar="KIND@STEP",
                    help="membership event: island KIND leaves the "
                         "cluster at STEP — the controller forces a "
                         "replan onto the survivors and live-migrates, "
                         "no restart (needs --pp; repeatable)")
    ap.add_argument("--join", type=membership_spec, action="append",
                    default=[], metavar="KIND@STEP",
                    help="membership event: island KIND (re)joins at "
                         "STEP — restores the healthy spec remembered by "
                         "an earlier --lose and replans back onto it "
                         "(needs --pp; repeatable)")
    ap.add_argument("--adapt", action="store_true",
                    help="autonomous adaptation: the adapt policy "
                         "watches telemetry and replans/migrates itself")
    ap.add_argument("--adapt-min-gain", type=float, default=0.05,
                    help="ε gate: min predicted fractional iter-time gain "
                         "before a migration is adopted")
    ap.add_argument("--adapt-enter", type=float, default=2.0,
                    help="straggler hysteresis enter threshold (ratio of "
                         "a stage's tick time vs its healthy baseline)")
    ap.add_argument("--adapt-exit", type=float, default=0.0,
                    help="straggler hysteresis exit threshold; 0 derives "
                         "it from --adapt-enter (keeps the default band "
                         "shape, so any enter value is valid)")
    ap.add_argument("--adapt-patience", type=float, default=2.0,
                    help="armed observations required before triggering")
    ap.add_argument("--adapt-cooldown", type=int, default=8,
                    help="observed steps of silence after any trigger")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome-trace/Perfetto JSON timeline "
                         "(predicted + observed lanes, AdaptEvent "
                         "instants) to this path")
    ap.add_argument("--metrics-out", default=None,
                    help="write the append-only metrics JSONL stream to "
                         "this path")
    ap.add_argument("--events-out", default=None,
                    help="write the AdaptEvent log as JSONL to this path")
    ap.add_argument("--prom-out", default=None,
                    help="write a Prometheus textfile snapshot at exit")
    ap.add_argument("--flight-out", default=None,
                    help="flight-recorder dump path (default: "
                         "<ckpt-dir>/flight.json when any observability "
                         "output is enabled)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.log_every < 1:
        ap.error(f"--log-every {args.log_every} must be at least 1")
    if args.degrade is not None and not args.pp:
        ap.error("--degrade needs --pp (a plan and a cluster to replan)")
    if (args.lose or args.join) and not args.pp:
        ap.error("--lose/--join need --pp (a cluster to edit)")

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


def _observability(args, plan, bundle, rank: int, world: int):
    """The ``Observability`` of the obs flags (None without any), every
    rank on rank 0's run id, each rank's files its own."""
    if not (args.trace_out or args.metrics_out or args.events_out
            or args.prom_out):
        return None
    from repro_torch.obs import Observability, RunMeta, install_sigterm
    run = [RunMeta.new(plan=plan, arch=bundle.cfg.name)]
    if world > 1:   # one run id, rank 0's
        dist.broadcast_object_list(run, src=0)
    flight_out = args.flight_out or os.path.join(
        args.ckpt_dir or tempfile.gettempdir(), "flight.json")
    flight_out = rank_path(flight_out, rank)
    obs = Observability(
        trace_out=rank_path(args.trace_out, rank),
        metrics_out=rank_path(args.metrics_out, rank),
        events_out=rank_path(args.events_out, rank),
        prom_out=rank_path(args.prom_out, rank),
        flight_out=flight_out, run=run[0])
    # dump the decision ring when the cluster scheduler kills us
    install_sigterm(obs.flight, flight_out)
    return obs


def _controller(args):
    """(policy, aggregator, search space of the controller's replans)."""
    policy = aggregator = None
    # membership replans search the SAME constrained space as the initial
    # plan, except pipeline depth: a lost island can leave too few
    # accelerators for the configured pp
    adapt_kw = dict(cli_search_kw(args.pp)) if args.pp else {}
    if args.pp:
        adapt_kw["pp_options"] = list(range(1, args.pp + 1))
    if args.adapt:
        from repro_torch.adapt import (AdaptConfig, ReplanPolicy,
                                       default_aggregator)
        exit_ = args.adapt_exit or args.adapt_enter * (
            AdaptConfig.straggler_exit / AdaptConfig.straggler_enter)
        policy = ReplanPolicy(AdaptConfig(
            min_gain=args.adapt_min_gain,
            straggler_enter=args.adapt_enter, straggler_exit=exit_,
            patience=args.adapt_patience, cooldown=args.adapt_cooldown))
        aggregator = default_aggregator()
    elif (args.lose or args.join) and dist.is_initialized():
        # the ranks' membership directives travel through its broadcast
        from repro_torch.adapt import default_aggregator
        aggregator = default_aggregator()
    return policy, aggregator, adapt_kw


def _train(args, bundle, plan, dev, world: int) -> None:
    rank = dist.get_rank() if world > 1 else 0
    log = print if rank == 0 else (lambda *a, **k: None)
    if plan is not None:
        log(f"[train] plan: {widen_plan(plan, world).describe()}",
            flush=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    policy, aggregator, adapt_kw = _controller(args)
    obs = _observability(args, plan, bundle, rank, world)
    if obs is not None:
        log(f"[train] observability on: run={obs.run.run_id} "
            f"plan_digest={obs.run.plan_digest}", flush=True)
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
                profile_store=ProfileStore() if plan else None,
                policy=policy, aggregator=aggregator,
                adapt_search_kw=adapt_kw, obs=obs)
    try:
        _steps(args, t, bundle, dev, world, t0, log)
    finally:
        # artifacts survive a mid-run crash: whatever was recorded up to
        # the failure is flushed and attributable to this run
        if obs is not None:
            obs.write_events(t.adapt_log)
            obs.close()


def _steps(args, t, bundle, dev, world: int, t0: float, log) -> None:
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
    membership = sorted(
        [(step, "lost", kind) for kind, step in args.lose]
        + [(step, "joined", kind) for kind, step in args.join])
    ops.reset_launch_counts()
    t0 = time.time()
    done, losses, step_s, printed, moves, mem = 0, [], [], 0, [], []
    while done < args.steps:
        last = t.last_migration
        chunk = min(args.log_every, args.steps - done)
        # land each chunk boundary on the next injection step
        stops = [degrade_step] if degrade_kind is not None else []
        stops += [s for s, _, _ in membership]
        for s in stops:
            if done < s < done + chunk:
                chunk = s - done
        out = t.run(chunk)
        losses += out["losses"]
        step_s += out["step_s"]
        done += chunk
        if dev.type == "cuda":   # a rank outside the plan holds ~nothing
            mem.append(torch.cuda.memory_allocated(dev) / 1e9)
        tok_s = done * args.global_batch * args.seq / (time.time() - t0)
        log(f"[train] step={t.step} "
            + (f"loss={out['losses'][-1]:.4f} " if out["losses"]
               else "(outside the plan) ")
            + f"tok/s={tok_s:.0f}", flush=True)
        if degrade_kind is not None and done >= degrade_step:
            if args.adapt:
                # only distort the telemetry: the controller detects,
                # replans, gain-gates and migrates by itself
                t.inject_degrade(degrade_kind, degrade_factor)
                log(f"[train] injected degrade {degrade_kind}:"
                    f"{degrade_factor} at step {t.step} — controller is on "
                    f"its own now", flush=True)
            else:
                t.replan(t.cluster.degrade(degrade_kind, degrade_factor),
                         global_batch=args.global_batch, seq_len=args.seq,
                         **cli_search_kw(args.pp))
                # the plan the ranks run (under torchrun widened to them)
                log(f"[train] degraded {degrade_kind}:{degrade_factor} -> "
                    f"replanned: {t.run_plan.describe()} "
                    f"(migrations={t.migrations})", flush=True)
            degrade_kind = None
        while membership and done >= membership[0][0]:
            _, op, kind = membership.pop(0)
            if op == "lost":
                t.lose_node(kind)
            else:
                t.join_node(kind)
            log(f"[train] membership: island {kind} {op} at step {t.step} "
                f"— controller replans on the new topology", flush=True)
        for ev in t.adapt_log[printed:]:
            log(ev.format(), flush=True)
        printed = len(t.adapt_log)
        if t.last_migration is not last:    # a replan moved the state
            moves.append({k: v for k, v in t.last_migration.items()
                          if k != "moved"})
        health = t.schedule_health()
        if health is not None:
            log(f"[train] bubble observed={health['observed_bubble']:.3f} "
                f"predicted={health['predicted_bubble']:.3f}", flush=True)
    plan = t.plan
    rplan = t.run_plan
    tok_s = done * args.global_batch * args.seq / (time.time() - t0)
    peak = (torch.cuda.max_memory_allocated(dev) / 1e9
            if dev.type == "cuda" else None)
    peaks, rank_losses, rank_mem = [peak], [losses], [mem]
    if world > 1:
        peaks, rank_losses = [None] * world, [None] * world
        rank_mem = [None] * world
        dist.all_gather_object(peaks, peak)
        dist.all_gather_object(rank_losses, losses)
        dist.all_gather_object(rank_mem, mem)
    summary = {
        "final_loss": losses[-1] if losses else None,
        "start_step": start_step, "steps": t.step,
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
        "adapt_events": [e.to_dict() for e in t.adapt_log],
        "world": world, "dp": rplan.dps[0] if rplan else 1,
        "transport": rplan.transport if rplan else None,
        "rank_peak_mem_gb": peaks, "rank_losses": rank_losses,
        # each rank's allocated GB after each chunk of steps
        "rank_mem_gb": rank_mem,
        "step_s": step_s,
        # the trainer's init (a restore included) and the last save's
        # timings (rank 0's write waits for every rank's part)
        "init_s": init_s, "ckpt": t.ckpt.timings if t.ckpt else None,
        # each replan's move: seconds, and on ranks this rank's bytes
        "moves": moves,
    }
    log(json.dumps(summary))


if __name__ == "__main__":
    main()
