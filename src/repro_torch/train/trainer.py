"""Training loop (port of the plan routing and the run loop of
``repro/train/trainer.py``).

``Trainer`` builds the train step its plan asks for and runs it over the
synthetic batches:

  * no plan, a cp = 1 plan, a plan for another workload shape, or a model
    outside the cp scope: the reference loss (full forward, flash
    attention);
  * a pp = 1, cp > 1 plan for this workload: the cp ring loss
    (``parallel/context.py``), same state and train step;
  * a pp > 1 plan for this workload on one process: the pipeline loss
    (``parallel/pipeline.py``) over the plan's microbatches, virtual
    stage layers, vpp and stage tp widths, same state and train step; the
    batch arrives microbatched ``(m, B_tick, ...)``.  As in the JAX
    trainer, the plan's cp and per-stage dp stay advisory there;
  * with ``torch.distributed`` initialised over ``world > 1`` processes,
    always the rank route over ``world = pp * dp * tp`` ranks: this
    workload's plan (pp > 1, or pp 1), else one stage of every layer over
    ``world / tp`` replicas (``TrainerConfig.tp``, the JAX trainer's
    ``tp``; every axis on ``PLAIN_TRANSPORT``, NCCL on the cards, as the
    JAX mesh's axes are all ICI): plain data parallelism at tp 1, as the
    JAX CLI runs without ``--pp``.  This rank
    holds its model rank's share of one stage (its chunks under vpp > 1)
    of one replica (``parallel/groups.make_rank_grid``,
    ``parallel/sharding.py``), at dp > 1 only its replica's ZeRO-1 slice
    of the AdamW moments and master (``pipeline.init_rank_state``, or
    ``pipeline.split_state_for_rank`` of a whole ``state=``), and its rows
    of the global batch (of every microbatch when pp > 1), and steps with
    ``pipeline.PPRankStep``; every rank reports the step's loss.

Left out of the JAX trainer, each a ROADMAP item: checkpoints and restart,
stage telemetry, straggler detection, replanning and migration,
adaptation and observability (queue A, item A6).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.plan import ParallelPlan, StagePlacement
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.models.registry import ArchBundle
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel import context, groups, pipeline
from repro_torch.train import steps as steps_mod
from repro_torch.utils.device import (DeviceLike, resolve_device,
                                      synchronize)


# the transport of the rank plan made without a plan: the cards' own links
PLAIN_TRANSPORT = "gpu"


@dataclasses.dataclass
class TrainerConfig:
    global_batch: int = 8
    seq_len: int = 64
    tp: int = 1


class Trainer:
    def __init__(self, bundle: ArchBundle, cfg: TrainerConfig,
                 plan: Optional[ParallelPlan] = None,
                 opt_cfg: Optional[AdamWConfig] = None,
                 state: Optional[Dict[str, Any]] = None,
                 device: DeviceLike = None):
        """``state``: a train state to start from (``steps.
        init_train_state``'s layout, e.g. ``convert.from_jax`` of a JAX
        state), copied to the device.  Default: a fresh state from seed
        0."""
        self.bundle = bundle
        self.cfg = cfg
        self.plan = plan
        self.opt_cfg = opt_cfg or AdamWConfig()
        self.device = resolve_device(device)
        self.data = SyntheticTokens(
            vocab_size=bundle.cfg.vocab_size, seq_len=cfg.seq_len,
            global_batch=cfg.global_batch, family=bundle.cfg.family,
            d_model=bundle.cfg.d_model,
            n_vision_tokens=bundle.cfg.n_vision_tokens)
        self.grid: Optional[groups.RankGrid] = None
        self._build()
        if self.grid is not None:
            g, rplan = self.grid, self.train_step.plan
            rules = self.train_step.rules
            self.state = (
                pipeline.init_rank_state(bundle, rplan, g.stage,
                                         device=self.device, rules=rules,
                                         model_rank=g.model_rank,
                                         replica=g.replica)
                if state is None else adamw.tree_map(
                    lambda t: t.to(self.device),
                    pipeline.split_state_for_rank(state, rplan, g.stage,
                                                  rules, g.model_rank,
                                                  replica=g.replica)))
        elif state is None:
            self.state = steps_mod.init_train_state(bundle,
                                                    device=self.device)
        else:   # a copy: the step updates its state in place
            self.state = adamw.tree_map(
                lambda t: t.to(self.device, copy=True), state)
        self.step = int(self.state["step"])
        self.data.state.step = self.step

    # ------------------------------------------------------------ build ---
    def _pipeline_active(self) -> bool:
        """The plan describes this trainer's own workload and pipelines it
        (the JAX trainer would run its SPMD pipeline step)."""
        plan = self.plan
        return (plan is not None and plan.pp > 1
                and plan.global_batch == self.cfg.global_batch
                and plan.seq_len == self.cfg.seq_len
                and self.cfg.global_batch % plan.tokens_per_tick == 0)

    def _ranks_active(self) -> bool:
        """This process is one rank of an initialised process group of
        several: every trainer then takes the rank route."""
        return (dist.is_available() and dist.is_initialized()
                and dist.get_world_size() > 1)

    def _rank_plan(self, world: int) -> ParallelPlan:
        """The plan the ranks run: this workload's plan, else one stage of
        every layer over ``world / tp`` replicas of ``tp`` ranks."""
        plan, tp = self.plan, self.cfg.tp
        if self._pipeline_active() or (
                plan is not None and plan.pp == 1
                and plan.global_batch == self.cfg.global_batch
                and plan.seq_len == self.cfg.seq_len):
            return plan
        if world % tp:
            raise ValueError(f"world size {world} is no multiple of tp {tp}")
        dp = world // tp
        return ParallelPlan(
            stages=(StagePlacement(0, self.bundle.cfg.num_layers, dp, tp,
                                   True),),
            micro_bs=self.cfg.global_batch // dp,
            global_batch=self.cfg.global_batch, seq_len=self.cfg.seq_len,
            transport=PLAIN_TRANSPORT)

    def _cp_active(self) -> bool:
        """A pp == 1, cp > 1 plan matching this workload runs the ring loss
        in place of the reference loss; models outside its scope keep the
        reference loss."""
        plan = self.plan
        if (plan is None or plan.pp != 1 or plan.cp <= 1
                or plan.global_batch != self.cfg.global_batch
                or plan.seq_len != self.cfg.seq_len):
            return False
        try:
            context.check_cp_supported(self.bundle.cfg)
        except ValueError:
            return False
        return True

    def _build(self):
        loss_fn = None
        if self._ranks_active():
            world, tp = dist.get_world_size(), self.cfg.tp
            plan = self._rank_plan(world)
            pipeline.check_rank_plan(self.bundle.cfg, plan)
            if plan.tps[0] != tp:
                raise ValueError(f"plan {plan.describe()} has stage tp "
                                 f"{plan.tps}, the trainer tp {tp}")
            if world != plan.pp * plan.dps[0] * tp:
                raise ValueError(f"world size {world} is not pp {plan.pp} x "
                                 f"dp {plan.dps[0]} x tp {tp}")
            if self.cfg.global_batch % plan.dps[0]:
                raise ValueError(f"global batch {self.cfg.global_batch} does "
                                 f"not split over dp {plan.dps[0]}")
            self.grid = groups.make_rank_grid(plan.pp, plan.dps[0],
                                              self.device, tp=tp)
            self.train_step = pipeline.PPRankStep(
                self.bundle.cfg, plan, self.grid, self.opt_cfg)
            return
        if self.cfg.tp > 1:
            raise ValueError(f"TrainerConfig.tp {self.cfg.tp} runs on ranks: "
                             "initialise torch.distributed over pp x dp x tp "
                             "processes")
        if self._pipeline_active():
            plan = self.plan
            loss_fn = pipeline.make_pp_loss_fn(
                self.bundle.cfg, plan.pp, plan.micro_batches,
                layers_per_stage=list(plan.virtual_layers), vpp=plan.vpp,
                stage_tp=list(plan.tps))
        elif self._cp_active():
            loss_fn = context.make_cp_loss_fn(self.bundle.cfg,
                                              self.plan.cp_chunk_sizes)
        self.train_step = steps_mod.make_train_step(
            self.bundle, self.opt_cfg, loss_fn=loss_fn)

    # ------------------------------------------------------------- run ----
    def _device_batch(self, np_batch: Dict[str, np.ndarray]):
        m = self.plan.micro_batches if self._pipeline_active() else None

        def put(v):
            if m is not None:   # the pipeline consumes (m, B_tick, ...)
                v = v.reshape(m, v.shape[0] // m, *v.shape[1:])
            if self.grid is not None:   # this replica's rows (of each)
                rows = v if m is None else v.swapaxes(0, 1)
                b = rows.shape[0] // self.grid.dp
                r = self.grid.replica
                rows = rows[r * b:(r + 1) * b]
                v = rows if m is None else rows.swapaxes(0, 1)
            return torch.from_numpy(np.ascontiguousarray(v)).to(self.device)

        return {k: put(v) for k, v in np_batch.items()}

    def run(self, n_steps: int) -> Dict[str, Any]:
        """``n_steps`` train steps; returns {"losses", "grad_norms",
        "step", "step_s"} (each step's wall time, ending when its loss is
        on the host; the global gradient norm AdamW clipped by)."""
        losses, norms, step_s = [], [], []
        for _ in range(n_steps):
            t0 = time.perf_counter()
            batch = self._device_batch(self.data.batch_at(self.step))
            self.state, metrics = self.train_step(self.state, batch)
            losses.append(float(metrics["loss"]))
            synchronize(self.device)
            step_s.append(time.perf_counter() - t0)
            norms.append(float(metrics["grad_norm"]))
            self.step += 1
            self.data.state.step = self.step
        return {"losses": losses, "grad_norms": norms, "step": self.step,
                "step_s": step_s}
