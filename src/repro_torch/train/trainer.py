"""Training loop (port of the plan routing and the run loop of
``repro/train/trainer.py``).

``Trainer`` builds the train step its plan asks for and runs it over the
synthetic batches:

  * no plan, a cp = 1 plan, a plan for another workload shape, or a model
    outside the cp scope: the reference loss (full forward, flash
    attention);
  * a pp = 1, cp > 1 plan for this workload on one process: the cp ring
    loss on the one device (``parallel/context.py``), same state and
    train step;
  * a pp > 1 plan for this workload on one process: the pipeline loss
    (``parallel/pipeline.py``) over the plan's microbatches, virtual
    stage layers, vpp and stage tp widths, same state and train step; the
    batch arrives microbatched ``(m, B_tick, ...)``.  As in the JAX
    trainer, the plan's cp and per-stage dp stay advisory there;
  * with ``torch.distributed`` initialised over ``world > 1`` processes,
    always the rank route over ``world = pp * dp * tp`` ranks: this
    workload's plan (pp > 1, or pp 1; a plan of fewer ranks whose count
    divides the world is widened to ``world / (pp * tp)`` replicas of
    each stage, ``widen_plan``: ``run_plan``, while ``plan`` stays the
    searched one), else one stage of every layer over
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
    ``pipeline.PPRankStep``; every rank reports the step's loss.  A pp 1,
    cp > 1 plan for this workload runs the cp ring across ranks on
    ``cp * (dp / cp) * tp`` processes: the grid's ``pod`` axis holds the
    ring, each data group (a replica) takes its rows whole and each of
    its ring ranks its chunk of them (``context.make_cp_rank_loss_fn``);
    the ring ranks of a group hold one state.  A cp plan at pp > 1 on
    ranks raises (ROADMAP.md queue A, item A8b), where one process keeps
    its cp advisory.

Checkpoints (the JAX trainer's, ``ckpt/checkpoint.py``): with
``TrainerConfig.ckpt_dir`` set, a trainer starts from the latest complete
checkpoint there, data state included, and ``run`` saves one in the
background after every step that ``ckpt_every`` divides.  Every route
trains in the canonical layout (manifest ``layout`` None), and a
checkpoint of any route, plan or rank layout restores on any other: a
rank reads only its own elements (``pipeline.rank_leaf_slices``), and a
JAX checkpoint of a stacked pp layout is read through that layout and
counted in ``migrations["checkpoint"]``.  On the rank route every rank
writes its own elements into one checkpoint (``checkpoint.save_rank``);
the whole state is never gathered.

The closed loop (the JAX trainer's control plane): on the pipeline route,
and on the rank route at pp > 1 with a ``profile_store`` (a pp 1 plan on
ranks, the cp ring's included, has no stages and takes none), a recorder
(``telemetry/``; none when ``TrainerConfig.telemetry`` is "off") observes
the step, tick by tick in one process (CUDA events on the card), op by op
on ranks, where every rank gathers every stage's view once a step.  With a
``profile_store``, ``run`` folds each step's time (``observed_step``,
``observed_layer_step``) and the recorder's observations
(``observed_stage_tick``, ``observed_bubble``) under
``profile/runner.device_kind``; an EWMA of the step times calls
``on_straggler`` after ``straggler_patience`` slow steps.
``schedule_health`` compares the observed bubble with the predictor's,
``inject_degrade`` makes the telemetry report a slower device kind, and
``replan`` searches the planner against the observed profile (once
``replan_profile_min_obs`` observations make it a ``ProfiledCostModel``)
with the incumbent as the baseline, then ``_adopt``s the winner: on one
process every route trains in the canonical layout, so the in-memory
migration rebuilds the step over the same tensors; on ranks the leader
(the aggregator's, else rank 0) searches and broadcasts the plan (on the
cards, one each stage of which fits the card, ``fit_to_card``), ``parallel/migrate.redistribute`` moves
every element from its old writer to its new ranks, or the checkpoint
round trip restores it (``migrate="checkpoint"``, or a failed move when
there is a checkpoint), and the old grid's groups are released before
the new grid is made.

The autonomous controller (the JAX trainer's, ``adapt/``): given a
``policy`` (``adapt.ReplanPolicy``) and an ``aggregator``, ``run``
gathers the cluster view and runs the adaptation decision at a step
cadence (``TrainerConfig.aggregate_every``) that every process enters
together; the aggregator's leader (the lowest surviving rank) consults
the policy, searches, gates the gain and broadcasts a directive, and
every process adopts it together (``adapt_log``: structured
``AdaptEvent``s).  Elastic membership: ``lose_node`` / ``join_node``
queue topology facts that the leader turns into forced replans on the
edited cluster (``ClusterSpec.remove_group`` / ``add_group``); the
departed kind's profile entries are kept ``profile_stale_steps`` steps.
On one process every route trains in the canonical layout, so a
membership change rebuilds the step over the same tensors.  On ranks a
rank belongs to the device kind of its stage's group: the ranks of a
lost kind leave the plan (the searched plan is widened to the ranks
present, the grid made over them), send every element they write to
the survivors (``parallel/migrate.redistribute``), and then hold no
state and no grid, skip the train step and still enter every per-step
and cadence collective, until ``join_node`` names their kind again and
the state moves back.  A replan whose width does not divide the ranks
present raises.

Observability (``obs/``): with ``obs`` (an ``obs.Observability``) the
trainer calls JAX's hooks at JAX's points (the telemetry sink on the
one-process pipeline route, plan adoptions, searches, adaptation events,
migrations, folds, steps, a ``schedule-error`` flight dump); ``obs=None``
(the default) touches nothing.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core import planner as planner_mod
from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.plan import ParallelPlan, StagePlacement
from repro_torch.data.pipeline import DataState, SyntheticTokens
from repro_torch.models.registry import ArchBundle
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel import context, groups, pipeline
from repro_torch.parallel import migrate as migrate_mod
from repro_torch.telemetry import OpClock, RankTelemetry, StageTelemetry
from repro_torch.train import steps as steps_mod
from repro_torch.utils.device import (DeviceLike, resolve_device,
                                      synchronize)


# the transport of the rank plan made without a plan: the cards' own links
PLAIN_TRANSPORT = "gpu"


class PlanWidthError(ValueError):
    """A plan whose ranks a replica do not divide the ranks present."""


@dataclasses.dataclass
class TrainerConfig:
    global_batch: int = 8
    seq_len: int = 64
    # None (unlike the JAX trainer's /tmp/repro_ckpt): no checkpoints, so
    # trainers built one after another never restore each other's states
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 10
    straggler_factor: float = 1.5
    straggler_patience: int = 5
    tp: int = 1
    # replan uses the accumulating online profile as the planner's cost
    # source once it holds at least this many folded layer-time
    # observations
    replan_profile_min_obs: float = 8.0
    # stage telemetry of the pipeline and rank steps: "auto" is "callback"
    # on the CPU and on the card (CUDA events do not sync the step);
    # "timer" folds bucketed step times; "off" records (and on ranks
    # gathers) nothing
    telemetry: str = "auto"
    # with a policy + aggregator attached, gather the cluster-wide
    # telemetry view — and run the adaptation decision + its broadcast —
    # every this many steps, at a step-synchronized point of run() that
    # EVERY process reaches at the same step (a collective invoked from a
    # data-dependent branch would deadlock processes whose policy state
    # diverged)
    aggregate_every: int = 1
    # bounded staleness for profile entries of DEPARTED device kinds: a
    # lost island's measurements are kept this many steps (a node that
    # rejoins inside the window gets its warm profile back), then dropped
    # from planning
    profile_stale_steps: int = 200


@dataclasses.dataclass(frozen=True)
class _AdoptedPlan:
    """Minimal ``_adopt`` argument for a plan that arrived through a
    broadcast adaptation directive rather than a local PlannerResult."""
    plan: ParallelPlan


def widen_plan(plan: ParallelPlan, world: int) -> ParallelPlan:
    """``plan`` over ``world`` ranks: a plan of ``pp * dp * tp`` ranks
    whose count divides ``world`` (and is smaller) gets ``dp * world /
    (pp * dp * tp)`` replicas of every stage, each of the same microbatch
    size, as the train CLI widens its searched plan (a cp plan's dp counts
    its ring ranks, so it gets more data groups and keeps its ring); any
    other plan as it is."""
    width = plan.pp * plan.dps[0] * plan.tps[0]
    if width >= world or world % width or len(set(plan.dps)) > 1:
        return plan
    k = world // width
    return dataclasses.replace(plan, stages=tuple(
        dataclasses.replace(st, dp=st.dp * k) for st in plan.stages))


def fit_to_card(cluster: ClusterSpec, search_kw: Dict[str, Any],
                hbm_gb: float):
    """The search of a replan on ranks on the cards: ``cluster`` with
    every device's memory ``hbm_gb`` (the card's), and ``search_kw`` with
    ``require_fit``, so that every stage of the plan fits the card its
    live state moves onto; a plan that cannot hold it ends the run."""
    cluster = dataclasses.replace(cluster, groups=tuple(
        dataclasses.replace(g, device=dataclasses.replace(
            g.device, hbm_gb=hbm_gb)) for g in cluster.groups))
    return cluster, dict(search_kw, require_fit=True)


class Trainer:
    def __init__(self, bundle: ArchBundle, cfg: TrainerConfig,
                 plan: Optional[ParallelPlan] = None,
                 opt_cfg: Optional[AdamWConfig] = None,
                 state: Optional[Dict[str, Any]] = None,
                 device: DeviceLike = None,
                 cluster: Optional[ClusterSpec] = None,
                 profile_store=None, policy=None, aggregator=None,
                 adapt_search_kw: Optional[Dict[str, Any]] = None,
                 obs=None):
        """``state``: a train state to start from (``steps.
        init_train_state``'s layout, e.g. ``convert.from_jax`` of a JAX
        state), copied to the device.  Default: the latest checkpoint in
        ``cfg.ckpt_dir``, else a fresh state from seed 0; a checkpoint and
        ``state`` together raise.  ``cluster``: the ClusterSpec the plan
        was searched on (stage -> device kind, the predictor's cluster);
        ``profile_store``: a ``profile.ProfileStore`` the run folds its
        observations into.  ``policy`` (``adapt.ReplanPolicy``) decides
        when to replan, ``aggregator`` (``adapt`` aggregators) gathers
        every process's folds into one view first and carries the
        decision, ``adapt_search_kw`` constrains the controller's
        searches; ``obs``: an ``obs.Observability``."""
        self.bundle = bundle
        self.cfg = cfg
        self.plan = plan
        self.cluster = cluster
        self.profile_store = profile_store
        # observability: None (the default) leaves every path as before
        self.obs = obs
        if obs is not None:
            obs.install_iccl()
        self.policy = policy
        self.aggregator = aggregator
        self.adapt_search_kw = dict(adapt_search_kw or {})
        self.adapt_log: list = []        # structured AdaptEvents
        self._adapt_seen = 0             # telemetry steps already shown
        # elastic membership: queued node-lost/node-joined events, the
        # healthy spec of each departed island, the last leadership answer
        self._membership_pending: list = []
        self._departed_groups: Dict[str, Any] = {}
        self._was_leader: Optional[bool] = None
        self._cluster_view = None        # cached aggregator.gather result
        self._store_tick_state = None    # delta basis of _store_stage_ticks
        self.opt_cfg = opt_cfg or AdamWConfig()
        self.device = resolve_device(device)
        self.data = SyntheticTokens(
            vocab_size=bundle.cfg.vocab_size, seq_len=cfg.seq_len,
            global_batch=cfg.global_batch, family=bundle.cfg.family,
            d_model=bundle.cfg.d_model,
            n_vision_tokens=bundle.cfg.n_vision_tokens)
        self.grid: Optional[groups.RankGrid] = None
        # on ranks: the process group's ranks the plan runs on (its rank
        # order), the plan they run, and each rank's device kind (the
        # kind of its stage's group; a departed rank keeps its kind)
        self._members: List[int] = (list(range(dist.get_world_size()))
                                    if self._ranks_active() else [])
        self._rplan: Optional[ParallelPlan] = None
        self._rank_kind: Dict[int, str] = {}
        self._rank_gather = False
        self.ckpt = (ckpt.AsyncCheckpointer(cfg.ckpt_dir) if cfg.ckpt_dir
                     else None)
        self._part: Optional[ckpt.RankPart] = None
        self._inject_scale: Dict[str, float] = {}
        self._inject_bubble = 1.0        # observed-bubble injection factor
        self._pred_bubble = None         # (plan, cluster, bubble) cache
        # the HEALTHY reference per device kind: telemetry folds are
        # tagged with their slowdown relative to it (obs_scale) and replan
        # cost sources project target degradations against it
        self._ref_tflops: Dict[str, float] = (
            {g.device.name: g.device.effective_tflops
             for g in cluster.groups} if cluster is not None else {})
        self.telemetry: Optional[StageTelemetry] = None
        self._ewma: Optional[float] = None
        self._slow = 0
        self.replans = 0
        self.migrations = {"memory": 0, "checkpoint": 0}
        # the last _adopt's timings and, on ranks, the move's bytes
        self.last_migration: Optional[Dict[str, Any]] = None
        self.step = 0
        self._build()
        if self.ckpt is None or not self._init_or_restore(state):
            self._init_state(state)

    def _init_state(self, state: Optional[Dict[str, Any]]) -> None:
        """This process's part of ``state``, or of a fresh one."""
        bundle = self.bundle
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
        elif self._ranks_active():      # outside the plan's ranks
            self.state = None
            return
        elif state is None:
            self.state = steps_mod.init_train_state(bundle,
                                                    device=self.device)
        else:   # a copy: the step updates its state in place
            self.state = adamw.tree_map(
                lambda t: t.to(self.device, copy=True), state)
        self.step = int(self.state["step"])
        self.data.state.step = self.step

    # ------------------------------------------------------ checkpoints ---
    def _latest_step(self) -> Optional[int]:
        """The checkpoint to start from.  On ranks, rank 0's, after it
        cleared the saves a crashed run left unfinished: every rank then
        agrees, and no rank writes before that cleanup."""
        if not self._ranks_active():
            return ckpt.latest_step(self.cfg.ckpt_dir)
        got = [None]
        if dist.get_rank() == 0:
            ckpt.clear_partial(self.cfg.ckpt_dir)
            got = [ckpt.latest_step(self.cfg.ckpt_dir)]
        dist.broadcast_object_list(got, src=0)
        return got[0]

    def _slices(self) -> Any:
        """This rank's ``rank_leaf_slices`` (one process: the whole
        state; a rank outside the plan: None); on ranks also this rank's
        part of later saves, numbered in the grid's rank order."""
        whole = steps_mod.train_state_shapes(self.bundle)
        if not self._ranks_active():
            return pipeline.rank_leaf_slices(
                whole, [self.bundle.cfg.num_layers], 0)
        g = self.grid
        if g is None:
            self._part = None
            return None
        slices = pipeline.rank_leaf_slices(
            whole, self.train_step.plan, g.stage, self.train_step.rules,
            g.model_rank, replica=g.replica, ring=g.ring)
        self._part = ckpt.RankPart(slices, whole, g.rank, len(g.ranks))
        return slices

    def _init_or_restore(self, state: Optional[Dict[str, Any]]) -> bool:
        """Restore the latest checkpoint of ``cfg.ckpt_dir``, this rank's
        elements only (the JAX trainer's ``_init_or_restore``); False when
        there is none.  Sets up this rank's part of later saves."""
        slices = self._slices()
        step = self._latest_step()
        if step is None:
            return False
        if state is not None:
            raise ValueError(f"{self.cfg.ckpt_dir} holds a checkpoint of "
                             f"step {step}: pass no state= to restore it, "
                             "or another ckpt_dir")
        self.state = None       # the old state's memory before the new
        extra = ckpt.manifest_extra(self.cfg.ckpt_dir, step)
        if slices is not None:
            self.state, extra = ckpt.restore_rank(self.cfg.ckpt_dir, step,
                                                  slices, self.device)
        if ckpt._norm_layout(extra.get("layout")) is not None:
            self.migrations["checkpoint"] += 1
        self.data.state = DataState.from_dict(extra["data"])
        self.step = step
        return True

    def _ckpt_extra(self) -> Dict[str, Any]:
        # every route keeps the canonical layout
        return {"data": self.data.state.to_dict(), "layout": None}

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

    @property
    def run_plan(self) -> Optional[ParallelPlan]:
        """The plan the step runs: on ranks the rank plan (``plan``
        widened to the ranks present), else ``plan``.  ``plan`` stays the
        searched plan, the search's baseline."""
        return self._rplan if self._ranks_active() else self.plan

    def _rank_plan(self, n: int) -> ParallelPlan:
        """The plan ``n`` ranks run: this workload's plan, widened to them
        (``widen_plan``), else one stage of every layer over ``n / tp``
        replicas of ``tp`` ranks."""
        plan, tp = self.plan, self.cfg.tp
        if self._pipeline_active() or (
                plan is not None and plan.pp == 1
                and plan.global_batch == self.cfg.global_batch
                and plan.seq_len == self.cfg.seq_len):
            return widen_plan(plan, n)
        if n % tp:
            raise ValueError(f"world size {n} is no multiple of tp {tp}")
        dp = n // tp
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
        try:    # enc-dec and VLM raise NotImplementedError: no fall back
            context.check_cp_supported(self.bundle.cfg)
        except ValueError:
            return False
        return True

    def _telemetry_mode(self) -> str:
        mode = self.cfg.telemetry
        if mode not in ("auto", "callback", "timer", "off"):
            raise ValueError(f"unknown telemetry mode {mode!r}; valid "
                             "modes: ('auto', 'callback', 'timer', 'off')")
        return "callback" if mode == "auto" else mode

    def _build(self):
        loss_fn = None
        self.telemetry = None
        mode = self._telemetry_mode()
        if self._ranks_active():
            self._build_ranks(mode)
            self._on_plan_adopted()
            return
        if self.cfg.tp > 1:
            raise ValueError(f"TrainerConfig.tp {self.cfg.tp} runs on ranks: "
                             "initialise torch.distributed over pp x dp x tp "
                             "processes")
        if self._pipeline_active():
            plan = self.plan
            if mode != "off":
                self.telemetry = StageTelemetry(plan.pp, plan.vpp,
                                                plan.micro_batches, mode=mode)
                if self.obs is not None:
                    # the observed-lane tap rides the recorder's own
                    # endpoint: no more work in the step
                    self.telemetry.sink = self.obs.make_telemetry_sink(
                        plan, self._stage_kinds(), self.telemetry.mode,
                        scales_fn=self._stage_scales)
            # only callback mode marks ticks in the loss
            loss_fn = pipeline.make_pp_loss_fn(
                self.bundle.cfg, plan.pp, plan.micro_batches,
                layers_per_stage=list(plan.virtual_layers), vpp=plan.vpp,
                stage_tp=list(plan.tps),
                telemetry=self.telemetry if mode == "callback" else None)
        elif self._cp_active():
            loss_fn = context.make_cp_loss_fn(self.bundle.cfg,
                                              self.plan.cp_chunk_sizes)
        self.train_step = steps_mod.make_train_step(
            self.bundle, self.opt_cfg, loss_fn=loss_fn)
        self._on_plan_adopted()

    def _build_ranks(self, mode: str) -> None:
        """The rank route's grid and step over ``_members`` (every process
        of the group calls this at once); a process outside them holds no
        grid and no step."""
        n, tp = len(self._members), self.cfg.tp
        plan = self._rank_plan(n)
        pipeline.check_rank_plan(self.bundle.cfg, plan)
        if plan.tps[0] != tp:
            raise ValueError(f"plan {plan.describe()} has stage tp "
                             f"{plan.tps}, the trainer tp {tp}")
        if n != plan.pp * plan.dps[0] * tp:
            raise ValueError(f"world size {n} is not pp {plan.pp} x "
                             f"dp {plan.dps[0]} x tp {tp}")
        if self.cfg.global_batch % plan.tokens_per_tick:
            raise ValueError(f"global batch {self.cfg.global_batch} does "
                             f"not split over dp {plan.dps[0]} x "
                             f"micro_bs {plan.micro_bs}")
        self._rplan = plan
        self.grid = groups.make_rank_grid(
            plan.pp, plan.dps[0] // plan.cp, self.device, tp=tp,
            ranks=self._members, cp=plan.cp)
        if self.cluster is not None and self.plan is not None:
            per_stage = plan.dps[0] * tp
            for i, r in enumerate(self._members):
                st = plan.stages[i // per_stage]
                self._rank_kind[r] = self.cluster.groups[st.group].device.name
        # each process records its own pod: its ops, gathered a step
        # into the store (no store, nothing to fold: no recorder); every
        # process of the group enters that gather.  Only at pp > 1: a
        # pp 1 plan, cp ring or not, has no stages to observe and takes
        # no recorder
        self._rank_gather = (plan.pp > 1 and mode != "off"
                             and self.profile_store is not None)
        if self.grid is None:
            self.train_step = None
            return
        self.train_step = pipeline.PPRankStep(
            self.bundle.cfg, plan, self.grid, self.opt_cfg)
        if self._rank_gather:
            m = plan.micro_batches
            if mode == "timer":
                self.telemetry = StageTelemetry(plan.pp, plan.vpp, m,
                                                mode="timer")
            else:
                self.telemetry = RankTelemetry(plan.pp, plan.vpp, m)
                self.train_step.clock = OpClock(self.device)

    def _on_plan_adopted(self) -> None:
        """A (re)build is a plan adoption: the predicted lane and a plan
        record (the plan the step runs)."""
        if self.obs is not None and self._pipeline_active() \
                and self.cluster is not None:
            self.obs.on_plan_adopted(self.step, self.run_plan, self.cluster,
                                     self.bundle.cfg, self._stage_kinds())

    # ------------------------------------------------------------- run ----
    def _device_batch(self, np_batch: Dict[str, np.ndarray]):
        """The step's batch on the device: the frontend stubs' float
        inputs (``frames``, ``image_embeds``) in the activation dtype, as
        JAX's ``_device_batch`` casts them."""
        m = None
        if self._pipeline_active():
            m = self.run_plan.micro_batches
        adtype = self.bundle.cfg.adtype

        def put(k, v):
            if m is not None:   # the pipeline consumes (m, B_tick, ...)
                v = v.reshape(m, v.shape[0] // m, *v.shape[1:])
            if self.grid is not None:   # this replica's rows (of each)
                rows = v if m is None else v.swapaxes(0, 1)
                b = rows.shape[0] // self.grid.dp
                r = self.grid.replica
                rows = rows[r * b:(r + 1) * b]
                v = rows if m is None else rows.swapaxes(0, 1)
            t = torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
            return t.to(adtype) if k in ("frames", "image_embeds") else t

        return {k: put(k, v) for k, v in np_batch.items()}

    def run(self, n_steps: int,
            on_straggler: Optional[Callable[["Trainer"], None]] = None
            ) -> Dict[str, Any]:
        """``n_steps`` train steps; returns {"losses", "grad_norms",
        "step", "step_s"} (each step's wall time, ending when its loss is
        on the host; the global gradient norm AdamW clipped by).  With a
        ``profile_store`` each step's observations are folded into it; a
        step slower than ``straggler_factor`` times the EWMA of the step
        times counts as slow, and ``on_straggler(self)`` is called after
        ``straggler_patience`` slow steps in a row.  With a policy, an
        aggregator or a queued membership event, the adaptation loop runs
        at its cadence.  With ``cfg.ckpt_dir``, a background save after
        every step that ``cfg.ckpt_every`` divides, all waited for at the
        end.  A rank outside the plan takes no step (and reports no loss)
        but enters every collective of the steps."""
        try:
            return self._run(n_steps, on_straggler)
        except Exception as e:
            # a wedged schedule is the flight recorder's primary customer
            from repro_torch.core.simulator import ScheduleError
            if self.obs is not None and isinstance(e, ScheduleError):
                self.obs.flight_dump("schedule-error")
            raise

    def _run(self, n_steps: int,
             on_straggler: Optional[Callable[["Trainer"], None]] = None
             ) -> Dict[str, Any]:
        losses, norms, step_s = [], [], []
        for _ in range(n_steps):
            t0 = time.perf_counter()
            member = self.train_step is not None
            if member:
                batch = self._device_batch(self.data.batch_at(self.step))
                self.state, metrics = self.train_step(self.state, batch)
                losses.append(float(metrics["loss"]))
                synchronize(self.device)
            dt = time.perf_counter() - t0
            self.step += 1
            self.data.state.step = self.step
            if member:
                step_s.append(dt)
                norms.append(float(metrics["grad_norm"]))
                dt = self._observe(dt)
                if self.profile_store is not None:
                    self._refine_profile(dt)
            elif self._rank_gather:
                self._observe_outside()
            if self.profile_store is not None:
                # bounded staleness ticks with or without a controller
                self._expire_stale_profiles()
            if member:
                self._straggler(dt, on_straggler)
            # --- autonomous adaptation (the adapt closed loop) ---
            # membership events ride the same machinery with or without a
            # policy: a node loss is a topology FACT, not a policy call
            if self.policy is not None or self.aggregator is not None \
                    or self._membership_pending:
                # BOTH collectives of the loop — the telemetry gather and
                # the decision broadcast inside _maybe_adapt — run HERE,
                # unconditionally on a step cadence: self.step is the
                # same on every process, so every process enters them
                # together (policy/telemetry state may diverge per
                # process and must never gate a collective)
                # (the port gathers without a policy too: a membership
                # search reads the view, on the leader alone)
                on_cadence = (self.step
                              % max(1, self.cfg.aggregate_every) == 0)
                if self.aggregator is not None \
                        and self.profile_store is not None and on_cadence:
                    self._cluster_view = self.aggregator.gather(
                        self.profile_store)
                if on_cadence or \
                        not getattr(self.aggregator, "collective", False):
                    self._maybe_adapt()
            if self.obs is not None:
                self.obs.on_step(self.step, dt, self.schedule_health())
            if self.ckpt is not None and self.train_step is not None and \
                    self.step % self.cfg.ckpt_every == 0:
                self.ckpt.save_async(self.step, self.state,
                                     extra=self._ckpt_extra(),
                                     part=self._part)
        if self.ckpt is not None:
            self.ckpt.wait()
        if self.profile_store is not None and self.profile_store.path:
            self.profile_store.save()
        return {"losses": losses, "grad_norms": norms, "step": self.step,
                "step_s": step_s}

    def _straggler(self, dt: float,
                   on_straggler: Optional[Callable[["Trainer"], None]]
                   ) -> None:
        """Straggler detection: observed vs EWMA-expected step time."""
        if self._ewma is None:
            self._ewma = dt
            return
        if dt > self.cfg.straggler_factor * self._ewma:
            self._slow += 1
        else:
            self._slow = 0
        self._ewma = 0.9 * self._ewma + 0.1 * dt
        if self._slow >= self.cfg.straggler_patience:
            self._slow = 0
            if on_straggler is not None:
                on_straggler(self)

    def _observe(self, dt: float) -> float:
        """After the step's own synchronize: the card's tick marks resolve
        into the recorder.  On ranks with a recorder (a ``profile_store``,
        pp > 1, telemetry not "off") every rank gathers every rank's
        report (its stage's op times, its step time) here, at the same
        point of every rank's step, over ``torch.distributed`` (outside
        the ICCL tap), records the same view, and takes the slowest
        rank's step time as the step's.  Returns the step time to fold."""
        tel = self.telemetry
        if self.grid is None:
            if tel is not None:
                tel.resolve()
            return dt
        if tel is None:         # telemetry off, pp 1 or no store
            return dt
        mine: Dict[str, Any] = {"dt": dt}
        clock = self.train_step.clock
        resolved = clock.resolve() if clock is not None else None
        if isinstance(tel, RankTelemetry) and resolved is not None:
            mine.update(tel.report(self.grid.stage, resolved))
        got: List[Any] = [None] * dist.get_world_size()
        dist.all_gather_object(got, mine)
        if isinstance(tel, RankTelemetry) and resolved is not None:
            tel.observe(got)
        return max(r["dt"] for r in got if r is not None)

    def _observe_outside(self) -> None:
        """A rank outside the plan's ranks enters the per-step gather of
        ``_observe`` with nothing to report."""
        got: List[Any] = [None] * dist.get_world_size()
        dist.all_gather_object(got, None)

    # ------------------------------------- online profile refinement ------
    def _folds_whole(self) -> bool:
        """Whether this process folds the whole step's observations: on
        ranks whose views an aggregator gathers (``collective``), only the
        plan's first rank does, so that the gathered view holds each once;
        elsewhere every process does (on ranks every rank then folds the
        same gathered view)."""
        return (self.grid is None
                or not getattr(self.aggregator, "collective", False)
                or self.grid.rank == 0)

    def _refine_profile(self, dt: float):
        """Fold one observed step time into the profile (running mean
        keyed by the exact workload shape), plus a per-layer estimate the
        ProfiledCostModel can interpolate.  The first step after a
        (re)build is excluded: it pays warm-up, not steady-state time."""
        if self._ewma is None:
            return
        from repro_torch.profile.runner import device_kind
        dev = device_kind(self.device)
        cfgm = self.bundle.cfg
        if self._folds_whole():
            shape = {"arch": cfgm.name, "seq_len": self.cfg.seq_len,
                     "global_batch": self.cfg.global_batch,
                     "tp": self.cfg.tp}
            self.profile_store.fold(dev, "observed_step", shape, "time_s",
                                    dt)
            # per-layer per-SEQUENCE time; obs_scale tags the REAL
            # slowdown of this host's kind only (injection distorts
            # telemetry, never the measured wall time)
            self.profile_store.fold(
                dev, "observed_layer_step",
                {"arch": cfgm.name, "seq_len": self.cfg.seq_len,
                 "tp": self.cfg.tp},
                "per_seq_s", dt / (max(cfgm.num_layers, 1)
                                   * self.cfg.global_batch),
                also={"obs_scale": self._model_scale(dev)})
        if self.telemetry is not None:
            self.telemetry.observe_step(dt)    # no-op in callback mode
            self._fold_telemetry(dev)

    def _fold_telemetry(self, dev: str):
        """Fold fresh stage observations as ``observed_stage_tick`` /
        ``observed_bubble`` entries, every stage under this process's
        device kind.  One process keeps the JAX trainer's keys (each
        stage's padded depth ``vpp * max layers``); on ranks a stage runs
        only its own layers, which are its depth.  On ranks under a
        collective aggregator a stage's first rank folds its stage's
        ticks and the plan's first rank the bubble (each process folds
        its own pod, as in the JAX trainer's deployments)."""
        plan, rplan = self.plan, self.run_plan
        vl = list(rplan.virtual_layers)
        lmax = max(vl)
        padded = ([sum(vl[s::rplan.pp]) for s in range(rplan.pp)]
                  if self.grid is not None else [rplan.vpp * lmax] * rplan.pp)
        obs = self._obs_scales()
        stages = None
        g = self.grid
        if g is not None and getattr(self.aggregator, "collective", False):
            stages = [g.stage] if g.replica == 0 and g.model_rank == 0 else []
        folded = self.telemetry.fold_into(
            self.profile_store, [dev] * rplan.pp,
            arch=self.bundle.cfg.name, seq_len=self.cfg.seq_len,
            tp=self.cfg.tp, schedule=rplan.schedule,
            layers_per_vstage=vl, padded_per_stage=padded,
            micro_bs_per_stage=[plan.stage_micro_bs(i)
                                for i in range(plan.pp)],
            stage_scale=(self._stage_scales()
                         if self._inject_scale else None),
            stage_obs_scale=(
                [obs.get(self.cluster.groups[st.group].device.name, 1.0)
                 for st in plan.stages]
                if self.cluster is not None else None),
            stages=stages, bubble=self._folds_whole())
        if self.obs is not None:
            self.obs.on_fold(self.step, folded, dev)

    # ------------------------------------------------ degradation hooks ---
    def inject_degrade(self, device_kind: str, factor: float) -> None:
        """Straggler INJECTION: make the telemetry report ``device_kind``'s
        stages as ``factor``x slower from now on (a card cannot be made
        slower on demand; the observations it distorts are what degraded
        hardware would produce).  Injections compose multiplicatively per
        kind; requires a cluster (to map stages to kinds)."""
        if self.cluster is None:
            raise ValueError("inject_degrade needs a cluster "
                             "(stage -> device kind mapping)")
        if factor <= 0:
            raise ValueError(f"factor must be > 0, got {factor}")
        if all(g.device.name != device_kind for g in self.cluster.groups):
            known = sorted({g.device.name for g in self.cluster.groups})
            raise ValueError(f"unknown device kind {device_kind!r}; "
                             f"cluster has {known}")
        self._inject_scale[device_kind] = \
            self._inject_scale.get(device_kind, 1.0) * factor

    def inject_link_degrade(self, factor: float) -> None:
        """Boundary-link INJECTION: make the OBSERVED pipeline bubble
        report ``factor``x the recorder's value from now on (a slowed
        inter-island link stretches the idle ticks, not the stage
        compute).  Factors compose multiplicatively."""
        if factor <= 0:
            raise ValueError(f"factor must be > 0, got {factor}")
        self._inject_bubble *= factor

    # -------------------------------- elastic membership (node loss/join) --
    def lose_node(self, device_kind: str, *, rank: Optional[int] = None
                  ) -> None:
        """Membership FACT: ``device_kind``'s island left the cluster.
        Queues a ``node-lost`` event; at the next adaptation cadence the
        surviving leader forces a replan onto the surviving topology
        (dp-width and pp-depth changes allowed) and every process
        live-migrates — no restart.  The island's healthy spec is
        remembered so ``join_node`` can restore it, and its profile
        entries enter the bounded-staleness window.

        ``rank``: a process rank hosted on the lost island, removed from
        the aggregator's surviving set at once, so leadership re-elects
        (lowest surviving rank) BEFORE the directive for this very event
        must be originated.  On ranks the ranks of the island (those
        whose stage's group is ``device_kind``) are removed with it.
        Every process must be told the same facts."""
        if self.cluster is None:
            raise ValueError("lose_node needs a cluster")
        if all(g.device.name != device_kind for g in self.cluster.groups):
            known = sorted({g.device.name for g in self.cluster.groups})
            raise ValueError(f"unknown device kind {device_kind!r}; "
                             f"cluster has {known}")
        if len(self.cluster.groups) == 1:
            raise ValueError(f"cannot lose {device_kind!r}: it is the "
                             "last island in the cluster")
        ranks = [r for r in self._members
                 if self._rank_kind.get(r) == device_kind]
        if rank is not None:
            ranks.append(rank)
        if hasattr(self.aggregator, "lose_rank"):
            for r in dict.fromkeys(ranks):
                self.aggregator.lose_rank(r)
        self._membership_pending.append(
            {"op": "lost", "kind": device_kind})

    def join_node(self, device_kind: Optional[str] = None, *,
                  group=None, rank: Optional[int] = None) -> None:
        """Membership FACT: an island (re)joined the cluster.  By
        ``device_kind`` it restores the remembered healthy spec of an
        island ``lose_node`` removed earlier (on ranks, with the ranks
        that left with it); a brand-new island joins by explicit
        ``group`` (a ``NodeGroup``; one process only: on ranks it has no
        ranks).  Queues a ``node-joined`` event: the leader forces a
        replan on the grown topology.  ``rank`` restores a previously
        lost process rank in the aggregator."""
        if self.cluster is None:
            raise ValueError("join_node needs a cluster")
        if group is None:
            if device_kind is None:
                raise ValueError("join_node needs a device_kind (rejoin) "
                                 "or an explicit group=NodeGroup")
            group = self._departed_groups.get(device_kind)
            if group is None:
                raise ValueError(
                    f"no departed island of kind {device_kind!r} to "
                    f"rejoin (departed: "
                    f"{sorted(self._departed_groups)}); pass "
                    f"group=NodeGroup(...) for a brand-new island")
        elif self._ranks_active():
            raise ValueError("a brand-new island has no ranks in this "
                             "process group: rejoin a departed kind")
        ranks = [r for r, k in self._rank_kind.items()
                 if k == group.device.name and r not in self._members]
        if rank is not None:
            ranks.append(rank)
        if hasattr(self.aggregator, "rejoin_rank"):
            for r in dict.fromkeys(ranks):
                self.aggregator.rejoin_rank(r)
        self._membership_pending.append(
            {"op": "joined", "group": group.to_dict()})

    def _present(self, cluster: ClusterSpec) -> List[int]:
        """On ranks, the ranks a plan on ``cluster`` runs on: those whose
        device kind is one of its groups' (every member while the kinds
        are unknown)."""
        if not self._rank_kind:
            return list(self._members)
        kinds = {g.device.name for g in cluster.groups}
        return sorted(r for r, k in self._rank_kind.items() if k in kinds)

    def _stage_kinds(self):
        """Per-PHYSICAL-stage device kind names ("?" without a cluster)."""
        if self.cluster is None or self.plan is None:
            return ["?"] * (self.plan.pp if self.plan else 0)
        return [self.cluster.groups[st.group].device.name
                for st in self.plan.stages]

    def _stage_scales(self):
        """Per-PHYSICAL-stage injected tick multipliers (1.0 = healthy)."""
        if self.cluster is None or self.plan is None:
            return [1.0] * (self.plan.pp if self.plan else 0)
        return [self._inject_scale.get(
            self.cluster.groups[st.group].device.name, 1.0)
            for st in self.plan.stages]

    def _model_scale(self, kind: str) -> float:
        """Slowdown of ``kind`` the CURRENT cluster spec models, relative
        to the healthy reference (1.0 when healthy or not a cluster
        kind)."""
        if self.cluster is None:
            return 1.0
        for g in self.cluster.groups:
            if g.device.name == kind and g.device.effective_tflops > 0:
                ref = self._ref_tflops.get(kind, g.device.effective_tflops)
                return ref / g.device.effective_tflops
        return 1.0

    def _obs_scales(self) -> Dict[str, float]:
        """Per-device-kind slowdown the current telemetry folds are
        OBSERVED under, relative to the healthy reference: injection and
        an adopted cluster degradation describe the same slowdown, so the
        scale is whichever has caught up further."""
        out: Dict[str, float] = {}
        kinds = set(self._inject_scale)
        if self.cluster is not None:
            kinds |= {g.device.name for g in self.cluster.groups}
        for k in kinds:
            s = max(self._inject_scale.get(k, 1.0), self._model_scale(k))
            if abs(s - 1.0) > 1e-12:
                out[k] = s
        return out

    def _merged_store(self):
        """The cluster-wide profile view: every process's folds gathered
        into one store (identity on one process / without an
        aggregator).  The adaptive loop refreshes it at its cadence (and
        ``plan_for`` on ranks before its search) and this serves the
        cached copy; the lazy fallback only gathers through an aggregator
        that is no collective: a search runs on the leader alone."""
        if self.profile_store is None or self.aggregator is None:
            return self.profile_store
        if self._cluster_view is not None:
            return self._cluster_view
        if getattr(self.aggregator, "collective", False):
            return self.profile_store
        return self.aggregator.gather(self.profile_store)

    def _stage_tick_obs(self):
        """Per-PHYSICAL-stage forward tick seconds (each stage's vpp
        chunks summed, injected degradation applied) — the policy's
        straggler signal.  One process (and ranks without a collective
        aggregator): the recorder's most recent observation (on ranks the
        gathered view of every stage).  With a collective aggregator the
        ticks come from the gathered cluster view.  None before the first
        kept/gathered observation."""
        if getattr(self.aggregator, "collective", False):
            return self._store_stage_ticks()
        ticks = self.telemetry.stage_ticks() if self.telemetry else None
        if ticks is None:
            return None
        pp, vpp = self.telemetry.pp, self.telemetry.vpp
        scales = self._stage_scales()
        return [scales[i] * sum(ticks[ch * pp + i] for ch in range(vpp))
                for i in range(pp)]

    def _store_stage_ticks(self):
        """Per-physical-stage tick times reconstructed from the gathered
        cluster view (``observed_stage_tick`` folds of EVERY process, raw
        degradation as observed).  The policy is fed the DELTA between
        consecutive evaluations: (sum n*mean)_now minus (sum n*mean)_prev
        per stage, the mean of the folds that arrived since the last look.
        None until every stage of the executing plan has fresh
        observations."""
        store = self._merged_store()
        if store is None:
            return None
        plan, cfgm = self.run_plan, self.bundle.cfg
        sums = [0.0] * plan.pp
        ns = [0.0] * plan.pp
        for e in store.entries(op="observed_stage_tick"):
            s = e.shape
            if (s.get("arch") != cfgm.name
                    or s.get("seq_len") != self.cfg.seq_len
                    or s.get("tp") != self.cfg.tp
                    or s.get("schedule") != plan.schedule
                    or s.get("pp") != plan.pp or s.get("vpp") != plan.vpp
                    or "tick_s" not in e.value):
                continue
            i = s.get("stage", -1)
            if not 0 <= i < plan.pp:
                continue
            n = e.value.get("n", 1.0)
            sums[i] += n * e.value["tick_s"]
            ns[i] += n
        prev = self._store_tick_state
        self._store_tick_state = (ns, sums)
        if prev is not None and len(prev[0]) == len(ns):
            d_n = [a - b for a, b in zip(ns, prev[0])]
            d_s = [a - b for a, b in zip(sums, prev[1])]
            if all(d > 0.0 for d in d_n):
                return [s / n for s, n in zip(d_s, d_n)]
            return None       # no fresh folds everywhere since last look
        if any(n <= 0.0 for n in ns):
            return None
        return [t / n for t, n in zip(sums, ns)]

    # ------------------------------------ autonomous adaptation (adapt) ---
    def _emit(self, event) -> None:
        self.adapt_log.append(event)
        if self.obs is not None:
            self.obs.on_adapt_event(event)

    def _adapt_leader(self) -> bool:
        """Whether THIS process runs the policy/search: the aggregator
        names the one leader; without an aggregator every trainer is its
        own leader."""
        if self.aggregator is None:
            return True
        return getattr(self.aggregator, "is_leader", lambda: True)()

    def _leader_rank(self) -> int:
        """On ranks, the rank that searches: the aggregator's leader,
        else rank 0."""
        return getattr(self.aggregator, "leader_rank", lambda: 0)()

    def _maybe_adapt(self) -> None:
        """One pass of the closed loop, CLUSTER-SYMMETRIC by construction:
        the leader turns queued membership events into directives
        (forced — topology facts carry no ε gate), else consults the
        policy on its new telemetry, searches and ε-gates; the directive
        — or None — is then BROADCAST through the aggregator and every
        process applies it (or skips) together.  Leadership is
        re-evaluated every pass: when the previous leader's rank was lost,
        the lowest surviving rank answers ``is_leader()``, logs a
        ``re-elect`` event and originates the directives."""
        if self.cluster is None:
            return       # nothing to replan against without a cluster
        self._expire_stale_profiles()
        lead = self._adapt_leader()
        if lead and self._was_leader is False:
            from repro_torch.adapt import AdaptEvent
            self._emit(AdaptEvent(
                self.step, "re-elect",
                "this process is now the adaptation leader "
                "(lowest surviving rank)",
                {"leader_rank": self._leader_rank()}))
        self._was_leader = lead
        directive = None
        if lead:
            directive = self._membership_directive()
            if directive is None and self.policy is not None \
                    and self.telemetry is not None \
                    and self._pipeline_active():
                directive = self._adapt_decide()
        if self.aggregator is not None:
            directive = self.aggregator.broadcast(directive)
        if directive is None:
            return
        if directive.get("membership"):
            self._apply_membership(directive)
        else:
            self._adapt_apply(directive)

    def _membership_directive(self) -> Optional[Dict[str, Any]]:
        """LEADER ONLY: turn the oldest queued membership event into an
        adoption directive — edit the cluster, force a replan on the
        edited topology (no ε gate: membership is a fact) and ship the
        searched plan.  The incumbent plan is dropped as the search
        baseline across a LOSS (group indices shift when an island is
        removed)."""
        from repro_torch.adapt import AdaptEvent
        from repro_torch.core.cluster import NodeGroup
        while self._membership_pending:
            ev = self._membership_pending.pop(0)
            if ev["op"] == "lost":
                new_cluster = self.cluster.remove_group(ev["kind"])
                search_kw = dict(self.adapt_search_kw,
                                 baseline_plan=None)
            else:
                group = NodeGroup.from_dict(ev["group"]).healthy
                new_cluster = self.cluster.add_group(group)
                search_kw = dict(self.adapt_search_kw)
            try:
                result = self._search(
                    new_cluster, global_batch=self.cfg.global_batch,
                    seq_len=self.cfg.seq_len, **search_kw)
            except (RuntimeError, PlanWidthError) as e:
                # no feasible plan on the edited topology under the
                # configured search space: keep training on the incumbent
                self._emit(AdaptEvent(
                    self.step, "skip",
                    f"membership {ev['op']} search failed: {e}",
                    {"membership": dict(ev)}))
                continue
            gain = result.expected_gain
            self._emit(AdaptEvent(
                self.step, "replan",
                f"membership {ev['op']}: searched {result.evaluated} "
                f"candidates (forced, no ε gate)",
                {"winner": result.plan.describe(),
                 "iter_time": result.prediction.iter_time,
                 "baseline_time": result.baseline_time,
                 "expected_gain": (round(gain, 4) if gain is not None
                                   else None)}))
            return {"membership": dict(ev),
                    "plan": result.plan.to_dict()}
        return None

    def _apply_membership(self, directive: Dict[str, Any]) -> None:
        """EVERY process: commit a broadcast membership directive — the
        same cluster edit, the leader's searched plan, a live migration.
        The profile entries of a departed kind enter the
        bounded-staleness window; a rejoined kind's mark clears."""
        from repro_torch.adapt import AdaptEvent
        from repro_torch.core.cluster import NodeGroup
        mem = directive["membership"]
        plan = ParallelPlan.from_dict(directive["plan"])
        if mem["op"] == "lost":
            kind = mem["kind"]
            for g in self.cluster.groups:
                if g.device.name == kind:
                    self._departed_groups[kind] = g.healthy
            new_cluster = self.cluster.remove_group(kind)
            if self.profile_store is not None:
                self.profile_store.mark_departed(kind, self.step)
            self._inject_scale.pop(kind, None)   # the island is gone
            self._emit(AdaptEvent(
                self.step, "node-lost",
                f"island {kind} left the cluster",
                {"kind": kind,
                 "surviving": [g.device.name
                               for g in new_cluster.groups]}))
        else:
            group = NodeGroup.from_dict(mem["group"]).healthy
            kind = group.device.name
            new_cluster = self.cluster.add_group(group)
            if self.profile_store is not None:
                self.profile_store.mark_rejoined(kind)
            self._departed_groups.pop(kind, None)
            self._emit(AdaptEvent(
                self.step, "node-joined",
                f"island {kind} joined the cluster",
                {"kind": kind,
                 "groups": [g.device.name for g in new_cluster.groups]}))
        # a follower told the same fact locally must not re-raise it
        self._membership_pending = [
            ev for ev in self._membership_pending
            if not (ev["op"] == mem["op"]
                    and (ev.get("kind") == mem.get("kind")
                         or ev.get("group", {}).get("device", {})
                         .get("name") == kind))]
        self._adopt(_AdoptedPlan(plan), new_cluster, migrate="memory")
        if self.policy is not None:
            self.policy.reset(self.step)
        self._adapt_seen = 0
        self._store_tick_state = None    # new plan: fresh delta basis
        self._emit(AdaptEvent(
            self.step, "migrate",
            f"adopted the post-{mem['op']} plan live",
            {"plan": plan.describe(),
             "migrations": dict(self.migrations)}))

    def _adapt_decide(self) -> Optional[Dict[str, Any]]:
        """LEADER ONLY: consult the policy on each NEW telemetry
        observation; when it fires, search — and return an adoption
        directive only if the predicted gain clears the policy's ε gate.
        The decision trail lands in ``adapt_log``."""
        from repro_torch.adapt import AdaptEvent
        if self.telemetry.steps <= self._adapt_seen:
            return None                   # no new observation this step
        self._adapt_seen = self.telemetry.steps
        health = self.schedule_health()
        decision = self.policy.observe(
            self.step, self._stage_tick_obs(),
            bubble_ratio=(health["ratio"] if health else None),
            provenance=("bucketed" if self.telemetry.mode == "timer"
                        else "exact"))
        if decision is None:
            return None
        self._emit(AdaptEvent(
            self.step, "trigger", decision.reason,
            {"action": decision.action,
             "signal": round(decision.signal, 4),
             **({"stage": decision.stage,
                 "factor": decision.factor}
                if decision.stage is not None else {})}))
        if decision.action == "replan-straggler":
            g = self.cluster.groups[self.plan.stages[decision.stage].group]
            kind = g.device.name
            # ship the product: a second REAL slowdown on an already
            # degraded kind lands in full (degrade is absolute)
            factor = decision.factor * g.device.slowdown
            new_cluster = self.cluster.degrade(kind, factor)
        else:
            # wrong-schedule signal: same cluster, re-score the schedules
            kind = factor = None
            new_cluster = self.cluster
        try:
            result = self._search(
                new_cluster, global_batch=self.cfg.global_batch,
                seq_len=self.cfg.seq_len, **self.adapt_search_kw)
        except (RuntimeError, PlanWidthError) as e:
            # no feasible plan: keep training on the incumbent; cooldown
            # so the armed signal doesn't re-search every step
            self.policy.reject(self.step)
            self._emit(AdaptEvent(self.step, "skip",
                                  f"search failed: {e}", {}))
            return None
        gain = result.expected_gain
        self._emit(AdaptEvent(
            self.step, "replan", f"searched {result.evaluated} candidates",
            {"winner": result.plan.describe(),
             "iter_time": result.prediction.iter_time,
             "baseline_time": result.baseline_time,
             "expected_gain": (round(gain, 4) if gain is not None
                               else None)}))
        if not self.policy.gain_ok(result):
            self.policy.reject(self.step)
            self._emit(AdaptEvent(
                self.step, "skip",
                f"expected gain {gain:.4f} below min_gain "
                f"{self.policy.cfg.min_gain} — migration not worth it",
                {"expected_gain": round(gain, 4),
                 "min_gain": self.policy.cfg.min_gain}))
            return None
        # JSON-serializable directive: what every process must adopt
        return {"kind": kind, "factor": factor,
                "plan": result.plan.to_dict()}

    def _adapt_apply(self, directive: Dict[str, Any]) -> None:
        """EVERY process: commit a broadcast directive — rebuild the
        degraded cluster from (kind, factor), deserialize the leader's
        plan, and enter the collective adoption together."""
        from repro_torch.adapt import AdaptEvent
        plan = ParallelPlan.from_dict(directive["plan"])
        new_cluster = (self.cluster.degrade(directive["kind"],
                                            directive["factor"])
                       if directive.get("kind") else self.cluster)
        self._adopt(_AdoptedPlan(plan), new_cluster, migrate="memory")
        self.policy.reset(self.step)
        self._adapt_seen = 0
        self._store_tick_state = None    # new plan: fresh delta basis
        self._emit(AdaptEvent(
            self.step, "migrate", "adopted the searched plan live",
            {"plan": plan.describe(),
             "migrations": dict(self.migrations)}))

    # ----------------------------------------------- schedule diagnostics --
    def schedule_health(self) -> Optional[Dict[str, float]]:
        """Observed vs predicted bubble for the executing plan — the
        signal that separates "slow kernels" (stage ticks up, bubble flat)
        from "wrong schedule" (bubble above prediction).  None before any
        observation, without a cluster+plan to predict against, and on a
        rank outside the plan."""
        if self.cluster is None or not self._pipeline_active() or \
                self.run_plan is None:
            return None
        plan = self.run_plan    # on ranks, the widened plan they run
        observed = self.telemetry.bubble() if self.telemetry else None
        if observed is None and self.profile_store is not None and \
                not (self._ranks_active() and self.grid is None):
            from repro_torch.profile.model import ProfiledCostModel
            from repro_torch.profile.runner import device_kind
            observed = ProfiledCostModel(self._merged_store()).observed_bubble(
                device_kind(self.device), self.bundle.cfg,
                plan.schedule, plan.pp, plan.vpp, plan.micro_batches)
        if observed is None:
            return None
        observed *= self._inject_bubble
        cached = self._pred_bubble
        if cached is not None and cached[0] is plan \
                and cached[1] is self.cluster:
            predicted = cached[2]
        else:
            from repro_torch.core.predictor import PerformancePredictor
            predicted = PerformancePredictor(
                self.cluster, self.bundle.cfg,
                include_tp_comm=False).predict(plan).bubble_frac
            self._pred_bubble = (plan, self.cluster, predicted)
        return {"observed_bubble": observed, "predicted_bubble": predicted,
                "ratio": observed / max(predicted, 1e-9)}

    # --------------------------------------------- replan cost sourcing ---
    def _degrade_scales(self, new_cluster: ClusterSpec) -> Dict[str, float]:
        """Per-device-name time scales projecting the profile's
        reference-healthy served times onto the new cluster: a kind whose
        effective TFLOPs sits f-times below the healthy reference serves
        its observations f-times slower."""
        out = {}
        for g in new_cluster.groups:
            ref = self._ref_tflops.get(g.device.name)
            now = g.device.effective_tflops
            if ref is not None and now > 0 and \
                    abs(ref - now) > 1e-12 * ref:
                out[g.device.name] = ref / now
        return out

    def _expire_stale_profiles(self) -> None:
        """Bounded staleness for departed islands: profile entries of a
        kind that left the cluster are KEPT ``profile_stale_steps`` steps
        (a rejoin inside the window plans on its warm profile), then
        DROPPED from planning."""
        if self.profile_store is None:
            return
        for kind in self.profile_store.stale_kinds(
                self.step, self.cfg.profile_stale_steps):
            n = self.profile_store.drop_device(kind)
            if self.obs is not None and self.obs.flight is not None:
                self.obs.flight.note(
                    "profile-stale", step=self.step, kind=kind, dropped=n,
                    keep_steps=self.cfg.profile_stale_steps)

    def profiled_cost_source(self, cluster: ClusterSpec):
        """The online profile as a planner cost source once it holds
        ``replan_profile_min_obs`` folded layer-time observations of the
        trained architecture (None before).  Every cluster device maps to
        this process's device kind (the observing host stands in for the
        cluster); kinds ``cluster`` reports degraded relative to the
        healthy reference get their served times scaled once.  With an
        aggregator the source reads the cluster-wide merged store."""
        self._expire_stale_profiles()   # departed kinds past their window
        store = self._merged_store()
        if store is None:
            return None
        obs = [e for e in (store.entries(op="observed_layer_step")
                           + store.entries(op="layer_step")
                           + store.entries(op="observed_stage_tick"))
               if e.shape.get("arch") == self.bundle.cfg.name]
        if sum(e.value.get("n", 1.0) for e in obs) < \
                self.cfg.replan_profile_min_obs:
            return None
        from repro_torch.profile.model import ProfiledCostModel
        from repro_torch.profile.runner import device_kind
        dev = device_kind(self.device)
        return ProfiledCostModel(
            store, device_map={g.device.name: dev for g in cluster.groups},
            time_scale=self._degrade_scales(cluster))

    # ------------------------------------------- elastic replan (HETHUB) --
    def replan(self, new_cluster: ClusterSpec, *, global_batch: int,
               seq_len: int, migrate: str = "memory", **search_kw):
        """Degradation / replan event: search a new plan on
        ``new_cluster`` (``plan_for``), then move the live state onto it
        without restarting (``_adopt``).  ``migrate``: "memory" moves the
        state in memory (the checkpoint round trip only as a fallback);
        "checkpoint" restores it from the checkpoint of this step."""
        result = self.plan_for(new_cluster, global_batch=global_batch,
                               seq_len=seq_len, **search_kw)
        self._adopt(result, new_cluster, migrate=migrate)
        return result

    def plan_for(self, new_cluster: ClusterSpec, *, global_batch: int,
                 seq_len: int, **search_kw):
        """The search half of ``replan``, without adopting the result:
        ``planner.search`` of ``new_cluster`` under the observed cost
        source (once dense enough) with the incumbent plan as the
        baseline.  On ranks every rank calls it: the leader (the
        aggregator's, else rank 0) searches and broadcasts the result,
        and a plan whose ranks a replica do not divide the ranks present
        raises ``PlanWidthError`` on every rank."""
        if not self._ranks_active():
            return self._search(new_cluster, global_batch=global_batch,
                                seq_len=seq_len, **search_kw)
        if getattr(self.aggregator, "collective", False) and \
                self.profile_store is not None:     # every rank's folds
            self._cluster_view = self.aggregator.gather(self.profile_store)
        got: List[Any] = [None]
        leader = self._leader_rank()
        if dist.get_rank() == leader:
            try:
                got = [self._search(new_cluster, global_batch=global_batch,
                                    seq_len=seq_len, **search_kw)]
            except (RuntimeError, ValueError) as e:
                got = [e]       # every rank raises it, not the leader alone
        dist.broadcast_object_list(got, src=leader)
        if isinstance(got[0], Exception):
            raise got[0]
        return got[0]

    def _search(self, new_cluster: ClusterSpec, *, global_batch: int,
                seq_len: int, **search_kw):
        """This process's search (the leader's on ranks).  On ranks on the
        cards the search also requires every stage to fit the card's
        memory (``fit_to_card``): the predictor's check, of the searched
        plan, whose optimizer term keeps the whole AdamW state a stage
        (the widened plan keeps its ZeRO-1 slice), and a card shared by
        ranks counts once for each."""
        if "cost_source" not in search_kw:
            src = self.profiled_cost_source(new_cluster)
            if src is not None:
                search_kw["cost_source"] = src
        if self.plan is not None:
            search_kw.setdefault("baseline_plan", self.plan)
        cluster = new_cluster
        if self._ranks_active() and self.device.type == "cuda":
            cluster, search_kw = fit_to_card(
                new_cluster, search_kw, torch.cuda.get_device_properties(
                    self.device).total_memory / 1e9)
        result = planner_mod.search(cluster, self.bundle.cfg,
                                    global_batch=global_batch,
                                    seq_len=seq_len, **search_kw)
        if self.obs is not None:
            self.obs.on_search(self.step, result)
        if self._ranks_active():
            p, present = result.plan, self._present(new_cluster)
            width = p.pp * p.dps[0] * p.tps[0]
            if len(present) % width or len(set(p.dps)) > 1:
                raise PlanWidthError(
                    f"replanned {p.describe()} needs {width} ranks a "
                    f"replica, and the ranks present ({len(present)}: "
                    f"{present}) are no multiple of it")
        return result

    def _adopt(self, result, new_cluster: ClusterSpec,
               migrate: str = "memory") -> None:
        """The commit half of ``replan``: the checkpoint of this step
        (when ``ckpt_dir`` is set: written now unless a complete one is
        there already), the searched plan swapped in, the step rebuilt and
        the state moved onto it (see ``replan``).  On ranks the plan runs
        on the ranks present on ``new_cluster`` (``_present``): the ranks
        that leave send their elements and then hold nothing, the ranks
        that come back receive theirs.  A failed in-memory move falls
        back to the checkpoint, printing its error to stderr; with no
        checkpoint it raises."""
        if migrate not in ("memory", "checkpoint"):
            raise ValueError(f"unknown migrate mode {migrate!r}")
        if migrate == "checkpoint" and self.ckpt is None:
            raise ValueError("migrate='checkpoint' restores the checkpoint "
                             "of this step: set TrainerConfig.ckpt_dir")
        ranks, cfg = self._ranks_active(), self.bundle.cfg
        # before anything moves: a plan whose route the model has not (the
        # checks of the route _build takes)
        if ranks and result.plan.cp > 1:
            pipeline.check_rank_plan(cfg, result.plan)  # cp on ranks: A8b
        elif not ranks:
            if result.plan.pp > 1:          # the enc-dec stack has no pp
                pipeline.check_pp_supported(cfg)
            if result.plan.cp > 1:          # nor enc-dec and VLM a cp loss
                context.check_cp_family(cfg)
        t0 = time.perf_counter()
        if self.ckpt is not None:
            self.ckpt.wait()
            # the state has not changed since a checkpoint of this step
            if self._latest_step() != self.step:
                if self.state is not None:
                    self.ckpt.save_async(self.step, self.state,
                                         extra=self._ckpt_extra(),
                                         part=self._part)
                    self.ckpt.wait()
                if ranks:   # every rank's part is in
                    dist.barrier()
        ckpt_s = time.perf_counter() - t0
        old_plan, old_members = self._rplan, list(self._members)
        new_members = self._present(new_cluster) if ranks else []
        self.cluster = new_cluster
        for g in new_cluster.groups:
            self._ref_tflops.setdefault(g.device.name,
                                        g.device.effective_tflops)
        # the ranks keep the transport they run on: the plan changes, the
        # process group's links do not
        self.plan = (result.plan if old_plan is None else dataclasses.replace(
            result.plan, transport=old_plan.transport))
        self.replans += 1
        t_mig = t1 = time.perf_counter()
        moved, stats = False, None
        if migrate == "memory":
            try:
                if ranks:
                    new_plan = widen_plan(self.plan, len(new_members))
                    self.state, stats = migrate_mod.redistribute(
                        self.state or {},
                        steps_mod.train_state_shapes(self.bundle),
                        old_plan, new_plan, self.bundle.cfg, self.device,
                        new_plan.transport, old_ranks=old_members,
                        new_ranks=new_members)
                moved = True
            except Exception as e:  # noqa: BLE001 — the checkpoint or raise
                if self.ckpt is None:
                    raise
                print(f"[trainer] in-memory migration at step {self.step} "
                      f"failed ({e!r}); restoring the checkpoint",
                      file=sys.stderr, flush=True)
                if self.obs is not None and self.obs.flight is not None:
                    self.obs.flight.note("migration-error", step=self.step,
                                         error=repr(e))
                    self.obs.flight_dump("migration-failure")
        if ranks:
            # the old grid's communicators and the old leaves' blocks back
            # to the card before the new grid's NCCL communicators allocate
            # outside the caching allocator
            self.train_step = None
            if self.grid is not None:
                groups.destroy_rank_grid(self.grid)
            self.grid = None
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
            self._members = new_members
        self._build()
        if moved:
            self.migrations["memory"] += 1
            if ranks and self.ckpt is not None:
                self._slices()          # this rank's part of later saves
        else:
            self._init_or_restore(None)
            self.migrations["checkpoint"] += 1
        synchronize(self.device)
        move_s = time.perf_counter() - t1
        if self.obs is not None:
            self.obs.on_migration(time.perf_counter() - t_mig, moved)
        self.last_migration = {"ckpt_s": ckpt_s, "move_s": move_s,
                               "memory": moved, **(stats or {})}
        # the rebuilt step pays its warm-up again: restart the EWMA so it
        # is neither folded into the profile nor flagged slow
        self._ewma = None
        self._slow = 0
