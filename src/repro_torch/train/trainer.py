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
    ``pipeline.PPRankStep``; every rank reports the step's loss.

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
and on the rank route at pp > 1 with a ``profile_store``, a recorder
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
migration rebuilds the step over the same tensors; on ranks rank 0
searches and broadcasts the plan (on the cards, one each stage of which
fits the card, ``fit_to_card``), ``parallel/migrate.redistribute`` moves
every element from its old writer to its new ranks, or the checkpoint
round trip restores it (``migrate="checkpoint"``, or a failed move when
there is a checkpoint), and the old grid's groups are released before
the new grid is made.

Left out of the JAX trainer: adaptation policies and aggregators, elastic
membership and observability (ROADMAP.md queue A, item A6c).
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
A6C = "ROADMAP.md queue A, item A6c"


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


def widen_plan(plan: ParallelPlan, world: int) -> ParallelPlan:
    """``plan`` over ``world`` ranks: a plan of ``pp * dp * tp`` ranks
    whose count divides ``world`` (and is smaller) gets ``dp * world /
    (pp * dp * tp)`` replicas of every stage, each of the same microbatch
    size, as the train CLI widens its searched plan; any other plan as it
    is."""
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
                 profile_store=None):
        """``state``: a train state to start from (``steps.
        init_train_state``'s layout, e.g. ``convert.from_jax`` of a JAX
        state), copied to the device.  Default: the latest checkpoint in
        ``cfg.ckpt_dir``, else a fresh state from seed 0; a checkpoint and
        ``state`` together raise.  ``cluster``: the ClusterSpec the plan
        was searched on (stage -> device kind, the predictor's cluster);
        ``profile_store``: a ``profile.ProfileStore`` the run folds its
        observations into."""
        self.bundle = bundle
        self.cfg = cfg
        self.plan = plan
        self.cluster = cluster
        self.profile_store = profile_store
        self.opt_cfg = opt_cfg or AdamWConfig()
        self.device = resolve_device(device)
        self.data = SyntheticTokens(
            vocab_size=bundle.cfg.vocab_size, seq_len=cfg.seq_len,
            global_batch=cfg.global_batch, family=bundle.cfg.family,
            d_model=bundle.cfg.d_model,
            n_vision_tokens=bundle.cfg.n_vision_tokens)
        self.grid: Optional[groups.RankGrid] = None
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
        if self.grid is None:
            return ckpt.latest_step(self.cfg.ckpt_dir)
        got = [None]
        if dist.get_rank() == 0:
            ckpt.clear_partial(self.cfg.ckpt_dir)
            got = [ckpt.latest_step(self.cfg.ckpt_dir)]
        dist.broadcast_object_list(got, src=0)
        return got[0]

    def _slices(self) -> Any:
        """This rank's ``rank_leaf_slices`` (one process: the whole
        state); on ranks also this rank's part of later saves."""
        whole = steps_mod.train_state_shapes(self.bundle)
        if self.grid is None:
            return pipeline.rank_leaf_slices(
                whole, [self.bundle.cfg.num_layers], 0)
        g = self.grid
        slices = pipeline.rank_leaf_slices(
            whole, self.train_step.plan, g.stage, self.train_step.rules,
            g.model_rank, replica=g.replica)
        self._part = ckpt.RankPart(slices, whole, dist.get_rank(),
                                   dist.get_world_size())
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
        widened to the world), else ``plan``.  ``plan`` stays the searched
        plan, the search's baseline."""
        return self.train_step.plan if self.grid is not None else self.plan

    def _rank_plan(self, world: int) -> ParallelPlan:
        """The plan the ranks run: this workload's plan, widened to the
        world (``widen_plan``), else one stage of every layer over
        ``world / tp`` replicas of ``tp`` ranks."""
        plan, tp = self.plan, self.cfg.tp
        if self._pipeline_active() or (
                plan is not None and plan.pp == 1
                and plan.global_batch == self.cfg.global_batch
                and plan.seq_len == self.cfg.seq_len):
            return widen_plan(plan, world)
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
            world, tp = dist.get_world_size(), self.cfg.tp
            plan = self._rank_plan(world)
            pipeline.check_rank_plan(self.bundle.cfg, plan)
            if plan.tps[0] != tp:
                raise ValueError(f"plan {plan.describe()} has stage tp "
                                 f"{plan.tps}, the trainer tp {tp}")
            if world != plan.pp * plan.dps[0] * tp:
                raise ValueError(f"world size {world} is not pp {plan.pp} x "
                                 f"dp {plan.dps[0]} x tp {tp}")
            if self.cfg.global_batch % plan.tokens_per_tick:
                raise ValueError(f"global batch {self.cfg.global_batch} does "
                                 f"not split over dp {plan.dps[0]} x "
                                 f"micro_bs {plan.micro_bs}")
            self.grid = groups.make_rank_grid(plan.pp, plan.dps[0],
                                              self.device, tp=tp)
            self.train_step = pipeline.PPRankStep(
                self.bundle.cfg, plan, self.grid, self.opt_cfg)
            # each process records its own pod: its ops, gathered a step
            # into the store (no store, nothing to fold: no recorder)
            if plan.pp > 1 and mode != "off" and \
                    self.profile_store is not None:
                m = plan.micro_batches
                if mode == "timer":
                    self.telemetry = StageTelemetry(plan.pp, plan.vpp, m,
                                                    mode="timer")
                else:
                    self.telemetry = RankTelemetry(plan.pp, plan.vpp, m)
                    self.train_step.clock = OpClock(self.device)
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

    # ------------------------------------------------------------- run ----
    def _device_batch(self, np_batch: Dict[str, np.ndarray]):
        m = None
        if self._pipeline_active():
            m = (self.train_step.plan if self.grid is not None
                 else self.plan).micro_batches

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

    def run(self, n_steps: int,
            on_straggler: Optional[Callable[["Trainer"], None]] = None
            ) -> Dict[str, Any]:
        """``n_steps`` train steps; returns {"losses", "grad_norms",
        "step", "step_s"} (each step's wall time, ending when its loss is
        on the host; the global gradient norm AdamW clipped by).  With a
        ``profile_store`` each step's observations are folded into it; a
        step slower than ``straggler_factor`` times the EWMA of the step
        times counts as slow, and ``on_straggler(self)`` is called after
        ``straggler_patience`` slow steps in a row.  With
        ``cfg.ckpt_dir``, a background save after every step that
        ``cfg.ckpt_every`` divides, all waited for at the end."""
        losses, norms, step_s = [], [], []
        for _ in range(n_steps):
            t0 = time.perf_counter()
            batch = self._device_batch(self.data.batch_at(self.step))
            self.state, metrics = self.train_step(self.state, batch)
            losses.append(float(metrics["loss"]))
            synchronize(self.device)
            dt = time.perf_counter() - t0
            step_s.append(dt)
            norms.append(float(metrics["grad_norm"]))
            self.step += 1
            self.data.state.step = self.step
            dt = self._observe(dt)
            if self.profile_store is not None:
                self._refine_profile(dt)
            # --- straggler detection (observed vs EWMA-expected) ---
            if self._ewma is None:
                self._ewma = dt
            else:
                if dt > self.cfg.straggler_factor * self._ewma:
                    self._slow += 1
                else:
                    self._slow = 0
                self._ewma = 0.9 * self._ewma + 0.1 * dt
                if self._slow >= self.cfg.straggler_patience:
                    self._slow = 0
                    if on_straggler is not None:
                        on_straggler(self)
            if self.ckpt is not None and \
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

    def _observe(self, dt: float) -> float:
        """After the step's own synchronize: the card's tick marks resolve
        into the recorder.  On ranks with a recorder (a ``profile_store``,
        pp > 1, telemetry not "off") every rank gathers every rank's report (its stage's op times, its step time)
        here, at the same point of every rank's step, over
        ``torch.distributed`` (outside the ICCL tap), records the same
        view, and takes the slowest rank's step time as the step's.
        Returns the step time to fold."""
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
        return max(r["dt"] for r in got)

    # ------------------------------------- online profile refinement ------
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
        shape = {"arch": cfgm.name, "seq_len": self.cfg.seq_len,
                 "global_batch": self.cfg.global_batch, "tp": self.cfg.tp}
        self.profile_store.fold(dev, "observed_step", shape, "time_s", dt)
        # per-layer per-SEQUENCE time; obs_scale tags the REAL slowdown of
        # this host's kind only (injection distorts telemetry, never the
        # measured wall time)
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
        only its own layers, which are its depth."""
        plan, rplan = self.plan, self.run_plan
        vl = list(rplan.virtual_layers)
        lmax = max(vl)
        padded = ([sum(vl[s::rplan.pp]) for s in range(rplan.pp)]
                  if self.grid is not None else [rplan.vpp * lmax] * rplan.pp)
        obs = self._obs_scales()
        self.telemetry.fold_into(
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
                if self.cluster is not None else None))

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

    def _stage_tick_obs(self):
        """Per-PHYSICAL-stage forward tick seconds (each stage's vpp
        chunks summed, injected degradation applied) from the recorder's
        most recent observation (on ranks, the gathered view of every
        stage).  None before the first kept observation."""
        ticks = self.telemetry.stage_ticks() if self.telemetry else None
        if ticks is None:
            return None
        pp, vpp = self.telemetry.pp, self.telemetry.vpp
        scales = self._stage_scales()
        return [scales[i] * sum(ticks[ch * pp + i] for ch in range(vpp))
                for i in range(pp)]

    # ----------------------------------------------- schedule diagnostics --
    def schedule_health(self) -> Optional[Dict[str, float]]:
        """Observed vs predicted bubble for the executing plan — the
        signal that separates "slow kernels" (stage ticks up, bubble flat)
        from "wrong schedule" (bubble above prediction).  None before any
        observation or without a cluster+plan to predict against."""
        if self.cluster is None or not self._pipeline_active():
            return None
        plan = self.run_plan    # on ranks, the widened plan they run
        observed = self.telemetry.bubble() if self.telemetry else None
        if observed is None and self.profile_store is not None:
            from repro_torch.profile.model import ProfiledCostModel
            from repro_torch.profile.runner import device_kind
            observed = ProfiledCostModel(self.profile_store).observed_bubble(
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

    def profiled_cost_source(self, cluster: ClusterSpec):
        """The online profile as a planner cost source once it holds
        ``replan_profile_min_obs`` folded layer-time observations of the
        trained architecture (None before).  Every cluster device maps to
        this process's device kind (the observing host stands in for the
        cluster); kinds ``cluster`` reports degraded relative to the
        healthy reference get their served times scaled once."""
        store = self.profile_store
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
        baseline.  On ranks rank 0 searches and broadcasts the result, and
        a plan whose ranks do not divide the world raises (changing the
        world is elastic membership).  On ranks on the cards the search
        also requires every stage to fit the card's memory
        (``fit_to_card``).  The check is the predictor's, of the
        searched plan, whose optimizer term keeps the whole AdamW state a
        stage (the widened plan keeps its ZeRO-1 slice), and a card shared
        by ranks counts once for each."""
        if "cost_source" not in search_kw:
            src = self.profiled_cost_source(new_cluster)
            if src is not None:
                search_kw["cost_source"] = src
        if self.plan is not None:
            search_kw.setdefault("baseline_plan", self.plan)
        if self.grid is None:
            return planner_mod.search(new_cluster, self.bundle.cfg,
                                      global_batch=global_batch,
                                      seq_len=seq_len, **search_kw)
        cluster = new_cluster
        if self.device.type == "cuda":
            cluster, search_kw = fit_to_card(
                new_cluster, search_kw, torch.cuda.get_device_properties(
                    self.device).total_memory / 1e9)
        got = [None]
        if dist.get_rank() == 0:
            got = [planner_mod.search(cluster, self.bundle.cfg,
                                      global_batch=global_batch,
                                      seq_len=seq_len, **search_kw)]
        dist.broadcast_object_list(got, src=0)
        result, world = got[0], dist.get_world_size()
        p = result.plan
        width = p.pp * p.dps[0] * p.tps[0]
        if world % width or len(set(p.dps)) > 1:
            raise ValueError(f"replanned {p.describe()} needs {width} ranks "
                             f"a replica, the process group has {world}: "
                             f"changing the world is elastic membership "
                             f"({A6C})")
        return result

    def _adopt(self, result, new_cluster: ClusterSpec,
               migrate: str = "memory") -> None:
        """The commit half of ``replan``: the checkpoint of this step
        (when ``ckpt_dir`` is set: written now unless a complete one is
        there already), the searched plan swapped in, the step rebuilt and
        the state moved onto it (see ``replan``).  A failed in-memory move
        falls back to the checkpoint, printing its error to stderr; with
        no checkpoint it raises."""
        if migrate not in ("memory", "checkpoint"):
            raise ValueError(f"unknown migrate mode {migrate!r}")
        if migrate == "checkpoint" and self.ckpt is None:
            raise ValueError("migrate='checkpoint' restores the checkpoint "
                             "of this step: set TrainerConfig.ckpt_dir")
        t0 = time.perf_counter()
        if self.ckpt is not None:
            self.ckpt.wait()
            # the state has not changed since a checkpoint of this step
            if self._latest_step() != self.step:
                self.ckpt.save_async(self.step, self.state,
                                     extra=self._ckpt_extra(),
                                     part=self._part)
                self.ckpt.wait()
                if self.grid is not None:   # every rank's part is in
                    dist.barrier()
        ckpt_s = time.perf_counter() - t0
        old_plan = self.train_step.plan if self.grid is not None else None
        self.cluster = new_cluster
        for g in new_cluster.groups:
            self._ref_tflops.setdefault(g.device.name,
                                        g.device.effective_tflops)
        # the ranks keep the transport they run on: the plan changes, the
        # process group's links do not
        self.plan = (result.plan if old_plan is None else dataclasses.replace(
            result.plan, transport=old_plan.transport))
        self.replans += 1
        t1 = time.perf_counter()
        moved, stats = False, None
        if migrate == "memory":
            try:
                if self.grid is not None:
                    world = dist.get_world_size()
                    new_plan = widen_plan(self.plan, world)
                    self.state, stats = migrate_mod.redistribute(
                        self.state, steps_mod.train_state_shapes(self.bundle),
                        old_plan, new_plan, self.bundle.cfg, self.device,
                        new_plan.transport)
                moved = True
            except Exception as e:  # noqa: BLE001 — the checkpoint or raise
                if self.ckpt is None:
                    raise
                print(f"[trainer] in-memory migration at step {self.step} "
                      f"failed ({e!r}); restoring the checkpoint",
                      file=sys.stderr, flush=True)
        if self.grid is not None:
            # the old grid's communicators and the old leaves' blocks back
            # to the card before the new grid's NCCL communicators allocate
            # outside the caching allocator
            self.train_step = None
            groups.destroy_rank_grid(self.grid)
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
        self._build()
        if moved:
            self.migrations["memory"] += 1
            if self.grid is not None and self.ckpt is not None:
                self._slices()          # this rank's part of later saves
        else:
            self._init_or_restore(None)
            self.migrations["checkpoint"] += 1
        synchronize(self.device)
        self.last_migration = {"ckpt_s": ckpt_s,
                               "move_s": time.perf_counter() - t1,
                               "memory": moved, **(stats or {})}
        # the rebuilt step pays its warm-up again: restart the EWMA so it
        # is neither folded into the profile nor flagged slow
        self._ewma = None
        self._slow = 0
