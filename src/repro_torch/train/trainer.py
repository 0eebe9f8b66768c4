"""Training loop (port of the plan routing and the run loop of
``repro/train/trainer.py``).

``Trainer`` builds the train step its plan asks for and runs it over the
synthetic batches:

  * no plan, a cp = 1 plan, a plan for another workload shape, or a model
    outside the cp scope: the reference loss (full forward, flash
    attention);
  * a pp = 1, cp > 1 plan for this workload: the cp ring loss
    (``parallel/context.py``), same state and train step;
  * a pp > 1 plan for this workload raises: the pipeline runtime is not
    ported (ROADMAP.md queue A, item 5).

Left out of the JAX trainer, each a ROADMAP item: checkpoints and restart,
stage telemetry, straggler detection, replanning and migration,
adaptation and observability (queue A, item 6).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.plan import ParallelPlan
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.models.registry import ArchBundle
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel import context
from repro_torch.train import steps as steps_mod
from repro_torch.utils.device import (DeviceLike, resolve_device,
                                      synchronize)


@dataclasses.dataclass
class TrainerConfig:
    global_batch: int = 8
    seq_len: int = 64


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
        self._build()
        if state is None:
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
        if self._pipeline_active():
            raise NotImplementedError(
                f"plan {self.plan.describe()}: pipeline execution (pp > 1) "
                "is not ported yet (ROADMAP.md queue A, item 5)")
        loss_fn = None
        if self._cp_active():
            loss_fn = context.make_cp_loss_fn(self.bundle.cfg,
                                              self.plan.cp_chunk_sizes)
        self.train_step = steps_mod.make_train_step(
            self.bundle, self.opt_cfg, loss_fn=loss_fn)

    # ------------------------------------------------------------- run ----
    def _device_batch(self, np_batch: Dict[str, np.ndarray]):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in np_batch.items()}

    def run(self, n_steps: int) -> Dict[str, Any]:
        """``n_steps`` train steps; returns {"losses", "step", "step_s"}
        (each step's wall time, ending when its loss is on the host)."""
        losses, step_s = [], []
        for _ in range(n_steps):
            t0 = time.perf_counter()
            batch = self._device_batch(self.data.batch_at(self.step))
            self.state, metrics = self.train_step(self.state, batch)
            losses.append(float(metrics["loss"]))
            synchronize(self.device)
            step_s.append(time.perf_counter() - t0)
            self.step += 1
            self.data.state.step = self.step
        return {"losses": losses, "step": self.step, "step_s": step_s}
