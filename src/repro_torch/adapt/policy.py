"""Telemetry-triggered replan policy: the decision half of the closed loop
(a copy of ``repro/adapt/policy.py``, which imports no jax; kept equal to
it, ``tests/test_torch_adapt.py``).

The mechanisms of HETHUB's adaptation story — online stage telemetry,
``Trainer.schedule_health()``, ``ClusterSpec.degrade``, ``Trainer.replan``
with live state migration — leave the decision to adapt to the caller.
``ReplanPolicy`` closes the loop: the Trainer
feeds it one observation per telemetry step (per-stage tick times and the
observed/predicted bubble ratio) and the policy answers "replan now?" —
with the guard rails an autonomous controller needs in production:

  * **two signals, separately thresholded** — a per-stage straggler ratio
    (observed stage tick vs its own healthy baseline, EWMA-smoothed:
    "slow kernels / degraded island") and the bubble ratio from
    ``schedule_health()`` ("wrong schedule").  A straggler decision names
    the stage and its estimated slowdown factor so the controller can
    build the degraded ClusterSpec; a schedule decision replans on the
    unchanged cluster to re-score the schedule sweep;
  * **hysteresis bands** — each signal arms at ``*_enter`` and only
    disarms back below ``*_exit`` (enter > exit), so a ratio oscillating
    around the threshold can never flap the controller;
  * **patience** — an armed signal must stay armed for ``patience``
    accumulated observation weight before it triggers.  Observations from
    ``bucketed`` (timer-mode) telemetry count only ``bucketed_weight``
    toward patience: they spread whole steps over ticks and carry no real
    per-stage skew, so they must not be trusted like exact callback-mode
    ticks;
  * **cooldown** — after any trigger (and after a rejected migration) the
    policy stays quiet for ``cooldown`` observed steps: migrations and
    searches aren't free, and back-to-back replans would thrash;
  * **min-expected-gain gate** — ``gain_ok`` compares the planner's
    ``PlannerResult.expected_gain`` (winner vs incumbent under the SAME
    cost source) against ``min_gain``: the controller searches first,
    but only migrates when the predicted improvement clears ε.

The controller records every decision as a structured ``AdaptEvent`` (the
operator-facing log; see docs/adaptation.md for the runbook).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence


@dataclasses.dataclass
class AdaptConfig:
    """Knobs of the autonomous adaptation controller (docs/adaptation.md
    documents each one with operator guidance)."""
    # straggler signal: worst per-stage observed-tick ratio vs baseline
    straggler_enter: float = 2.0   # arm when worst ratio >= this
    straggler_exit: float = 1.3    # disarm when back <= this
    # schedule signal: observed bubble / predicted bubble
    bubble_enter: float = 1.5
    bubble_exit: float = 1.2
    # armed observation weight required before a trigger fires
    patience: float = 2.0
    # observed steps of silence after a trigger or a rejected migration
    cooldown: int = 8
    # healthy observations forming the per-stage baseline (before the
    # baseline exists the policy only watches)
    baseline_steps: int = 2
    # EWMA smoothing factor for the per-stage ratios (1.0 = no smoothing)
    ewma: float = 0.5
    # ε: minimum predicted fractional iter-time gain (PlannerResult
    # .expected_gain) required to adopt a searched plan — migrations
    # aren't free, so "barely better" must not move state around
    min_gain: float = 0.05
    # patience weight of a bucketed (timer-mode) observation relative to
    # an exact (callback-mode) one
    bucketed_weight: float = 0.5

    def __post_init__(self):
        if not self.straggler_enter > self.straggler_exit > 0:
            raise ValueError(
                f"need straggler_enter > straggler_exit > 0, got "
                f"{self.straggler_enter} / {self.straggler_exit}")
        if not self.bubble_enter > self.bubble_exit > 0:
            raise ValueError(
                f"need bubble_enter > bubble_exit > 0, got "
                f"{self.bubble_enter} / {self.bubble_exit}")
        if self.patience < 1:
            raise ValueError(f"patience must be >= 1, got {self.patience}")
        if self.cooldown < 0:
            raise ValueError(f"cooldown must be >= 0, got {self.cooldown}")
        if self.baseline_steps < 1:
            raise ValueError(
                f"baseline_steps must be >= 1, got {self.baseline_steps}")
        if not 0.0 < self.ewma <= 1.0:
            raise ValueError(f"ewma must be in (0, 1], got {self.ewma}")
        if not 0.0 <= self.min_gain < 1.0:
            raise ValueError(
                f"min_gain must be in [0, 1), got {self.min_gain}")
        if not 0.0 < self.bucketed_weight <= 1.0:
            raise ValueError(f"bucketed_weight must be in (0, 1], got "
                             f"{self.bucketed_weight}")


@dataclasses.dataclass(frozen=True)
class AdaptDecision:
    """A fired trigger: what the policy wants the controller to do."""
    action: str                    # "replan-straggler" | "replan-schedule"
    reason: str                    # human-readable trigger explanation
    signal: float                  # the ratio that crossed the band
    stage: Optional[int] = None    # straggler: which physical stage
    factor: Optional[float] = None  # straggler: estimated slowdown factor


@dataclasses.dataclass(frozen=True)
class AdaptEvent:
    """One structured line of the controller's operator-facing log.

    ``action`` ∈ {"trigger", "replan", "migrate", "skip",
                  "node-lost", "node-joined", "re-elect"}:
      trigger — the policy fired (detail: signal, stage, factor);
      replan  — a plan search ran (detail: winner, iter_time,
                baseline_time, expected_gain);
      migrate — the searched plan was adopted and state live-migrated
                (detail: plan, migration counters).  The policy resets:
                baselines re-form under the new plan after a cooldown;
      skip    — the min-gain gate rejected the searched plan (detail:
                expected_gain, min_gain), or the search found no feasible
                plan — either way the policy enters cooldown.

    Elastic-membership actions (docs/adaptation.md#elastic-membership;
    these do NOT come from the policy — membership is a topology fact,
    so the controller forces the replan and the ε gate does not apply):
      node-lost   — an island left the cluster (detail: kind, the
                    surviving groups); followed by replan + migrate onto
                    the surviving topology;
      node-joined — an island (re)joined (detail: kind, groups);
                    followed by replan + migrate, restoring the plan
                    shape the capacity allows;
      re-elect    — THIS process became the adaptation leader after the
                    previous leader's rank was lost (deterministic
                    lowest-surviving-rank rule; detail: rank).
    """
    step: int
    action: str
    reason: str
    detail: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"step": self.step, "action": self.action,
                "reason": self.reason, "detail": dict(self.detail)}

    def format(self) -> str:
        extra = " ".join(f"{k}={v}" for k, v in self.detail.items())
        return (f"[adapt] step={self.step} {self.action}: {self.reason}"
                + (f" ({extra})" if extra else ""))


def events_json(events: Sequence[AdaptEvent]) -> str:
    """The AdaptEvent log as a JSON array (artifact / machine-readable)."""
    return json.dumps([e.to_dict() for e in events], indent=1)


def events_jsonl(events: Sequence[AdaptEvent], run=None) -> str:
    """The AdaptEvent log as JSONL: a run-identity header line (when a
    ``repro_torch.obs.runmeta.RunMeta`` is given) followed by one
    ``{"kind": "adapt_event", ...to_dict()}`` object per line — the
    ``--events-out`` artifact format (append-friendly, streamable,
    attributable in multi-run artifact directories)."""
    lines = []
    if run is not None:
        lines.append(json.dumps({"kind": "header", **run.to_dict()}))
    lines.extend(json.dumps({"kind": "adapt_event", **e.to_dict()})
                 for e in events)
    return "\n".join(lines) + "\n"


class _Hysteresis:
    """One signal's band state: arms at ``enter``, disarms only back at
    ``exit`` (enter > exit), accumulating observation weight while armed.
    The accumulated weight is the patience counter; crossing back below
    ``exit`` resets it — a ratio oscillating across the band therefore
    never accumulates to a trigger (the no-flap property)."""

    def __init__(self, enter: float, exit_: float):
        self.enter = enter
        self.exit = exit_
        self.armed = False
        self.weight = 0.0

    def observe(self, value: float, weight: float) -> float:
        if not self.armed:
            if value >= self.enter:
                self.armed = True
                self.weight = weight
        elif value <= self.exit:
            self.armed = False
            self.weight = 0.0
        else:
            self.weight += weight
        return self.weight if self.armed else 0.0

    def reset(self) -> None:
        self.armed = False
        self.weight = 0.0


class ReplanPolicy:
    """See the module docstring.  One ``observe()`` call per NEW telemetry
    observation; returns an ``AdaptDecision`` when a trigger fires, else
    None.  The controller is expected to:

        decision = policy.observe(step, stage_ticks, bubble_ratio, prov)
        if decision: search -> policy.gain_ok(result)
                     -> adopt + policy.reset(step)   (gain cleared ε)
                     -> or policy.reject(step)       (gain below ε)
    """

    def __init__(self, cfg: Optional[AdaptConfig] = None):
        self.cfg = cfg or AdaptConfig()
        self.triggers = 0
        self._cooldown = 0
        self._base_acc: List[List[float]] = []   # healthy baseline samples
        self._baseline: Optional[List[float]] = None
        self._ratios: Optional[List[float]] = None   # EWMA per stage
        self._straggler = _Hysteresis(self.cfg.straggler_enter,
                                      self.cfg.straggler_exit)
        self._bubble = _Hysteresis(self.cfg.bubble_enter,
                                   self.cfg.bubble_exit)

    # ----------------------------------------------------------- state ----
    @property
    def cooling(self) -> bool:
        return self._cooldown > 0

    def reset(self, step: int = 0) -> None:
        """Post-migration: the plan (and possibly the stage count) changed,
        so baselines and band states are meaningless — re-form them, and
        stay quiet for a cooldown (the rebuilt step recompiles; its first
        observations are not steady state)."""
        self._base_acc = []
        self._baseline = None
        self._ratios = None
        self._straggler.reset()
        self._bubble.reset()
        self._cooldown = self.cfg.cooldown

    def reject(self, step: int = 0) -> None:
        """The controller searched but the min-gain gate blocked adoption:
        enter cooldown so the same (still-armed) signal does not re-run
        the search every step, but keep baselines — the situation has not
        changed."""
        self._straggler.reset()
        self._bubble.reset()
        self._cooldown = self.cfg.cooldown

    # --------------------------------------------------------- decision ---
    def gain_ok(self, result) -> bool:
        """Min-expected-gain gate over a ``PlannerResult``: adopt only when
        the predicted fractional improvement over the scored incumbent
        clears ``min_gain``.  A result without a scored incumbent (fresh
        search, or the incumbent no longer maps onto the cluster — e.g.
        node loss) passes: there is nothing to stay put on."""
        gain = getattr(result, "expected_gain", None)
        return True if gain is None else gain >= self.cfg.min_gain

    def observe(self, step: int, stage_ticks: Optional[Sequence[float]],
                bubble_ratio: Optional[float] = None,
                provenance: str = "exact") -> Optional[AdaptDecision]:
        """Feed one NEW telemetry observation; returns a decision when a
        trigger fires.  ``stage_ticks`` are per-PHYSICAL-stage forward
        seconds per tick (the Trainer sums each stage's vpp chunks and
        applies any injected degradation), ``bubble_ratio`` is
        ``schedule_health()['ratio']`` (observed/predicted bubble), and
        ``provenance`` is ``"exact"`` (callback ticks) or ``"bucketed"``
        (timer mode) — bucketed observations count ``bucketed_weight``
        toward patience."""
        if self._cooldown > 0:
            self._cooldown -= 1
            return None
        weight = (self.cfg.bucketed_weight if provenance == "bucketed"
                  else 1.0)
        # ---- per-stage straggler ratios vs the healthy baseline ----
        worst_stage, worst_ratio = None, 0.0
        if stage_ticks:
            ticks = [max(float(t), 1e-12) for t in stage_ticks]
            if self._baseline is not None and \
                    len(self._baseline) != len(ticks):
                # stage count changed under us: re-form everything
                self.reset(step)
                self._cooldown = 0
            if self._baseline is None:
                self._base_acc.append(ticks)
                if len(self._base_acc) >= self.cfg.baseline_steps:
                    n = len(self._base_acc)
                    self._baseline = [
                        max(sum(s[i] for s in self._base_acc) / n, 1e-12)
                        for i in range(len(ticks))]
            else:
                raw = [t / b for t, b in zip(ticks, self._baseline)]
                a = self.cfg.ewma
                if self._ratios is None:
                    self._ratios = raw
                else:
                    self._ratios = [(1 - a) * p + a * r
                                    for p, r in zip(self._ratios, raw)]
                worst_stage = max(range(len(self._ratios)),
                                  key=lambda i: self._ratios[i])
                worst_ratio = self._ratios[worst_stage]
        # ---- hysteresis + patience per signal; straggler outranks ----
        if worst_stage is not None and \
                self._straggler.observe(worst_ratio, weight) \
                >= self.cfg.patience:
            self._fired(step)
            return AdaptDecision(
                action="replan-straggler",
                reason=(f"stage {worst_stage} sustained "
                        f"{worst_ratio:.2f}x its healthy tick time"),
                signal=worst_ratio, stage=worst_stage,
                factor=worst_ratio)
        if bubble_ratio is not None and \
                self._bubble.observe(float(bubble_ratio), weight) \
                >= self.cfg.patience:
            self._fired(step)
            return AdaptDecision(
                action="replan-schedule",
                reason=(f"observed bubble sustained {bubble_ratio:.2f}x "
                        f"the predicted bubble"),
                signal=float(bubble_ratio))
        return None

    def _fired(self, step: int) -> None:
        self.triggers += 1
        self._cooldown = self.cfg.cooldown
        self._straggler.reset()
        self._bubble.reset()
