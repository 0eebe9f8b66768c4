"""Observability: the one object the trainer talks to (port of
``repro/obs/observer.py``).

Construction is cheap and does nothing; each pillar activates only when
its output path is given (``trace_out`` / ``metrics_out`` /
``prom_out``), and the flight recorder rides along whenever any pillar
is on (it is pure in-memory bookkeeping until a failure dumps it).

Cost model — the acceptance criterion is *zero additional host
callbacks when disabled*, and this module is built around it:

  * the observed timeline and per-stage tick metrics ride the ONE host
    callback the telemetry recorder already owns (``StageTelemetry``
    calls its ``sink`` from ``_record``); when obs is off the sink stays
    ``None`` and nothing changes;
  * ICCL byte/op counters hook the port's collective tap
    (``iccl.communicator.set_collective_sink``).  The JAX package's sink
    fires at trace time, once per compiled program; the port runs
    eagerly, so its sink fires once per EXECUTED call, every step (a
    counter update each, no I/O: the counts grow with the steps, where
    JAX's stay at one program's);
  * the predicted lane is rendered once per plan adoption (launch +
    each replan) from the simulator oracle, off the step loop.

All pillars share one ``RunMeta`` identity and one ``epoch`` clock, so
trace timestamps and metrics ``ts`` align.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.metrics import MetricsLog
from repro_torch.obs.runmeta import RunMeta, plan_digest
from repro_torch.obs.trace import TraceBuilder, predicted_sim_events


class Observability:
    """Bundles the trace builder, metrics log and flight recorder behind
    the hook surface the trainer / train CLI call."""

    def __init__(self, trace_out=None, metrics_out=None, events_out=None,
                 prom_out=None, flight_out=None,
                 run: Optional[RunMeta] = None,
                 flight_capacity: int = 512):
        self.run = run or RunMeta.new()
        self.epoch = time.perf_counter()
        self.trace_out = Path(trace_out) if trace_out else None
        self.events_out = Path(events_out) if events_out else None
        self.flight_out = Path(flight_out) if flight_out else None
        self.trace = (TraceBuilder(self.run, self.epoch)
                      if trace_out else None)
        self.metrics = (MetricsLog(metrics_out, self.run, prom_out,
                                   self.epoch)
                        if (metrics_out or prom_out) else None)
        self.flight = (FlightRecorder(flight_capacity, self.run)
                       if self.enabled else None)
        self._iccl_installed = False
        self._closed = False

    @property
    def enabled(self) -> bool:
        return (self.trace is not None or self.metrics is not None
                or self.events_out is not None)

    # ----------------------------------------------------- iccl counters --
    def install_iccl(self) -> None:
        """Count collective ops/bytes per (op, transport).  The port's
        tap fires once per executed call (JAX's once per compiled
        program), so the counts are per step times the steps."""
        if self.metrics is None or self._iccl_installed:
            return
        from repro_torch.iccl import communicator
        communicator.set_collective_sink(self._note_collective)
        self._iccl_installed = True

    def _note_collective(self, op: str, transport: str,
                         nbytes: int) -> None:
        self.metrics.count("iccl_calls", 1.0, op=op, transport=transport)
        self.metrics.count("iccl_bytes", float(nbytes), op=op,
                           transport=transport)

    # -------------------------------------------------- telemetry sink ----
    def make_telemetry_sink(self, plan, kinds: Sequence[str],
                            mode: str, scales_fn=None):
        """Build the callable ``StageTelemetry`` invokes from ``_record``
        (the recorder's existing host endpoint — no new callbacks).

        Receives ``(step, start_abs, durs)``; renders the observed trace
        lane from the REAL tick durations (honest wall clock — injected
        degradation does not stretch CPU ticks) and emits per-stage
        ``tick_s`` gauges with the same ``_stage_scales`` inflation the
        profile store and policy see (``scales_fn``), so the report's
        drift table shows exactly the signal the controller acted on."""
        pp, vpp, m = plan.pp, plan.vpp, plan.micro_batches
        kinds = list(kinds)
        flight = self.flight

        def sink(step: int, start_abs: Optional[float],
                 durs: Sequence[float]) -> None:
            if self.trace is not None:
                self.trace.observed_step(step, start_abs, durs, pp, vpp,
                                         m, mode, kinds)
            if self.metrics is not None:
                scales = scales_fn() if scales_fn is not None else None
                V = pp * vpp
                for i in range(pp):
                    ticks = [durs[t] for t in range(len(durs))
                             if any(0 <= t - vs < m
                                    for vs in range(i, V, pp))]
                    if not ticks:
                        continue
                    v = sum(ticks) / len(ticks)
                    if scales is not None:
                        v *= scales[i]
                    self.metrics.gauge("tick_s", v, stage=i,
                                       device=kinds[i])
            if flight is not None:
                flight.note("ticks", step=step, n=len(durs),
                            span_s=sum(durs))

        return sink

    # ------------------------------------------------------ plan events ---
    def on_plan_adopted(self, step: int, plan, cluster, cfg,
                        kinds: Sequence[str], cost_source=None) -> None:
        """Render a predicted-lane segment for the newly adopted plan and
        stamp a plan record into the metrics stream."""
        digest = plan_digest(plan)
        predicted: Dict[str, Any] = {}
        if self.trace is not None or self.metrics is not None:
            try:
                events, rep, pred = predicted_sim_events(
                    plan, cluster, cfg, cost_source=cost_source)
            except Exception as e:   # predicted lane is best-effort
                events, rep, pred = [], None, None
                if self.flight is not None:
                    self.flight.note("predicted-lane-error", step=step,
                                     error=repr(e))
            if pred is not None:
                predicted = {"iter_time": pred.iter_time,
                             "bubble_frac": pred.bubble_frac,
                             "stage_times_fwd": list(pred.stage_times_fwd)}
            if self.trace is not None and events:
                anchor = self.trace.now_us()
                self.trace.predicted_lane(plan, events, anchor,
                                          kinds=kinds, digest=digest)
                self.trace.instant("plan-adopted",
                                   args={"step": step, "digest": digest,
                                         "plan": plan.describe()})
        if self.metrics is not None:
            self.metrics.plan(step, digest, plan.to_dict(), predicted)
        if self.flight is not None:
            self.flight.note("plan-adopted", step=step, digest=digest,
                             plan=plan.describe())

    def on_search(self, step: int, result) -> None:
        """Stamp a planner search's sweep economics into the metrics
        stream: how many per-stage-parallelism candidates were actually
        scored vs skipped by the lower-bound cutoff.  The asymmetric
        sweep multiplies the candidate space (per-island tp cross
        product), so the scored/pruned split is the signal that the
        bound is still doing its job."""
        if self.metrics is not None:
            self.metrics.count("planner_candidates",
                               float(getattr(result, "evaluated", 0)),
                               outcome="scored")
            self.metrics.count("planner_candidates",
                               float(getattr(result, "pruned", 0)),
                               outcome="pruned")
        if self.flight is not None:
            self.flight.note("planner-search", step=step,
                             evaluated=getattr(result, "evaluated", 0),
                             pruned=getattr(result, "pruned", 0))

    # ------------------------------------------------------- adapt loop ---
    def on_adapt_event(self, event) -> None:
        """Funnel for every AdaptEvent the trainer emits."""
        d = event.to_dict()
        action = d.get("action", "?")
        if self.trace is not None:
            self.trace.instant(f"adapt:{action}", args=d)
        if self.metrics is not None:
            self.metrics.count("adapt_events", 1.0, action=action)
            if action == "migrate":
                self.metrics.count("replans")
        if self.flight is not None:
            self.flight.note(f"adapt:{action}", step=d.get("step"),
                             detail=d)

    def on_migration(self, wall_s: float, ok: bool) -> None:
        if self.metrics is not None:
            self.metrics.observe("migration_wall_s", wall_s,
                                 ok=str(bool(ok)).lower())
        if self.flight is not None:
            self.flight.note("migration", wall_s=wall_s, ok=bool(ok))

    def on_fold(self, step: int, n: int, device: str) -> None:
        if self.metrics is not None and n:
            self.metrics.count("store_folds", float(n), device=device)
        if self.flight is not None:
            self.flight.note("fold", step=step, n=n, device=device)

    # --------------------------------------------------------- step loop --
    def on_step(self, step: int, dt: float,
                health: Optional[Dict[str, float]] = None) -> None:
        """Per-step emission point; ``health`` is the exact dict
        ``Trainer.schedule_health()`` returned, so the gauges carry the
        bit-identical floats the report must reproduce."""
        if self.metrics is not None:
            self.metrics.gauge("step_time_s", dt)
            if health is not None:
                self.metrics.gauge("observed_bubble",
                                   health["observed_bubble"])
                self.metrics.gauge("predicted_bubble",
                                   health["predicted_bubble"])
            self.metrics.flush(step)
        if self.flight is not None:
            self.flight.note("step", step=step, dt=dt)

    # ------------------------------------------------------------ dumps ---
    def flight_dump(self, reason: str) -> Optional[Path]:
        if self.flight is None or self.flight_out is None:
            return None
        return self.flight.dump(self.flight_out, reason)

    def write_events(self, events: List) -> Optional[Path]:
        """Persist the AdaptEvent log as JSONL (header + one line per
        event) at ``events_out``."""
        if self.events_out is None:
            return None
        from repro_torch.adapt.policy import events_jsonl
        self.events_out.parent.mkdir(parents=True, exist_ok=True)
        self.events_out.write_text(events_jsonl(events, run=self.run))
        return self.events_out

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._iccl_installed:
            from repro_torch.iccl import communicator
            communicator.set_collective_sink(None)
            self._iccl_installed = False
        if self.trace is not None and self.trace_out is not None:
            self.trace.save(self.trace_out)
        if self.metrics is not None:
            self.metrics.close()
