"""Chrome-trace / Perfetto timeline export: predicted vs observed lanes.

The artifact is standard Chrome trace-event JSON (``chrome://tracing`` /
https://ui.perfetto.dev both open it): an object with ``traceEvents``
plus the run identity under ``otherData``.  Two process lanes per run:

  * **predicted** (pid 2) — the winning plan's schedule as the simulator
    oracle executed it (``SimEvent`` trace under the predictor's
    timings): one track per PHYSICAL stage, one slice per (microbatch,
    chunk, direction) op, with flow arrows for every P2P hop —
    stage i -> i+1 activations and the interleaved pp-1 -> 0 wrap.  A
    new predicted lane segment is rendered at every plan adoption
    (launch and each replan), anchored at its adoption wall time;
  * **observed** (pid 1) — the real run reconstructed from
    ``StageTelemetry`` tick marks and step boundaries: per stage, one
    slice per tick it actively advances a microbatch (wall-clock
    aligned in callback mode; timer mode lays buckets out
    synthetically and says so in the args).

Every ``AdaptEvent`` lands as a global instant event (``adapt:trigger``,
``adapt:replan``, ``adapt:skip``, ``adapt:migrate``), so a replan reads
as a vertical line where the observed lane re-converges to a fresh
predicted lane.

All timestamps share one origin (the ``epoch`` perf_counter the
Observability object mints), in microseconds — the same clock base the
metrics stream's ``ts`` uses, so the two artifacts align.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.obs.runmeta import RunMeta

PID_OBSERVED = 1
PID_PREDICTED = 2

# direction -> chrome color name (stable visual language across runs)
_CNAME = {"F": "thread_state_running", "B": "thread_state_iowait"}


class TraceBuilder:
    """Accumulates trace events in memory; ``save`` writes the artifact.
    Purely host-side bookkeeping — never called from compiled code."""

    def __init__(self, run: Optional[RunMeta] = None,
                 epoch: Optional[float] = None):
        self.run = run or RunMeta.new()
        self.epoch = epoch if epoch is not None else time.perf_counter()
        self.events: List[Dict[str, Any]] = []
        self._flow_id = 0
        self._named_tracks = set()
        for pid, name in ((PID_OBSERVED, "observed"),
                          (PID_PREDICTED, "predicted")):
            self.events.append({"ph": "M", "name": "process_name",
                                "pid": pid,
                                "args": {"name": f"{name} "
                                                 f"[{self.run.run_id}]"}})

    # ------------------------------------------------------------ time ----
    def now_us(self) -> float:
        return (time.perf_counter() - self.epoch) * 1e6

    def _us(self, t_abs: float) -> float:
        """perf_counter timestamp -> trace microseconds."""
        return (t_abs - self.epoch) * 1e6

    # ------------------------------------------------------ lane pieces ---
    def name_track(self, pid: int, tid: int, name: str) -> None:
        if (pid, tid, name) in self._named_tracks:
            return
        self._named_tracks.add((pid, tid, name))
        self.events.append({"ph": "M", "name": "thread_name", "pid": pid,
                            "tid": tid, "args": {"name": name}})

    def slice(self, pid: int, tid: int, name: str, ts_us: float,
              dur_us: float, args: Optional[Dict[str, Any]] = None,
              cname: Optional[str] = None) -> None:
        ev = {"ph": "X", "name": name, "pid": pid, "tid": tid,
              "ts": ts_us, "dur": max(dur_us, 0.0), "cat": "pipeline"}
        if args:
            ev["args"] = args
        if cname:
            ev["cname"] = cname
        self.events.append(ev)

    def instant(self, name: str, ts_us: Optional[float] = None,
                args: Optional[Dict[str, Any]] = None) -> None:
        self.events.append({"ph": "i", "s": "g", "name": name,
                            "pid": PID_OBSERVED, "tid": 0, "cat": "adapt",
                            "ts": self.now_us() if ts_us is None else ts_us,
                            **({"args": args} if args else {})})

    def flow(self, name: str, from_pid: int, from_tid: int, ts_from: float,
             to_pid: int, to_tid: int, ts_to: float) -> None:
        self._flow_id += 1
        fid = self._flow_id
        self.events.append({"ph": "s", "id": fid, "name": name,
                            "cat": "p2p", "pid": from_pid, "tid": from_tid,
                            "ts": ts_from})
        self.events.append({"ph": "f", "bp": "e", "id": fid, "name": name,
                            "cat": "p2p", "pid": to_pid, "tid": to_tid,
                            "ts": ts_to})

    # -------------------------------------------------- predicted lane ----
    def predicted_lane(self, plan, sim_events: Sequence, anchor_us: float,
                       kinds: Optional[Sequence[str]] = None,
                       digest: str = "") -> int:
        """Render one predicted-lane segment from an executed ``SimEvent``
        trace (``repro_torch.core.simulator``), anchored at ``anchor_us`` —
        the wall time the plan was adopted.  Returns the number of trace
        events appended.  Emits one slice per op on the op's PHYSICAL
        stage track and a flow arrow per P2P hop (virtual stage vs ->
        vs+1, which crosses pp-1 -> 0 on the interleaved wrap)."""
        pp, vpp = plan.pp, plan.vpp
        n0 = len(self.events)
        for i in range(pp):
            kind = kinds[i] if kinds else "?"
            self.name_track(PID_PREDICTED, i, f"stage {i} [{kind}]")
        # finish/start of each forward, keyed (vs, mb), for the arrows
        f_end: Dict[tuple, float] = {}
        f_start: Dict[tuple, float] = {}
        for e in sim_events:
            chunk = e.vs // pp
            name = f"{e.dir} mb{e.microbatch}" + (
                f" c{chunk}" if vpp > 1 else "")
            args = {"vs": e.vs, "microbatch": e.microbatch,
                    "chunk": chunk, "dir": e.dir}
            if digest:
                args["plan_digest"] = digest
            self.slice(PID_PREDICTED, e.stage, name,
                       anchor_us + e.start * 1e6,
                       (e.finish - e.start) * 1e6, args=args,
                       cname=_CNAME.get(e.dir))
            if e.dir == "F":
                f_end[(e.vs, e.microbatch)] = anchor_us + e.finish * 1e6
                f_start[(e.vs, e.microbatch)] = anchor_us + e.start * 1e6
        V = pp * vpp
        for (vs, mb), end in f_end.items():
            nxt = f_start.get((vs + 1, mb))
            if vs + 1 < V and nxt is not None:
                wrap = (vs % pp) == pp - 1
                self.flow("wrap" if wrap else "p2p",
                          PID_PREDICTED, vs % pp, end,
                          PID_PREDICTED, (vs + 1) % pp, nxt)
        return len(self.events) - n0

    # --------------------------------------------------- observed lane ----
    def observed_step(self, step: int, start_abs: Optional[float],
                      durs: Sequence[float], pp: int, vpp: int, m: int,
                      mode: str,
                      kinds: Optional[Sequence[str]] = None) -> None:
        """Reconstruct one step of the observed lane from the telemetry
        recorder's tick durations.  ``start_abs`` is the perf_counter
        wall time of the step's first tick (callback mode); timer mode
        passes None and the bucket is laid out ending now (synthetic —
        flagged in the slice args).  A stage gets a slice at tick t only
        when one of its virtual slots actively advances a microbatch —
        the pipeline's warmup/drain shape is visible, and gaps ARE the
        observed bubble."""
        span = sum(durs)
        if start_abs is None:
            start_us = self.now_us() - span * 1e6
        else:
            start_us = self._us(start_abs)
        V = pp * vpp
        for i in range(pp):
            kind = kinds[i] if kinds else "?"
            self.name_track(PID_OBSERVED, i, f"stage {i} [{kind}]")
        cum = 0.0
        for t, d in enumerate(durs):
            for i in range(pp):
                active = [(vs // pp, t - vs)       # (chunk, microbatch)
                          for vs in range(i, V, pp) if 0 <= t - vs < m]
                if not active:
                    continue
                mbs = [mb for _, mb in active]
                name = f"tick {t} mb{min(mbs)}" + (
                    f"+{len(mbs) - 1}" if len(mbs) > 1 else "")
                self.slice(PID_OBSERVED, i, name, start_us + cum * 1e6,
                           d * 1e6,
                           args={"step": step, "tick": t, "mode": mode,
                                 "microbatches": mbs,
                                 "chunks": [c for c, _ in active]})
            cum += d
        self.slice(PID_OBSERVED, 0, f"step {step}", start_us,
                   span * 1e6, args={"step": step, "mode": mode},
                   cname="grey")

    # ------------------------------------------------------------- save ---
    def to_dict(self) -> Dict[str, Any]:
        return {"traceEvents": list(self.events),
                "displayTimeUnit": "ms",
                "otherData": self.run.to_dict()}

    def save(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_dict()))
        return path


def predicted_sim_events(plan, cluster, cfg, cost_source=None,
                         include_tp_comm: bool = False):
    """The winning plan's schedule executed by the reference oracle under
    the predictor's timings: (SimEvent list, SimReport, Prediction).

    Uses ``sim_engine="reference"`` — the oracle records traces for every
    schedule (repro_torch.core.simulator), and rendering happens once per plan
    adoption, never on a hot path."""
    from repro_torch.core import simulator
    from repro_torch.core.predictor import PerformancePredictor
    pred = PerformancePredictor(cluster, cfg, cost_source=cost_source,
                                include_tp_comm=include_tp_comm,
                                sim_engine="reference")
    if plan.schedule == "interleaved-1f1b":
        timings = pred.virtual_timings(plan)
    else:
        timings = [pred.stage_timing(plan, i) for i in range(plan.pp)]
    trace: List = []
    rep = simulator.simulate(
        timings, plan.micro_batches, plan.schedule,
        dp_allreduce=pred.dp_allreduce_time(plan),
        eager_slack=plan.eager_slack,
        vpp=plan.vpp if plan.schedule == "interleaved-1f1b" else 1,
        trace=trace)
    return trace, rep, pred.predict(plan)
