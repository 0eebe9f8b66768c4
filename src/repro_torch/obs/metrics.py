"""Metrics registry: counters / gauges / observations as append-only JSONL
plus an optional Prometheus textfile snapshot.

Emission model (designed for zero hot-path cost):

  * updates (``count`` / ``gauge`` / ``observe``) only mutate in-memory
    state — no I/O, no formatting;
  * ``flush(step)`` writes one JSONL line per metric that changed since
    the last flush (counters emit their CUMULATIVE value, gauges their
    current value, observations each raw sample).  The trainer flushes
    once per step, so the stream is bounded by metrics-changed-per-step,
    not calls-per-step;
  * ``close()`` flushes and, when a ``prom_out`` path was given, writes a
    Prometheus textfile snapshot (counters/gauges verbatim, observations
    as ``_count`` / ``_sum`` / ``_min`` / ``_max`` summaries) for a node
    exporter's textfile collector to scrape.

Record schema (validated in CI against ``tools/metrics_schema.json``):

    {"kind": "header", "schema": 1, run identity fields...}
    {"kind": "counter"|"gauge"|"observe", "name": str, "value": number,
     "step": int|null, "ts": float, "labels": {str: str|number}}
    {"kind": "plan", "step": int, "ts": float, "digest": str,
     "plan": {...ParallelPlan.to_dict()...}, "predicted": {...}}

``ts`` is seconds since the stream was opened (one monotonic clock for
the whole run — the same origin the Chrome trace uses, so the two
artifacts align).  Floats round-trip exactly through JSON (``repr``
serialization), which is what lets ``repro_torch.obs.report`` reproduce
``Trainer.schedule_health()`` numbers bit-exactly from this stream.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.obs.runmeta import RunMeta

SCHEMA_VERSION = 1

KINDS = ("header", "counter", "gauge", "observe", "plan")


def _label_key(labels: Dict[str, Any]) -> Tuple:
    return tuple(sorted(labels.items()))


class MetricsLog:
    """See module docstring.  ``path=None`` keeps the stream in memory
    (``lines`` holds the records) — the test/report path."""

    def __init__(self, path=None, run: Optional[RunMeta] = None,
                 prom_out=None, epoch: Optional[float] = None):
        self.path = Path(path) if path else None
        self.prom_out = Path(prom_out) if prom_out else None
        self.run = run or RunMeta.new()
        self.epoch = epoch if epoch is not None else time.perf_counter()
        self.lines: List[Dict[str, Any]] = []   # in-memory mirror
        self._fh = None
        if self.path is not None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = self.path.open("w")
        # (name, labelkey) -> state
        self._counters: Dict[Tuple, float] = {}
        self._gauges: Dict[Tuple, float] = {}
        self._dirty: Dict[Tuple, Tuple[str, str, Dict]] = {}
        self._pending_obs: List[Tuple[str, float, Dict]] = []
        self._pending_plan: List[Dict[str, Any]] = []
        # observation summaries for the prometheus snapshot
        self._obs_sum: Dict[Tuple, Dict[str, float]] = {}
        self._closed = False
        self._write({"kind": "header", "schema": SCHEMA_VERSION,
                     **self.run.to_dict()})

    # ---------------------------------------------------------- updates ---
    def count(self, name: str, value: float = 1.0, **labels) -> None:
        key = (name, _label_key(labels))
        self._counters[key] = self._counters.get(key, 0.0) + value
        self._dirty[key] = ("counter", name, labels)

    def gauge(self, name: str, value: float, **labels) -> None:
        key = (name, _label_key(labels))
        self._gauges[key] = float(value)
        self._dirty[key] = ("gauge", name, labels)

    def observe(self, name: str, value: float, **labels) -> None:
        self._pending_obs.append((name, float(value), labels))
        key = (name, _label_key(labels))
        s = self._obs_sum.setdefault(key, {"count": 0.0, "sum": 0.0,
                                           "min": float("inf"),
                                           "max": float("-inf"),
                                           "_name": name,
                                           "_labels": labels})
        s["count"] += 1.0
        s["sum"] += float(value)
        s["min"] = min(s["min"], float(value))
        s["max"] = max(s["max"], float(value))

    def plan(self, step: int, digest: str, plan_doc: Dict[str, Any],
             predicted: Dict[str, Any]) -> None:
        """One plan-adoption record (launch plan and every replan)."""
        self._pending_plan.append(
            {"kind": "plan", "step": step, "ts": self._ts(),
             "digest": digest, "plan": plan_doc, "predicted": predicted})

    # --------------------------------------------------------- emission ---
    def _ts(self) -> float:
        return time.perf_counter() - self.epoch

    def _write(self, rec: Dict[str, Any]) -> None:
        self.lines.append(rec)
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")

    def flush(self, step: Optional[int] = None) -> int:
        """Emit every changed metric since the last flush; returns the
        number of records written."""
        n = 0
        ts = self._ts()
        for rec in self._pending_plan:
            self._write(rec)
            n += 1
        self._pending_plan = []
        for key, (kind, name, labels) in sorted(
                self._dirty.items(), key=lambda kv: kv[0]):
            value = (self._counters if kind == "counter"
                     else self._gauges)[key]
            self._write({"kind": kind, "name": name, "value": value,
                         "step": step, "ts": ts, "labels": labels})
            n += 1
        self._dirty = {}
        for name, value, labels in self._pending_obs:
            self._write({"kind": "observe", "name": name, "value": value,
                         "step": step, "ts": ts, "labels": labels})
            n += 1
        self._pending_obs = []
        if self._fh is not None and n:
            self._fh.flush()
        return n

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.flush()
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if self.prom_out is not None:
            self.prom_out.parent.mkdir(parents=True, exist_ok=True)
            self.prom_out.write_text(self.prometheus_text())

    # ------------------------------------------------------- prometheus ---
    @staticmethod
    def _prom_labels(labels: Dict[str, Any], extra: str = "") -> str:
        parts = [f'{k}="{v}"' for k, v in sorted(labels.items())]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def prometheus_text(self) -> str:
        """The current state as a Prometheus textfile snapshot (run
        identity on every series via the ``run_id`` label)."""
        rid = f'run_id="{self.run.run_id}"'
        out = []
        for (name, _), v in sorted(self._counters.items()):
            labels = dict(_)
            out.append(f"# TYPE {name} counter")
            out.append(f"{name}{self._prom_labels(labels, rid)} {v}")
        for (name, _), v in sorted(self._gauges.items()):
            labels = dict(_)
            out.append(f"# TYPE {name} gauge")
            out.append(f"{name}{self._prom_labels(labels, rid)} {v}")
        for (name, _), s in sorted(self._obs_sum.items()):
            labels = dict(s["_labels"])
            out.append(f"# TYPE {name} summary")
            for suffix in ("count", "sum", "min", "max"):
                out.append(f"{name}_{suffix}"
                           f"{self._prom_labels(labels, rid)} {s[suffix]}")
        return "\n".join(out) + "\n"


def read_jsonl(path) -> List[Dict[str, Any]]:
    """Parse a metrics/events JSONL artifact into its records."""
    out = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if line:
            out.append(json.loads(line))
    return out
