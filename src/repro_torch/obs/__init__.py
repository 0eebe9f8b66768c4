"""Unified run observability (port of ``repro/obs``): predicted-vs-observed
timeline tracing, an append-only metrics stream, and a flight recorder for
the adaptation loop.  See docs/observability.md for the operator runbook;
``python -m repro_torch.obs.report`` renders a run's report."""
from repro_torch.obs.flight import (FlightRecorder, install_sigterm,
                                    uninstall_sigterm)
from repro_torch.obs.metrics import MetricsLog, read_jsonl
from repro_torch.obs.observer import Observability
from repro_torch.obs.runmeta import RunMeta, new_run_id, plan_digest
from repro_torch.obs.trace import TraceBuilder, predicted_sim_events

__all__ = [
    "FlightRecorder", "install_sigterm", "uninstall_sigterm",
    "MetricsLog", "read_jsonl",
    "Observability", "RunMeta", "new_run_id", "plan_digest",
    "TraceBuilder", "predicted_sim_events",
]
