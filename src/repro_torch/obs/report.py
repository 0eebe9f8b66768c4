"""Drift-attribution report over exported observability artifacts.

    python -m repro_torch.obs.report --metrics run/metrics.jsonl \
        [--events run/events.jsonl] [--flight run/flight.json] [--json]

Reads the metrics JSONL (plus, optionally, the AdaptEvent log and a
flight-recorder dump), checks that all artifacts carry the same run id,
and prints:

  * **bubble decomposition** — last ``observed_bubble`` vs
    ``predicted_bubble`` gauges and their ratio.  The ratio uses the
    LITERAL formula from ``Trainer.schedule_health()``
    (``obs / max(pred, 1e-9)``) on the gauge floats, which round-trip
    JSON exactly — so the report reproduces the trainer's number
    bit-for-bit;
  * **per-stage drift** — observed mean tick per stage (``tick_s``
    gauges, carrying the same scale inflation the controller saw)
    against the adopted plan's predicted forward times, both normalised
    by their own mean: a stage whose normalised ratio is >1 is slower
    *relative to the plan's expectation* — the straggler;
  * **top-k collectives** — ICCL traffic ranked by trace-time bytes per
    (op, transport);
  * adaptation summary — replan / event counts, plus the AdaptEvent and
    flight timelines when their artifacts are supplied.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

from repro_torch.obs.metrics import read_jsonl


class RunMismatch(ValueError):
    """Artifacts from different runs must not be correlated."""


def _last_gauges(records: List[Dict[str, Any]]) -> Dict[tuple, Dict]:
    """(name, sorted-label-items) -> the LAST gauge/counter record."""
    out: Dict[tuple, Dict] = {}
    for r in records:
        if r.get("kind") in ("gauge", "counter"):
            key = (r["name"], tuple(sorted(r.get("labels", {}).items())))
            out[key] = r
    return out


def _check_run_ids(headers: Dict[str, Optional[str]]) -> str:
    ids = {k: v for k, v in headers.items() if v is not None}
    if len(set(ids.values())) > 1:
        raise RunMismatch(f"artifacts disagree on run_id: {ids}")
    return next(iter(ids.values()), "?")


def build_report(metrics: List[Dict[str, Any]],
                 events: Optional[List[Dict[str, Any]]] = None,
                 flight: Optional[Dict[str, Any]] = None,
                 top_k: int = 5) -> Dict[str, Any]:
    """Pure function over parsed artifact records — the CLI and the tests
    share it."""
    header = next((r for r in metrics if r.get("kind") == "header"), {})
    ev_header = (events or [{}])[0] if events else None
    _check_run_ids({
        "metrics": header.get("run_id"),
        "events": (ev_header or {}).get("run_id"),
        "flight": (flight or {}).get("run", {}).get("run_id"),
    })
    last = _last_gauges(metrics)
    plans = [r for r in metrics if r.get("kind") == "plan"]
    plan = plans[-1] if plans else None

    rep: Dict[str, Any] = {
        "run_id": header.get("run_id"),
        "plan_digest": (plan or {}).get("digest",
                                        header.get("plan_digest")),
        "arch": header.get("arch"),
        "n_plans": len(plans),
    }

    # ---- bubble decomposition (bit-exact vs Trainer.schedule_health) ----
    obs_rec = last.get(("observed_bubble", ()))
    pred_rec = last.get(("predicted_bubble", ()))
    if obs_rec is not None and pred_rec is not None:
        obs = obs_rec["value"]
        pred = pred_rec["value"]
        # identical formula (and floats) to Trainer.schedule_health()
        rep["schedule_health"] = {
            "observed_bubble": obs,
            "predicted_bubble": pred,
            "ratio": obs / max(pred, 1e-9),
        }
        rep["bubble_drift"] = obs - pred

    # ---- per-stage drift -----------------------------------------------
    ticks: Dict[int, Dict] = {}
    for (name, labels), r in last.items():
        if name == "tick_s":
            ld = dict(labels)
            ticks[int(ld["stage"])] = {"tick_s": r["value"],
                                       "device": ld.get("device", "?")}
    pred_fwd = (plan or {}).get("predicted", {}).get("stage_times_fwd")
    if ticks:
        stages = sorted(ticks)
        obs_vals = [ticks[i]["tick_s"] for i in stages]
        obs_mean = sum(obs_vals) / len(obs_vals)
        rows = []
        for i in stages:
            row = {"stage": i, "device": ticks[i]["device"],
                   "observed_tick_s": ticks[i]["tick_s"],
                   "observed_rel": ticks[i]["tick_s"] / obs_mean
                   if obs_mean else 0.0}
            if pred_fwd and i < len(pred_fwd):
                pmean = sum(pred_fwd) / len(pred_fwd)
                row["predicted_fwd_s"] = pred_fwd[i]
                row["predicted_rel"] = pred_fwd[i] / pmean if pmean else 0.0
                row["drift"] = (row["observed_rel"] / row["predicted_rel"]
                                if row["predicted_rel"] else 0.0)
            rows.append(row)
        rep["stages"] = rows

    # ---- top-k collectives by trace-time bytes --------------------------
    coll = []
    for (name, labels), r in last.items():
        if name == "iccl_bytes":
            ld = dict(labels)
            calls = last.get(("iccl_calls", labels), {}).get("value", 0.0)
            coll.append({"op": ld.get("op", "?"),
                         "transport": ld.get("transport", "?"),
                         "bytes": r["value"], "calls": calls})
    coll.sort(key=lambda c: -c["bytes"])
    rep["collectives"] = coll[:top_k]

    # ---- adaptation summary ---------------------------------------------
    counts = {}
    for (name, labels), r in last.items():
        if name == "adapt_events":
            counts[dict(labels).get("action", "?")] = r["value"]
    rep["adapt_events"] = counts
    rep["replans"] = last.get(("replans", ()), {}).get("value", 0.0)
    if events:
        rep["events"] = [r for r in events if r.get("kind") != "header"]
    if flight:
        rep["flight"] = {"reason": flight.get("reason"),
                         "n_events": len(flight.get("events", []))}
    return rep


def _fmt(rep: Dict[str, Any]) -> str:
    L = [f"run {rep.get('run_id')}  plan {rep.get('plan_digest')}  "
         f"arch {rep.get('arch')}  plans-adopted {rep.get('n_plans')}"]
    sh = rep.get("schedule_health")
    if sh:
        L += ["", "bubble decomposition",
              f"  observed  {sh['observed_bubble']:.6f}",
              f"  predicted {sh['predicted_bubble']:.6f}",
              f"  ratio     {sh['ratio']:.4f}   "
              f"drift {rep.get('bubble_drift', 0.0):+.6f}"]
    if rep.get("stages"):
        L += ["", "per-stage drift (rel = value / its lane's mean; "
              "drift = observed_rel / predicted_rel)"]
        L.append(f"  {'stage':>5} {'device':<10} {'obs tick_s':>12} "
                 f"{'obs rel':>8} {'pred rel':>9} {'drift':>7}")
        for s in rep["stages"]:
            L.append(
                f"  {s['stage']:>5} {s['device']:<10} "
                f"{s['observed_tick_s']:>12.6f} {s['observed_rel']:>8.3f} "
                + (f"{s.get('predicted_rel', 0.0):>9.3f} "
                   f"{s.get('drift', 0.0):>7.3f}"
                   if "predicted_rel" in s else f"{'-':>9} {'-':>7}"))
    if rep.get("collectives"):
        L += ["", f"top collectives by trace-time bytes"]
        for c in rep["collectives"]:
            L.append(f"  {c['op']:<16} {c['transport']:<12} "
                     f"{int(c['bytes']):>14,d} B  "
                     f"{int(c['calls']):>4d} calls")
    L += ["", f"replans {int(rep.get('replans', 0))}  "
          f"adapt events {rep.get('adapt_events') or {}}"]
    for e in rep.get("events", []):
        L.append(f"  [{e.get('action', '?'):<8}] step {e.get('step')}: "
                 f"{e.get('reason', '')}")
    if rep.get("flight"):
        f = rep["flight"]
        L.append(f"flight dump: reason={f['reason']} "
                 f"events={f['n_events']}")
    return "\n".join(L)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Drift-attribution report over exported "
                    "observability artifacts.")
    ap.add_argument("--metrics", required=True,
                    help="metrics JSONL from --metrics-out")
    ap.add_argument("--events", default=None,
                    help="AdaptEvent JSONL from --events-out")
    ap.add_argument("--flight", default=None,
                    help="flight-recorder dump JSON")
    ap.add_argument("--top-k", type=int, default=5,
                    help="collectives to rank (default 5)")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as JSON instead of text")
    args = ap.parse_args(argv)

    metrics = read_jsonl(args.metrics)
    events = read_jsonl(args.events) if args.events else None
    flight = (json.loads(open(args.flight).read())
              if args.flight else None)
    try:
        rep = build_report(metrics, events, flight, top_k=args.top_k)
    except RunMismatch as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(json.dumps(rep) if args.json else _fmt(rep))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
