"""Continuous-batching serving CLI (port of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --plan --metrics-out M.jsonl --prom-out M.prom

Serves a seeded mixed-length trace through ``ServeEngine`` with random
weights made from ``--seed``, on ``--device`` (default ``cuda``; there is
no silent fall back to the CPU).  ``--arch`` takes every ported arch:
llama3-8b, qwen3-14b, nemotron-4-15b, h2o-danube-3-4b, falcon-mamba-7b.

``--plan`` also runs ``plan_serving`` on a demo asymmetric two-island
cluster (compute-rich against memory-bandwidth-rich) under the
``--ttft-slo`` / ``--tpot-slo`` budgets for the FULL config's costs,
stamps the chosen placement into the metrics stream, and arms the
traffic-drift replanner (``--drift-threshold``).  ``--metrics-out`` /
``--prom-out`` write the engine's metrics (JSONL, a Prometheus textfile)
under one run id, which the summary carries; ``tools/validate_serve.py
--metrics M --run-log R`` checks them against the summary.  The last
stdout line is the JSON run summary.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.core import planner
from repro_torch.core.cluster import ClusterSpec, DeviceType, NodeGroup
from repro_torch.core.plan import ServingSLO, TrafficProfile
from repro_torch.kernels import flash_attention, rmsnorm, ssm_scan, swiglu
from repro_torch.models import registry
from repro_torch.obs.metrics import MetricsLog
from repro_torch.obs.runmeta import RunMeta, plan_digest
from repro_torch.serve import DriftReplanner, ServeEngine, scripted_trace
from repro_torch.utils.device import resolve_device

KERNELS = {"rmsnorm": rmsnorm, "swiglu": swiglu,
           "flash_attention": flash_attention, "ssm_scan": ssm_scan}


def demo_asymmetric_cluster() -> ClusterSpec:
    """Compute-rich island + memory-bandwidth-rich island over an
    RDMA-class boundary: the shape where disaggregated prefill/decode
    placement wins (prefill is FLOPs-bound, decode HBM-bound)."""
    compute = DeviceType("compute-rich", peak_tflops=989.0, mfu=0.5,
                         hbm_gb=80.0, hbm_gbps=400.0)
    membw = DeviceType("membw-rich", peak_tflops=300.0, mfu=0.45,
                       hbm_gb=96.0, hbm_gbps=3200.0)
    return ClusterSpec(groups=(NodeGroup(compute, 2), NodeGroup(membw, 2)),
                       eth_gbps=400.0, eth_eff=0.9)


def _parse_lens(text: str):
    return tuple(int(x) for x in text.split(",") if x)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3-8b", choices=registry.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=48)
    ap.add_argument("--prompt-lens", type=_parse_lens, default=(8, 12, 16))
    ap.add_argument("--gen-lens", type=_parse_lens, default=(4, 8, 12, 16))
    ap.add_argument("--arrival-every", type=int, default=1,
                    help="engine steps between request arrivals")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--prom-out", default=None)
    ap.add_argument("--plan", action="store_true",
                    help="run plan_serving on the demo asymmetric cluster "
                         "and arm the traffic-drift replanner")
    ap.add_argument("--ttft-slo", type=float, default=0.5)
    ap.add_argument("--tpot-slo", type=float, default=0.05)
    ap.add_argument("--request-rate", type=float, default=4.0)
    ap.add_argument("--drift-threshold", type=float, default=1.5)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    b = registry.get_bundle(args.arch, smoke=args.smoke)
    cfg = b.cfg
    params = b.init(cfg, seed=args.seed, device=dev)
    reqs = scripted_trace(args.requests, vocab_size=cfg.vocab_size,
                          seed=args.seed, prompt_lens=args.prompt_lens,
                          gen_lens=args.gen_lens,
                          arrival_every=args.arrival_every)

    run = RunMeta.new(arch=cfg.name)
    metrics = MetricsLog(path=args.metrics_out, run=run,
                         prom_out=args.prom_out) \
        if (args.metrics_out or args.prom_out) else None

    slo = ServingSLO(ttft_s=args.ttft_slo, tpot_s=args.tpot_slo)
    traffic = TrafficProfile(
        prompt_len=round(sum(args.prompt_lens) / len(args.prompt_lens)),
        gen_len=round(sum(args.gen_lens) / len(args.gen_lens)),
        request_rate=args.request_rate)
    plan_doc = None
    replanner = None
    if args.plan:
        # the demo cluster is sized for the FULL config's costs: the
        # placement search is about islands, not the smoke weights
        plan_cfg = registry.get_config(args.arch)
        cluster = demo_asymmetric_cluster()
        res = planner.plan_serving(cluster, plan_cfg, slo=slo,
                                   traffic=traffic)
        plan_doc = {"plan": res.plan.to_dict(),
                    "predicted": res.predicted.to_dict(),
                    "describe": res.plan.describe(),
                    "evaluated": res.evaluated}
        print(f"serving plan: {res.plan.describe()}  "
              f"ttft={res.predicted.ttft_s * 1e3:.1f}ms "
              f"tpot={res.predicted.tpot_s * 1e3:.2f}ms "
              f"slo_score={res.predicted.slo_score:.3f}")
        if metrics is not None:
            metrics.plan(0, plan_digest(res.plan), res.plan.to_dict(),
                         res.predicted.to_dict())

        def replan(observed: TrafficProfile):
            return planner.plan_serving(cluster, plan_cfg, slo=slo,
                                        traffic=observed)

        replanner = DriftReplanner(traffic, replan,
                                   threshold=args.drift_threshold)

    for mod in KERNELS.values():
        mod.launches = 0
    eng = ServeEngine(b, params, max_batch=args.max_batch,
                      max_len=args.max_len, temperature=args.temperature,
                      seed=args.seed, metrics=metrics, replanner=replanner,
                      device=dev)
    report = eng.run(reqs)
    if metrics is not None:
        metrics.close()
    summary = {
        "run_id": run.run_id, "arch": cfg.name, "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "max_batch": args.max_batch, "max_len": args.max_len,
        **report.to_dict(),
        # the CPU runs the plain versions: no kernel launches there
        "kernel_launches": {n: m.launches for n, m in KERNELS.items()},
    }
    if plan_doc is not None:
        summary["plan"] = plan_doc
    if eng.replan_events:
        summary["replan_events"] = eng.replan_events
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
