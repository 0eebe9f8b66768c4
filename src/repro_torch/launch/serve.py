"""Continuous-batching serving CLI (port of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \
        --smoke --device cpu

Serves a seeded mixed-length trace through ``ServeEngine`` with random
weights made from ``--seed``, on ``--device`` (default ``cuda``; there is
no silent fall back to the CPU).  The last stdout line is the JSON run
summary.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.kernels import flash_attention, rmsnorm, ssm_scan, swiglu
from repro_torch.models import registry
from repro_torch.serve import ServeEngine, scripted_trace
from repro_torch.utils.device import resolve_device

KERNELS = {"rmsnorm": rmsnorm, "swiglu": swiglu,
           "flash_attention": flash_attention, "ssm_scan": ssm_scan}


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
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    b = registry.get_bundle(args.arch, smoke=args.smoke)
    cfg = b.cfg
    params = b.init(cfg, seed=args.seed, device=dev)
    reqs = scripted_trace(args.requests, vocab_size=cfg.vocab_size,
                          seed=args.seed, prompt_lens=args.prompt_lens,
                          gen_lens=args.gen_lens,
                          arrival_every=args.arrival_every)
    for mod in KERNELS.values():
        mod.launches = 0
    eng = ServeEngine(b, params, max_batch=args.max_batch,
                      max_len=args.max_len, temperature=args.temperature,
                      seed=args.seed, device=dev)
    report = eng.run(reqs)
    summary = {
        "arch": cfg.name, "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "max_batch": args.max_batch, "max_len": args.max_len,
        **report.to_dict(),
        # the CPU runs the plain versions: no kernel launches there
        "kernel_launches": {n: m.launches for n, m in KERNELS.items()},
    }
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
