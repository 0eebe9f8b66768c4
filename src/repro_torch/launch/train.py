"""Training CLI (port of the plain route of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --layers 4 \
        --seq 4096 --global-batch 1

Trains ``--arch`` (random weights from seed 0) on the synthetic token
pipeline with AdamW (``--lr``, 20 warmup steps, as the JAX CLI) on
``--device`` (default ``cuda``; no silent fall back to the CPU), through
the reference loss.  The cp ring is reached, as in the JAX package,
through ``Trainer(plan=...)``.  Prints ``[train] step=.. loss=..
tok/s=..`` every ``LOG_EVERY`` steps and, last, a JSON summary.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.kernels import ops
from repro_torch.models import registry
from repro_torch.optim.adamw import AdamWConfig, tree_leaves
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.utils.device import resolve_device

LOG_EVERY = 10


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3-8b", choices=registry.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--layers", type=int, default=0,
                    help="override the arch's layer count (0 = default)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    overrides = {"num_layers": args.layers} if args.layers else {}
    bundle = registry.get_bundle(args.arch, smoke=args.smoke, **overrides)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t = Trainer(bundle, TrainerConfig(global_batch=args.global_batch,
                                      seq_len=args.seq),
                opt_cfg=AdamWConfig(lr=args.lr, warmup_steps=20),
                device=dev)
    n_params = sum(x.numel() for x in tree_leaves(t.state["params"]))
    print(f"[train] arch={bundle.cfg.name} params={n_params / 1e6:.1f}M "
          f"device={dev} start_step={t.step}", flush=True)
    ops.reset_launch_counts()
    t0 = time.time()
    done, losses = 0, []
    while done < args.steps:
        chunk = min(LOG_EVERY, args.steps - done)
        losses += t.run(chunk)["losses"]
        done += chunk
        tok_s = done * args.global_batch * args.seq / (time.time() - t0)
        print(f"[train] step={t.step} loss={losses[-1]:.4f} "
              f"tok/s={tok_s:.0f}", flush=True)
    summary = {
        "final_loss": losses[-1], "steps": t.step,
        "params_m": round(n_params / 1e6, 1), "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "tok_s": done * args.global_batch * args.seq / (time.time() - t0),
        "peak_mem_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                        if dev.type == "cuda" else None),
        # the CPU runs the plain versions: no kernel launches there
        "kernel_launches": ops.launch_counts(),
    }
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
