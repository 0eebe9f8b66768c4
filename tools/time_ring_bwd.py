#!/usr/bin/env python3
"""Time the port's ring hop backward kernel (``ring_step_bwd``, which on
one rank is the flash backward) on the card, with CUDA events.

    PYTHONPATH=src python tools/time_ring_bwd.py [--src PATH] [--reps N]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's), so that two trees can be timed in turn in one
run on one card.  The shapes: the llama3-8b reference route's flash
backward (one rank, B1 S4096 H32 Hk8 hd 128, causal), one launch of its
cp 4 ring (chunks 1383/1057/884/772, step 0, every rank), and
h2o-danube-3-4b's windowed flash backward (B1 S8192 H32 Hk8 hd 120,
window 4096), where the tree's kernel takes a window.  Each is the mean
of ``--reps`` rounds of 20 launches (inputs warm in L2).  Prints one JSON
line with the card's name and power limit.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CP_CHUNKS = (1383, 1057, 884, 772)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("time_ring_bwd: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.kernels import ring_attention as ra
    from repro_torch.utils.timing import event_ms

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    def case(R, C, H, Hk, hd):
        q, do = randn(R, 1, C, H, hd), randn(R, 1, C, H, hd)
        k, v = randn(R, 1, C, Hk, hd), randn(R, 1, C, Hk, hd)
        lse = torch.rand((R, 1, C, H), generator=gen, device=dev) + 5.0
        delta = torch.randn((R, 1, C, H), generator=gen, device=dev)
        acc = (torch.zeros(q.shape, device=dev),
               torch.zeros(k.shape, device=dev),
               torch.zeros(k.shape, device=dev))
        return (q, k, v, do, lse, delta) + acc

    def mean_ms(fn):
        return sum(event_ms(fn) for _ in range(args.reps)) / args.reps

    out = {}
    flash = case(1, 4096, 32, 8, 128)
    out["flash_bwd_S4096_hd128_causal"] = mean_ms(
        lambda: ra.ring_step_bwd(*flash, [(0, 0, 0, 4096, 4096)]))
    del flash
    ring = case(len(CP_CHUNKS), max(CP_CHUNKS), 32, 8, 128)
    hops = ra.ring_hops(CP_CHUNKS, 0)
    out["cp4_step0_launch"] = mean_ms(lambda: ra.ring_step_bwd(*ring, hops))
    del ring
    swa = case(1, 8192, 32, 8, 120)
    try:
        out["flash_bwd_S8192_hd120_window4096"] = mean_ms(
            lambda: ra.ring_step_bwd(*swa, [(0, 0, 0, 8192, 8192)],
                                     window=4096))
    except (TypeError, ValueError) as e:    # a tree without the window
        out["flash_bwd_S8192_hd120_window4096"] = None
        out["window_error"] = str(e)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    print(json.dumps({"src": str(args.src), "card": smi[0] if smi else None,
                      "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
