"""Where a serving step's time goes on the card, under torch.profiler.

Profiles a few 1000-token prefills and a few batched decode steps of a
ported arch (llama3-8b or falcon-mamba-7b) at full width and depth.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        [--arch falcon-mamba-7b] [--out PATH]

The shapes are those of ``chip_smoke.py``'s serve run: prompts of up to
1000 tokens, ``max_batch=8``, ``max_len=2048``.  Each phase runs its
repetitions twice: once traced, once not.  From the traced window it
reports the host wall time (ending in a synchronize), the device time
summed over the kernels the profiler saw in that same window, the
device's idle share of that window, the time of each of the port's
kernels and the largest other device ops.  The untraced repetitions give
the wall time without the profiler's host overhead.  Weights are random,
made from seed 0.  The last stdout line is the JSON summary; ``--out``
also writes it.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.models import registry
from repro_torch.utils.device import resolve_device, synchronize

# per arch: the serve cell's shapes and the repetitions of each phase
SHAPES = {
    "llama3-8b": dict(prompt_len=1000, batch=8, max_len=2048,
                      prefill_reps=4, decode_reps=8),
    "falcon-mamba-7b": dict(prompt_len=1000, batch=8, max_len=2048,
                            prefill_reps=4, decode_reps=8),
}
SEED = 0
PORT_KERNELS = ("rmsnorm_", "swiglu_", "flash_fwd_",   # device symbol
                "ssm_scan_")                           # prefixes


def _device_us(evt) -> float:
    """Device time of a device-side event (kernel, memcpy, memset); host
    ops, whose totals would count their kernels a second time, give 0."""
    if evt.device_type != DeviceType.CUDA:
        return 0.0
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _summarize(prof, wall_s: float, reps: int, top: int = 8) -> dict:
    rows = [(e.key, _device_us(e), e.count) for e in prof.key_averages()]
    rows = [r for r in rows if r[1] > 0]
    if not rows:
        raise RuntimeError("the profiler saw no device time")
    busy_ms = sum(r[1] for r in rows) / reps / 1e3
    rows.sort(key=lambda r: -r[1])
    kernels = {p.rstrip("_"): sum(r[1] for r in rows if p in r[0]) / reps
               / 1e3 for p in PORT_KERNELS}
    wall_ms = wall_s / reps * 1e3
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1 - busy_ms / wall_ms,
        "port_kernels_ms": kernels,
        "top_device_ops": [{"name": k[:90], "ms": us / reps / 1e3,
                            "calls": n // reps} for k, us, n in rows[:top]],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3-8b", choices=sorted(SHAPES))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    shp = SHAPES[args.arch]
    plen, batch, max_len = shp["prompt_len"], shp["batch"], shp["max_len"]

    dev = resolve_device("cuda")
    b = registry.get_bundle(args.arch)
    cfg = b.cfg
    params = b.init(cfg, seed=SEED, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    prompt = torch.randint(0, cfg.vocab_size, (1, plen), generator=gen,
                           device=dev)
    cache = b.init_cache(batch, max_len, dev)
    cache["pos"] = torch.full((batch,), plen, dtype=torch.int64, device=dev)
    tok = torch.randint(0, cfg.vocab_size, (batch, 1), generator=gen,
                        device=dev)

    def prefill():
        return b.prefill(params, {"tokens": prompt}, cfg, max_len)

    def decode():
        logits, _ = b.decode_step(params, tok, cache, cfg)
        cache["pos"] -= 1          # stay at the same depth every step
        return logits

    out = {"arch": cfg.name, "device_name": torch.cuda.get_device_name(dev),
           "prompt_len": plen, "batch": batch, "max_len": max_len}
    for phase, fn, reps in (("prefill", prefill, shp["prefill_reps"]),
                            ("decode_step", decode, shp["decode_reps"])):
        fn()                       # warm up (allocator, cuBLAS handles)
        synchronize(dev)
        # busy and wall come from this one traced window
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            synchronize(dev)
            wall = time.perf_counter() - t0
        out[phase] = _summarize(prof, wall, reps)
        out[phase]["reps"] = reps
        # the same phase without the profiler: its host overhead
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        synchronize(dev)
        out[phase]["wall_ms_untraced"] = (time.perf_counter() - t0) \
            / reps * 1e3
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(line)


if __name__ == "__main__":
    main()
