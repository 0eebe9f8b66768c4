"""Kernel times on the card: CUDA events around many calls, and the device
time of a call's kernels from a torch.profiler trace.

``event_ms`` is the mean time of one call between two CUDA events around
``iters`` back-to-back calls (inputs warm in L2).  Around a kernel shorter
than the host's launch path it measures the host: ``device_ms`` sums what
the profiler saw the card spend in the kernels named (every kernel, copy
and fill of the call when none are named), so launch gaps drop out, and
``device_profile`` lists them.  All need a CUDA device.  Once the profiler
has traced a process, its later kernel launches may stay slower (CUPTI
stays attached), so a process whose host-bound work is timed afterwards
should take device times in a child process (``chip_smoke.py`` phase 7).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch


def event_ms(fn: Callable[[], object], iters: int = 20,
             warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn: Callable[[], object], iters: int = 20,
                   attempts: int = 3) -> Dict[str, Tuple[float, float]]:
    """What the card ran for one call of ``fn``, from a trace of ``iters``
    calls after one untraced call: each kernel's (or copy's, or fill's)
    name -> (runs a call, device ms a call).  ``fn`` runs something on the
    card, so a trace that recorded no device activity at all is taken
    again, up to ``attempts`` traces (about one trace in a hundred came
    back empty on the H100: PERF.md)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    out: Dict[str, Tuple[float, float]] = {}
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                us = float(getattr(e, "device_time_total", 0.0)
                           or getattr(e, "cuda_time_total", 0.0))
                out[e.key] = (e.count / iters, us / iters / 1e3)
        if out:
            break
    return out


def device_ms(fn: Callable[[], object],
              kernels: Optional[Sequence[str]] = None,
              iters: int = 20) -> float:
    """Mean device time one call spends in the kernels whose names contain
    one of ``kernels``, or in everything it runs on the card when
    ``kernels`` is None; raises if the profiler saw none."""
    ms = sum(t for name, (_, t) in device_profile(fn, iters).items()
             if kernels is None or any(k in name for k in kernels))
    if ms <= 0:
        raise RuntimeError(f"the profiler saw no device time in "
                           f"{kernels or 'the call'}")
    return ms
