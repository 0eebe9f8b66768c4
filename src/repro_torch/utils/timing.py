"""Kernel times on the card: CUDA events around many calls, and the device
time of named kernels from a torch.profiler trace.

``event_ms`` is the mean time of one call between two CUDA events around
``iters`` back-to-back calls (inputs warm in L2).  Around a kernel shorter
than the host's launch path it measures the host: ``device_ms`` sums what
the profiler saw the card spend in the kernels named, so launch gaps drop
out.  Both need a CUDA device.  Once ``device_ms`` has traced a process,
its later kernel launches may stay slower (CUPTI stays attached), so a
process whose host-bound work is timed afterwards should take device times
in a child process (``chip_smoke.py`` phase 7).
"""
from __future__ import annotations

from typing import Callable, Sequence

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


def device_ms(fn: Callable[[], object], kernels: Sequence[str],
              iters: int = 20) -> float:
    """Mean device time one call spends in the kernels whose names contain
    one of ``kernels``; raises if the profiler saw none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and any(k in e.key
                                                    for k in kernels):
            us += float(getattr(e, "device_time_total", 0.0)
                        or getattr(e, "cuda_time_total", 0.0))
    if us <= 0:
        raise RuntimeError(f"the profiler saw no device time in {kernels}")
    return us / iters / 1e3
