"""RMSNorm on the card: wrapper of ``csrc/rmsnorm.cu``.

Replaces the Pallas kernel ``repro/kernels/rmsnorm.py::rmsnorm``.  Bound by
bytes (each x read once, each output written once); the kernel reads a row
with 16-byte loads, reduces the fp32 sum of squares in registers and shared
memory, and writes the scaled row in x's dtype.  Plain version:
``kernels/ref.py::rmsnorm``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

launches = 0   # kernel launches since the last reset


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D) contiguous CUDA tensor; scale: (D,) of x's dtype."""
    global launches
    dev = build.require_cuda(x, scale)
    code = build.dtype_code(x)
    D = x.shape[-1]
    if scale.dtype != x.dtype:
        raise TypeError(f"scale dtype {scale.dtype} != x dtype {x.dtype}")
    if tuple(scale.shape) != (D,):
        raise ValueError(f"scale shape {tuple(scale.shape)} != ({D},)")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm kernel takes contiguous x and scale")
    out = torch.empty_like(x)
    rows = x.numel() // D if D else 0
    if rows == 0:
        return out
    err = build.library().rmsnorm_fwd(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, D, float(eps),
        code, build.stream_handle(dev))
    build.check(err, "rmsnorm")
    launches += 1
    return out
