"""RMSNorm on the card: wrapper of ``csrc/rmsnorm.cu``.

Replaces the Pallas kernel ``repro/kernels/rmsnorm.py::rmsnorm``.  Bound by
bytes (each x read once, each output written once); the kernel reads a row
with 16-byte loads, reduces the fp32 sum of squares in registers and shared
memory, and writes the scaled row in x's dtype.  Plain version:
``kernels/ref.py::rmsnorm``.

``rmsnorm_bwd`` wraps the backward of the same source (dx and the
cross-row dscale sum, the latter from per-block partial rows and a second
pass; bound by bytes).  Plain version: ``kernels/ref.py::rmsnorm_bwd``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

BWD_BLOCKS = 2 * 132    # rows are walked by at most two blocks per SM
launches = 0       # rmsnorm launches since the last reset
bwd_launches = 0   # rmsnorm_bwd launches since the last reset


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D) contiguous CUDA tensor; scale: (D,) of x's dtype."""
    global launches
    build.forbid_grad("rmsnorm", "call kernels.ops.rmsnorm", x, scale)
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


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-5):
    """x, dy: (..., D) contiguous CUDA tensors of one dtype; scale: (D,).
    Returns (dx in x's dtype, dscale (D,) fp32)."""
    global bwd_launches
    build.forbid_grad("rmsnorm_bwd", "call kernels.ops.rmsnorm", x, scale, dy)
    dev = build.require_cuda(x, scale, dy)
    code = build.dtype_code(x)
    D = x.shape[-1]
    if scale.dtype != x.dtype or dy.dtype != x.dtype:
        raise TypeError(f"x {x.dtype}, scale {scale.dtype}, dy {dy.dtype} "
                        "must match")
    if tuple(scale.shape) != (D,) or dy.shape != x.shape:
        raise ValueError(f"scale {tuple(scale.shape)}, dy {tuple(dy.shape)} "
                         f"for x {tuple(x.shape)}")
    if not (x.is_contiguous() and scale.is_contiguous()
            and dy.is_contiguous()):
        raise ValueError("rmsnorm_bwd kernel takes contiguous x, scale, dy")
    dx = torch.empty_like(x)
    dscale = torch.zeros((D,), dtype=torch.float32, device=dev)
    rows = x.numel() // D if D else 0
    if rows == 0:
        return dx, dscale
    nb = min(rows, BWD_BLOCKS)
    partial = torch.empty((nb, D), dtype=torch.float32, device=dev)
    err = build.library().rmsnorm_bwd(
        x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        partial.data_ptr(), dscale.data_ptr(), rows, D, nb, float(eps),
        code, build.stream_handle(dev))
    build.check(err, "rmsnorm_bwd")
    bwd_launches += 1
    return dx, dscale
