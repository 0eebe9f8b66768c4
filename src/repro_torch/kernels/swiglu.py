"""SwiGLU gate on the card: wrapper of ``csrc/swiglu.cu``.

Replaces the Pallas kernel ``repro/kernels/swiglu.py::swiglu``.  Bound by
bytes; one elementwise pass of 16-byte loads computes silu(g) * u in fp32
and writes the output dtype directly, fusing the model's cast of the MLP
hidden state to x.dtype.  Plain version: ``kernels/ref.py::swiglu``.

``swiglu_bwd`` wraps the backward of the same source: one elementwise fp32
pass giving dg and du (bound by bytes).  Plain version:
``kernels/ref.py::swiglu_bwd``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

launches = 0       # swiglu launches since the last reset
bwd_launches = 0   # swiglu_bwd launches since the last reset


def swiglu(g: torch.Tensor, u: torch.Tensor,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """g, u: same shape and dtype, contiguous CUDA tensors."""
    global launches
    build.forbid_grad("swiglu", "call kernels.ops.swiglu", g, u)
    dev = build.require_cuda(g, u)
    if g.shape != u.shape or g.dtype != u.dtype:
        raise ValueError(f"g {tuple(g.shape)} {g.dtype} and u "
                         f"{tuple(u.shape)} {u.dtype} must match")
    if not (g.is_contiguous() and u.is_contiguous()):
        raise ValueError("swiglu kernel takes contiguous g and u")
    out = torch.empty(g.shape, dtype=out_dtype or g.dtype, device=dev)
    in_code, out_code = build.dtype_code(g), build.dtype_code(out)
    if g.numel() == 0:
        return out
    err = build.library().swiglu_fwd(
        g.data_ptr(), u.data_ptr(), out.data_ptr(), g.numel(), in_code,
        out_code, build.stream_handle(dev))
    build.check(err, "swiglu")
    launches += 1
    return out


def swiglu_bwd(g: torch.Tensor, u: torch.Tensor, dh: torch.Tensor):
    """g, u: same shape and dtype; dh: their shape, the forward's output
    dtype; all contiguous CUDA tensors.  Returns (dg, du) in g's dtype."""
    global bwd_launches
    build.forbid_grad("swiglu_bwd", "call kernels.ops.swiglu", g, u, dh)
    dev = build.require_cuda(g, u, dh)
    if g.shape != u.shape or g.dtype != u.dtype or dh.shape != g.shape:
        raise ValueError(f"g {tuple(g.shape)} {g.dtype}, u {tuple(u.shape)} "
                         f"{u.dtype}, dh {tuple(dh.shape)} must match")
    if not (g.is_contiguous() and u.is_contiguous() and dh.is_contiguous()):
        raise ValueError("swiglu_bwd kernel takes contiguous g, u, dh")
    in_code, out_code = build.dtype_code(g), build.dtype_code(dh)
    dg, du = torch.empty_like(g), torch.empty_like(u)
    if g.numel() == 0:
        return dg, du
    err = build.library().swiglu_bwd(
        g.data_ptr(), u.data_ptr(), dh.data_ptr(), dg.data_ptr(),
        du.data_ptr(), g.numel(), in_code, out_code,
        build.stream_handle(dev))
    build.check(err, "swiglu_bwd")
    bwd_launches += 1
    return dg, du
