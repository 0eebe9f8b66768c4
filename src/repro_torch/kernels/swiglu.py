"""SwiGLU gate on the card: wrapper of ``csrc/swiglu.cu``.

Replaces the Pallas kernel ``repro/kernels/swiglu.py::swiglu``.  Bound by
bytes; one elementwise pass of 16-byte loads computes silu(g) * u in fp32
and writes the output dtype directly, fusing the model's cast of the MLP
hidden state to x.dtype.  Plain version: ``kernels/ref.py::swiglu``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

launches = 0   # kernel launches since the last reset


def swiglu(g: torch.Tensor, u: torch.Tensor,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """g, u: same shape and dtype, contiguous CUDA tensors."""
    global launches
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
