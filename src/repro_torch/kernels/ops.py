"""Kernel dispatch by device (port of ``repro/kernels/ops.py``).

The tensor's device decides, and nothing else: a CPU tensor goes to the
plain version in ``ref``; a CUDA tensor goes to the hand-written kernel,
whose wrapper launches it or raises.  There is no mode switch and no
fallback from the kernel to the plain version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import ssm_scan as _ss
from repro_torch.kernels import swiglu as _sg


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for tensors on {t.device}")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    if _on_cpu(x):
        return ref.rmsnorm(x, scale, eps)
    return _rn.rmsnorm(x, scale, eps)


def swiglu(g: torch.Tensor, u: torch.Tensor,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    if _on_cpu(g):
        return ref.swiglu(g, u, out_dtype)
    return _sg.swiglu(g, u, out_dtype)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    if _on_cpu(q):
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap)


def ssm_scan(u, dt, Bc, Cc, A) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B,S,di), h_last (B,di,ds)), both fp32."""
    if _on_cpu(u):
        return ref.ssm_scan(u, dt, Bc, Cc, A)
    return _ss.ssm_scan(u, dt, Bc, Cc, A)
