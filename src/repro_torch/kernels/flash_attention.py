"""Flash attention forward on the card: wrapper of
``csrc/flash_attention.cu``.

Replaces the Pallas kernel ``repro/kernels/flash_attention.py::
flash_attention``.  At serving shapes it is bound by operations (the
score and value products), not bytes.  One thread block per (b, h, 64-row
q tile) loops over the kv tiles inside the causal/window band with fp32
m/l/acc in registers, so the score matrix never reaches device memory.
This first version multiplies with fp32 FMAs on the CUDA cores, not the
tensor cores (see PERF.md for its distance from the bound).  Plain
version: ``kernels/ref.py::flash_attention``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128)
launches = 0   # kernel launches since the last reset


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B,Sq,H,hd); k/v: (B,Sk,Hk,hd), any strides with unit stride on
    hd.  Returns a contiguous (B,Sq,H,hd) tensor of q's dtype."""
    global launches
    dev = build.require_cuda(q, k, v)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: want (B,S,H,hd) and k == v")
    B, Sq, H, hd = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch or head dim")
    if Hk == 0 or H % Hk:
        raise ValueError(f"n_heads {H} not a multiple of n_kv_heads {Hk}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes differ: {q.dtype} {k.dtype} {v.dtype}")
    code = build.dtype_code(q)
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash kernel needs unit stride on the head dim")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap < 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    if max(B, H) > 65535 or max(Sq, Sk) >= 2 ** 31:
        raise ValueError(f"shape {tuple(q.shape)} exceeds the launch grid")
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=dev)
    if B == 0 or Sq == 0:
        return out
    err = build.library().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Sk, H, Hk, hd,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        int(causal), window or 0, float(softcap or 0.0),
        1.0 / math.sqrt(hd), code, build.stream_handle(dev))
    build.check(err, "flash_attention")
    launches += 1
    return out
