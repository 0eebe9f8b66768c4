"""Flash attention forward on the card: wrapper of
``csrc/flash_attention.cu``.

Replaces the Pallas kernel ``repro/kernels/flash_attention.py::
flash_attention``.  At serving and training shapes it is bound by
operations (the score and value products at the bf16 tensor-core rate),
not bytes.  One thread block per (b, h, 64-row q tile) loops over the kv
tiles inside the causal/window band with fp32 m/l/acc in registers, so
the score matrix never reaches device memory.  bf16 inputs run on the
tensor cores (``mma.sync`` m16n8k16, Q's fragments held in registers,
K/V tiles through a 3-stage ``cp.async`` ring, P rounded to bf16 for the
PV product as SDPA does); fp32 inputs keep the fp32 FMA kernel, since the
tensor cores would round them to TF32 (PERF.md has both kernels' distance
from the bound).  Any head dim that is a multiple of 8 up to 256 runs:
the tiles are built at ``HEAD_DIMS``' widths, and a narrower head dim
(h2o-danube-3-4b's 120) takes the next one, its extra columns
zero-filled on load and never stored.  At recurrentgemma-9b's 256 the
bf16 kernel reads Q's fragments from shared memory at each k-step
instead of holding them (O alone takes half a lane's registers), over
32-key tiles in a 2-stage ring.  Asked for it, the kernel also
writes each row's logsumexp, which the backward
(``kernels/ops.py::FlashAttentionFn``, through the one-rank
``ring_step_bwd``) needs.  Plain version: ``kernels/ref.py::
flash_attention``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128, 256)   # the tile widths the kernel is built at
launches = 0   # kernel launches since the last reset


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    return_lse: bool = False):
    """q: (B,Sq,H,hd); k/v: (B,Sk,Hk,hd), hd a multiple of 8 up to 256,
    any strides with unit stride on hd (bf16: 16-byte aligned bases and
    strides, for the tensor-core kernel's 16-byte copies).  Returns a
    contiguous (B,Sq,H,hd) tensor of q's dtype, and with ``return_lse``
    also the rows' logsumexp, fp32 (B,Sq,H)."""
    global launches
    build.forbid_grad("flash_attention", "call kernels.ops.flash_attention",
                      q, k, v)
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
    if hd % 8 or not 8 <= hd <= HEAD_DIMS[-1]:
        raise ValueError(f"head dim {hd}: the flash kernel takes multiples "
                         f"of 8 up to {HEAD_DIMS[-1]}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes differ: {q.dtype} {k.dtype} {v.dtype}")
    code = build.dtype_code(q)
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash kernel needs unit stride on the head dim")
    if q.dtype == torch.bfloat16:
        build.require_aligned16("flash_attention", q=q, k=k, v=v)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap < 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    if max(B, H) > 65535 or max(Sq, Sk) >= 2 ** 31:
        raise ValueError(f"shape {tuple(q.shape)} exceeds the launch grid")
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=dev)
    lse = (torch.empty((B, Sq, H), dtype=torch.float32, device=dev)
           if return_lse else None)
    if B == 0 or Sq == 0:
        return (out, lse) if return_lse else out
    err = build.library().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if return_lse else None, B, Sq, Sk, H, Hk, hd,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        int(causal), window or 0, float(softcap or 0.0),
        1.0 / math.sqrt(hd), code, build.stream_handle(dev))
    build.check(err, "flash_attention")
    launches += 1
    return (out, lse) if return_lse else out
