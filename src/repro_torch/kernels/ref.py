"""Plain PyTorch versions of the kernels (port of ``repro/kernels/ref.py``).

They define what each Hopper kernel must compute.  ``kernels/ops.py`` runs
them for tensors on the CPU; on the card ``chip_smoke.py`` holds each kernel
against them.

One difference from the JAX oracle: a query row with no visible key (fully
masked by causality or the window) returns 0 here and in the CUDA kernel.
The JAX oracle returns the mean of V over all keys (a uniform softmax over
-1e30) and the Pallas kernel leaves the case undefined.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def attention_mask(sq: int, sk: int, *, causal: bool, window: Optional[int],
                   device) -> torch.Tensor:
    """(Sq, Sk) bool, True = attend.  Positions align at the END when
    Sq != Sk: query i sits at position Sk - Sq + i."""
    qpos = torch.arange(sq, device=device) + (sk - sq)
    kpos = torch.arange(sk, device=device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos[None] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None] > qpos[:, None] - window
    return mask


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B,Sq,H,hd); k/v: (B,Sk,Hk,hd) with H % Hk == 0 (GQA).
    Returns (B,Sq,H,hd) in q.dtype; softmax and PV in fp32."""
    B, Sq, H, hd = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    qg = q.reshape(B, Sq, Hk, G, hd).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(hd)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    mask = attention_mask(Sq, Sk, causal=causal, window=window,
                          device=q.device)
    s = s.masked_fill(~mask, float("-inf"))
    w = torch.softmax(s, dim=-1)
    # a row with no visible key is all -inf -> NaN softmax; define it as 0
    w = torch.where(mask.any(dim=-1, keepdim=True), w, 0.0)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def rmsnorm(x, scale, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def ssm_scan(u, dt, Bc, Cc, A):
    """Mamba-1 selective scan, diagonal A, as a sequential loop over time
    in fp32.  u, dt: (B,S,di); Bc, Cc: (B,S,ds); A: (di,ds).  Returns
    (y (B,S,di), h_last (B,di,ds)): y is the JAX oracle's output (no D
    skip, no gate), h_last the state after the last step (zeros at S=0)."""
    uf, dtf, Bf, Cf, Af = (t.float() for t in (u, dt, Bc, Cc, A))
    Bsz, S, di = u.shape
    h = torch.zeros((Bsz, di, Af.shape[-1]), dtype=torch.float32,
                    device=u.device)
    y = torch.empty((Bsz, S, di), dtype=torch.float32, device=u.device)
    for t in range(S):
        decay = torch.exp(dtf[:, t, :, None] * Af)
        h = decay * h + (dtf[:, t] * uf[:, t])[..., None] * Bf[:, t, None, :]
        y[:, t] = (h * Cf[:, t, None, :]).sum(-1)
    return y, h


def swiglu(g, u, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """silu(g) * u in fp32, cast to ``out_dtype`` (default g.dtype)."""
    return (F.silu(g.float()) * u.float()).to(out_dtype or g.dtype)
