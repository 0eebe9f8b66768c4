"""Plain PyTorch versions of the kernels (port of ``repro/kernels/ref.py``,
with the ring hop of ``repro/kernels/ring_attention.py``).

They define what each Hopper kernel must compute, forward and backward.
``kernels/ops.py`` runs them for tensors on the CPU; on the card
``chip_smoke.py`` holds each kernel against them.  They compute in fp32
(fp64 for fp64 inputs, so ``torch.autograd.gradcheck`` can run them).

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

NEG_INF = -1e30     # the empty online-softmax state's running max (as JAX)


def acc_dtype(t: torch.Tensor) -> torch.dtype:
    """The accumulation type for inputs of t's dtype."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


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
                    softcap: Optional[float] = None,
                    return_lse: bool = False):
    """q: (B,Sq,H,hd); k/v: (B,Sk,Hk,hd) with H % Hk == 0 (GQA).
    Returns (B,Sq,H,hd) in q.dtype; softmax and PV in fp32.  With
    ``return_lse`` also the logsumexp of each row's scores, (B,Sq,H) fp32,
    +inf for a row with no visible key (the backward's P is then 0)."""
    B, Sq, H, hd = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    dt = acc_dtype(q)
    qg = q.reshape(B, Sq, Hk, G, hd).to(dt)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(dt)) / math.sqrt(hd)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    mask = attention_mask(Sq, Sk, causal=causal, window=window,
                          device=q.device)
    s = s.masked_fill(~mask, float("-inf"))
    w = torch.softmax(s, dim=-1)
    # a row with no visible key is all -inf -> NaN softmax; define it as 0
    seen = mask.any(dim=-1, keepdim=True)
    w = torch.where(seen, w, 0.0)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w, v.to(dt))
    o = o.reshape(B, Sq, H, hd).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.where(seen[..., 0], torch.logsumexp(s, dim=-1), math.inf)
    return o, lse.permute(0, 3, 1, 2).reshape(B, Sq, H)


def rmsnorm(x, scale, eps: float = 1e-5) -> torch.Tensor:
    dt = acc_dtype(x)
    xf = x.to(dt)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(dt)).to(x.dtype)


def rmsnorm_bwd(x, scale, dy, eps: float = 1e-5):
    """VJP of ``rmsnorm``: (dx in x.dtype, dscale (D,) in fp32).  With
    r = rsqrt(mean(x^2) + eps) and g = dy * scale,
    dx = r*g - x * r^3 * mean(g*x) and dscale = sum over rows of dy*x*r."""
    dt = acc_dtype(x)
    xf, g = x.to(dt), dy.to(dt)
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    gs = g * scale.to(dt)
    dx = r * gs - xf * r.pow(3) * (gs * xf).mean(dim=-1, keepdim=True)
    dscale = (g * xf * r).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dscale


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
    dt = acc_dtype(g)
    return (F.silu(g.to(dt)) * u.to(dt)).to(out_dtype or g.dtype)


def swiglu_bwd(g, u, dh):
    """VJP of ``swiglu`` in fp32: with s = sigmoid(g),
    dg = dh*u*s*(1 + g*(1 - s)) and du = dh*g*s, both in g's dtype."""
    dt = acc_dtype(g)
    gf, uf, d = g.to(dt), u.to(dt), dh.to(dt)
    sig = torch.sigmoid(gf)
    dg = d * uf * sig * (1 + gf * (1 - sig))
    du = d * gf * sig
    return dg.to(g.dtype), du.to(u.dtype)


# ------------------------------------------------------ the ring hop ----
# A hop is one ring step for every rank at once.  Rank r holds q
# (B, Cq, H, hd) and folds the KV block (B, Ck, Hk, hd) of rank ``src``
# into its carried (m, l, acc); ``hops[r] = (q_start, src, k_start,
# k_valid, q_valid)`` gives the global positions of the two chunks and
# their numbers of real (non-pad) rows.  The rank axis leads every tensor.

def hop_mask(hops, cq: int, ck: int, *, causal: bool, device,
             window: Optional[int] = None) -> torch.Tensor:
    """(R, Cq, Ck) bool, True = the key is visible to the query: a real
    key of a real query row, (causal) not after the query, and (window)
    ``kpos > qpos - window`` (JAX's ``_scores_mask``)."""
    t = torch.tensor(hops, dtype=torch.int64, device=device).reshape(-1, 5)
    qi = torch.arange(cq, device=device)
    kj = torch.arange(ck, device=device)
    mask = ((kj[None, None, :] < t[:, 3, None, None])
            & (qi[None, :, None] < t[:, 4, None, None]))
    qpos = t[:, 0, None] + qi[None]                              # (R, Cq)
    kpos = t[:, 2, None] + kj[None]                              # (R, Ck)
    if causal:
        mask = mask & (kpos[:, None, :] <= qpos[:, :, None])
    if window is not None:
        mask = mask & (kpos[:, None, :] > qpos[:, :, None] - window)
    return mask


def ring_step(q, k, v, m, l, acc, hops, *, causal: bool = True):
    """Fold one hop into the carry, for every rank: the rank-batched
    ``_ring_step_ref`` of ``repro/kernels/ring_attention.py``.

    q: (R,B,Cq,H,hd); k/v: (Rk,B,Ck,Hk,hd); m/l: (R,B,Cq,H,1) and acc
    (R,B,Cq,H,hd) in the accumulation dtype.  Returns the new (m, l, acc).
    A masked score adds p = 0 (not exp(-1e30 - m), which is 1 while m is
    still -1e30), and a row that sees no key keeps its carry exactly."""
    R, B, Cq, H, hd = q.shape
    Ck, Hk = k.shape[2], k.shape[3]
    G = H // Hk
    dt = m.dtype
    src = torch.tensor([h[1] for h in hops], device=q.device)
    kk, vv = k[src].to(dt), v[src].to(dt)
    s = torch.einsum("rbqhgd,rbkhd->rbqhgk",
                     q.reshape(R, B, Cq, Hk, G, hd).to(dt), kk) / math.sqrt(hd)
    mask = hop_mask(hops, Cq, Ck, causal=causal, device=q.device)
    mask = mask[:, None, :, None, None, :].expand(s.shape)
    s = s.masked_fill(~mask, float("-inf")).reshape(R, B, Cq, H, Ck)
    mask = mask.reshape(R, B, Cq, H, Ck)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.where(mask, torch.exp(s - m_new), 0.0)
    alpha = torch.where(m_new == m, 1.0, torch.exp(m - m_new))
    l_new = l * alpha + p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("rbqhgk,rbkhd->rbqhgd",
                      p.reshape(R, B, Cq, Hk, G, Ck), vv)
    return m_new, l_new, acc * alpha + pv.reshape(R, B, Cq, H, hd)


def ring_step_bwd(q, k, v, dout, lse, delta, dq, dk, dv, hops, *,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None):
    """One hop's VJP in the FA2 form, added IN PLACE into the accumulators
    dq (R,B,Cq,H,hd) and dk/dv (Rk,B,Ck,Hk,hd) (dk/dv at the source rank
    of each hop); returns them.  lse (R,B,Cq,H) is m + log(l) of the final
    carry and delta (R,B,Cq,H) = rowsum(dout * out).  With P = exp(s - lse)
    under the hop's mask (``window`` as in ``hop_mask``): dV += P^T dO,
    dS = P * (dO V^T - delta), dQ += dS K * scale, dK += dS^T Q * scale.
    With a ``softcap`` the forward's scores were s_c = cap * tanh(s / cap):
    P = exp(s_c - lse) and dS = P * (dO V^T - delta) * (1 - (s_c / cap)^2)."""
    R, B, Cq, H, hd = q.shape
    Ck, Hk = k.shape[2], k.shape[3]
    G = H // Hk
    dt = dq.dtype
    scale = 1.0 / math.sqrt(hd)
    src = torch.tensor([h[1] for h in hops], device=q.device)
    qg = q.reshape(R, B, Cq, Hk, G, hd).to(dt)
    do = dout.reshape(R, B, Cq, Hk, G, hd).to(dt)
    kk, vv = k[src].to(dt), v[src].to(dt)
    s = torch.einsum("rbqhgd,rbkhd->rbqhgk", qg, kk) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    mask = hop_mask(hops, Cq, Ck, causal=causal, device=q.device,
                    window=window)
    mask = mask[:, None, :, None, None, :]
    p = torch.where(mask, torch.exp(s - lse.reshape(R, B, Cq, Hk, G, 1)),
                    0.0)
    dp = torch.einsum("rbqhgd,rbkhd->rbqhgk", do, vv)
    ds = p * (dp - delta.reshape(R, B, Cq, Hk, G, 1).to(dt))
    if softcap:
        ds = ds * (1 - (s / softcap).square())
    dq += (torch.einsum("rbqhgk,rbkhd->rbqhgd", ds, kk)
           * scale).reshape(R, B, Cq, H, hd)
    dk.index_add_(0, src, torch.einsum("rbqhgk,rbqhgd->rbkhd", ds, qg)
                  * scale)
    dv.index_add_(0, src, torch.einsum("rbqhgk,rbqhgd->rbkhd", p, do))
    return dq, dk, dv
