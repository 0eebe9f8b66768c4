"""Kernel dispatch by device (port of ``repro/kernels/ops.py``), with the
autograd functions the training path differentiates through.

The tensor's device decides, and nothing else: a CPU tensor goes to the
plain version in ``ref``; a CUDA tensor goes to the hand-written kernel,
whose wrapper launches it or raises.  There is no mode switch and no
fallback from the kernel to the plain version.

Each kernel on the training path sits inside a ``torch.autograd.Function``
whose backward dispatches the same way: the plain ``ref.*_bwd`` on the
CPU, the backward kernel on the card, so the CPU tests run the backward
math the card runs.  A call in which nothing needs a gradient (serving)
goes to the forward directly, without the function's bookkeeping.  The
flash backward is the one-rank ring hop backward (``ring_step_bwd``): a
hop of one rank over the whole sequence is causal flash attention, and
the hop backward takes the flash forward's window, softcap and head dims.
The selective scan's backward is a kernel of its own
(``ssm_scan_bwd``).  The JAX package differentiates its jnp code instead;
no Pallas kernel there has a backward.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import ring_attention as _ra
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import ssm_scan as _ss
from repro_torch.kernels import swiglu as _sg


# every kernel's launch counter: name -> (wrapper module, attribute)
LAUNCH_COUNTERS = {
    "rmsnorm": (_rn, "launches"), "rmsnorm_bwd": (_rn, "bwd_launches"),
    "swiglu": (_sg, "launches"), "swiglu_bwd": (_sg, "bwd_launches"),
    "flash_attention": (_fa, "launches"), "ssm_scan": (_ss, "launches"),
    "ssm_scan_bwd": (_ss, "bwd_launches"),
    "ring_step": (_ra, "launches"), "ring_step_bwd": (_ra, "bwd_launches"),
}


def launch_counts() -> Dict[str, int]:
    return {n: getattr(m, a) for n, (m, a) in LAUNCH_COUNTERS.items()}


def reset_launch_counts() -> None:
    for m, a in LAUNCH_COUNTERS.values():
        setattr(m, a, 0)


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for tensors on {t.device}")


# ------------------------------------------------------------- rmsnorm ---
def _rmsnorm_fwd(x, scale, eps):
    return (ref.rmsnorm if _on_cpu(x) else _rn.rmsnorm)(x, scale, eps)


class RMSNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _rmsnorm_fwd(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dy = dy.contiguous()
        bwd = ref.rmsnorm_bwd if _on_cpu(x) else _rn.rmsnorm_bwd
        dx, dscale = bwd(x, scale, dy, ctx.eps)
        return dx, dscale.to(scale.dtype), None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    if _needs_grad(x, scale):
        return RMSNormFn.apply(x, scale, eps)
    return _rmsnorm_fwd(x, scale, eps)


# -------------------------------------------------------------- swiglu ---
def _swiglu_fwd(g, u, out_dtype):
    return (ref.swiglu if _on_cpu(g) else _sg.swiglu)(g, u, out_dtype)


class SwiGLUFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, u, out_dtype):
        ctx.save_for_backward(g, u)
        return _swiglu_fwd(g, u, out_dtype)

    @staticmethod
    def backward(ctx, dh):
        g, u = ctx.saved_tensors
        dh = dh.contiguous()
        bwd = ref.swiglu_bwd if _on_cpu(g) else _sg.swiglu_bwd
        dg, du = bwd(g, u, dh)
        return dg, du, None


def swiglu(g: torch.Tensor, u: torch.Tensor,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    if _needs_grad(g, u):
        return SwiGLUFn.apply(g, u, out_dtype)
    return _swiglu_fwd(g, u, out_dtype)


# ----------------------------------------------------------- ring hops ---
def ring_step(q, k, v, m, l, acc, hops: Sequence[_ra.Hop], *,
              causal: bool = True):
    """One ring hop for every rank (no autograd: ``ring_attention``
    differentiates the whole ring)."""
    if _on_cpu(q):
        return ref.ring_step(q, k, v, m, l, acc, hops, causal=causal)
    return _ra.ring_step(q, k, v, m, l, acc, hops, causal=causal)


def ring_step_bwd(q, k, v, dout, lse, delta, dq, dk, dv,
                  hops: Sequence[_ra.Hop], *, causal: bool = True,
                  window: Optional[int] = None,
                  softcap: Optional[float] = None):
    bwd = ref.ring_step_bwd if _on_cpu(q) else _ra.ring_step_bwd
    return bwd(q, k, v, dout, lse, delta, dq, dk, dv, hops, causal=causal,
               window=window, softcap=softcap)


def _hop_backward(q, k, v, o, lse, dout, hop_tables, causal, window=None,
                  softcap=None):
    """The gradient of an attention output o (R,B,Cq,H,hd) whose rows'
    logsumexp is lse (R,B,Cq,H): one ``ring_step_bwd`` per hop table,
    accumulated in the accumulation dtype and cast once at the end."""
    acc = ref.acc_dtype(q)
    dout = dout.contiguous()
    delta = (dout.to(acc) * o.to(acc)).sum(dim=-1)
    dq = torch.zeros(q.shape, dtype=acc, device=q.device)
    dk = torch.zeros(k.shape, dtype=acc, device=k.device)
    dv = torch.zeros(v.shape, dtype=acc, device=v.device)
    for hops in hop_tables:
        ring_step_bwd(q, k, v, dout, lse, delta, dq, dk, dv, hops,
                      causal=causal, window=window, softcap=softcap)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _fresh_carry(q):
    """The online softmax's empty carry (m, l, acc) for q (R,B,C,H,hd)."""
    R, B, C, H, hd = q.shape
    acc_t = ref.acc_dtype(q)
    return (torch.full((R, B, C, H, 1), ref.NEG_INF, dtype=acc_t,
                       device=q.device),
            torch.zeros((R, B, C, H, 1), dtype=acc_t, device=q.device),
            torch.zeros((R, B, C, H, hd), dtype=acc_t, device=q.device))


def _out_lse(q, m, l, acc):
    """(o in q's dtype, the rows' logsumexp) of a final carry."""
    o = (acc / l.clamp_min(1e-30)).to(q.dtype)
    return o, torch.where(l > 0, m + torch.log(l), torch.inf)[..., 0]


class RingAttentionFn(torch.autograd.Function):
    """The whole ring of one attention block: cp ``ring_step`` launches
    forward, cp ``ring_step_bwd`` launches backward.  JAX differentiates
    each fold, the running max included; the output acc / l does not
    depend on m, so the two gradients agree in exact arithmetic."""

    @staticmethod
    def forward(ctx, q, k, v, cp_chunks, causal):
        m, l, acc = _fresh_carry(q)
        for s in range(q.shape[0]):
            m, l, acc = ring_step(q, k, v, m, l, acc,
                                  _ra.ring_hops(cp_chunks, s), causal=causal)
        o, lse = _out_lse(q, m, l, acc)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cp_chunks, ctx.causal = tuple(cp_chunks), causal
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        tables = [_ra.ring_hops(ctx.cp_chunks, s)
                  for s in range(len(ctx.cp_chunks))]
        dq, dk, dv = _hop_backward(q, k, v, o, lse, dout, tables, ctx.causal)
        return dq, dk, dv, None, None


def ring_attention(q, k, v, cp_chunks: Sequence[int], *,
                   causal: bool = True) -> torch.Tensor:
    """Attention over the padded rank layout: q (cp,B,Cmax,H,hd), k/v
    (cp,B,Cmax,Hk,hd), contiguous, chunk r holding ``cp_chunks[r]`` real
    rows.  Returns (cp,B,Cmax,H,hd) in q's dtype."""
    if q.shape[0] != len(cp_chunks) or max(cp_chunks) != q.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} is not the padded layout of "
                         f"chunks {tuple(cp_chunks)}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return RingAttentionFn.apply(q, k, v, tuple(cp_chunks), causal)


class RingRanksFn(torch.autograd.Function):
    """The ring of one attention block on one cp ring rank, its KV blocks
    passed between the ranks by ``hop`` (the ``pod`` Communicator's
    ``shift(x, 1, wrap=True)``: rank r sends to r + 1 and receives from
    r - 1, so after s hops rank r holds rank (r - s) % cp's block).

    Forward: cp ``ring_step`` launches of one rank against one visiting
    block, the hop table ``(starts[r], 0, starts[src], chunks[src],
    chunks[r])`` with ``src = (r - s) % cp``; K and V, stacked into one
    message, hop after every step but the last.  Backward: cp
    ``ring_step_bwd`` launches, K and V circulating again with fp32 dK,
    dV accumulators (one message each a hop), each step adding into this
    rank's dq and the visiting block's dK/dV; after the last step one more
    hop of dK/dV alone brings each block's gradient home.  Every ring rank
    makes the same hops in the same order, so the messages match in
    posting order."""

    @staticmethod
    def forward(ctx, q, k, v, cp_chunks, ring, hop, causal):
        cp = len(cp_chunks)
        m, l, acc = _fresh_carry(q)
        kv = torch.stack([k, v])
        for s in range(cp):
            m, l, acc = ring_step(q, kv[0], kv[1], m, l, acc,
                                  _rank_hop(cp_chunks, ring, s),
                                  causal=causal)
            if s < cp - 1:
                kv = hop(kv)
        o, lse = _out_lse(q, m, l, acc)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cp_chunks, ctx.ring, ctx.hop = tuple(cp_chunks), ring, hop
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        cp, r, hop = len(ctx.cp_chunks), ctx.ring, ctx.hop
        acc_t = ref.acc_dtype(q)
        dout = dout.contiguous()
        delta = (dout.to(acc_t) * o.to(acc_t)).sum(dim=-1)
        dq = torch.zeros(q.shape, dtype=acc_t, device=q.device)
        kv = torch.stack([k, v])
        dkv = torch.zeros(kv.shape, dtype=acc_t, device=q.device)
        for s in range(cp):
            ring_step_bwd(q, kv[0], kv[1], dout, lse, delta, dq, dkv[0],
                          dkv[1], _rank_hop(ctx.cp_chunks, r, s),
                          causal=ctx.causal)
            if s < cp - 1:
                kv = hop(kv)
            dkv = hop(dkv)      # after the last step: home
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None, None)


def _rank_hop(cp_chunks: Sequence[int], ring: int, step: int) -> List[_ra.Hop]:
    """Ring rank ``ring``'s one-row hop table at ring step ``step``: its
    own q chunk against rank ``(ring - step) % cp``'s KV block, held as
    source 0."""
    starts, cp = _ra.chunk_starts(cp_chunks), len(cp_chunks)
    src = (ring - step) % cp
    return [(starts[ring], 0, starts[src], cp_chunks[src], cp_chunks[ring])]


def ring_attention_ranks(q, k, v, cp_chunks: Sequence[int], ring: int,
                         hop: Callable[[torch.Tensor], torch.Tensor], *,
                         causal: bool = True) -> torch.Tensor:
    """Ring attention of ring rank ``ring`` of a ring across processes: q
    (1,B,Cmax,H,hd) and k/v (1,B,Cmax,Hk,hd), this rank's chunk of
    ``cp_chunks[ring]`` real rows padded to the largest chunk, so every
    hop has one shape; ``hop(x)`` returns the ring's neighbour's ``x``
    (the rank before on the ring).  Returns (1,B,Cmax,H,hd) in q's dtype;
    the pad rows are 0."""
    cmax = max(cp_chunks)
    if q.shape[0] != 1 or q.shape[2] != cmax or k.shape[2] != cmax:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}: want one "
                         f"rank's chunk padded to {cmax} rows")
    if not 0 <= ring < len(cp_chunks):
        raise ValueError(f"ring rank {ring} of {len(cp_chunks)}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return RingRanksFn.apply(q, k, v, tuple(cp_chunks), ring, hop, causal)


# ------------------------------------------------------------ flash ----
def _flash_fwd(q, k, v, **kw):
    fwd = ref.flash_attention if _on_cpu(q) else _fa.flash_attention
    return fwd(q, k, v, **kw)


class FlashAttentionFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        o, lse = _flash_fwd(q, k, v, causal=causal, window=window,
                            softcap=softcap, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window, ctx.softcap = causal, window, softcap
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        Sq, Sk = q.shape[1], k.shape[1]
        # one rank whose queries sit at the end of the keys
        hops = [(Sk - Sq, 0, 0, Sk, Sq)]
        dq, dk, dv = _hop_backward(
            q.contiguous()[None], k.contiguous()[None], v.contiguous()[None],
            o[None], lse[None], dout[None], [hops], ctx.causal, ctx.window,
            ctx.softcap)
        return dq[0], dk[0], dv[0], None, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    if _needs_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal, window, softcap)
    return _flash_fwd(q, k, v, causal=causal, window=window, softcap=softcap)


# ------------------------------------------------------------ ssm scan ---
class SSMScanFn(torch.autograd.Function):
    """The selective scan with its VJP.  On the card the forward stores the
    state entering every chunk (``ssm_scan(..., keep_chunks=True)``) and
    the backward kernel starts from them; on the CPU the plain backward
    recomputes the states.  The last state carries no gradient: a nonzero
    one raises (the training path never reads it)."""

    @staticmethod
    def forward(ctx, u, dt, Bc, Cc, A):
        u, dt, Bc, Cc, A = (t.contiguous() for t in (u, dt, Bc, Cc, A))
        ctx.set_materialize_grads(False)
        if _on_cpu(u):
            y, h = ref.ssm_scan(u, dt, Bc, Cc, A)
            ctx.save_for_backward(u, dt, Bc, Cc, A)
        else:
            y, h, hc = _ss.ssm_scan(u, dt, Bc, Cc, A, keep_chunks=True)
            ctx.save_for_backward(u, dt, Bc, Cc, A, hc)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        if dh is not None and bool(dh.ne(0).any()):
            raise RuntimeError("ssm_scan: the last state has no gradient "
                               "(it is the decode state, not a loss input)")
        saved = ctx.saved_tensors
        u = saved[0]
        if dy is None:
            dy = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
        dy = dy.float().contiguous()
        if _on_cpu(u):
            grads = ref.ssm_scan_bwd(*saved, dy)
        else:
            grads = _ss.ssm_scan_bwd(*saved, dy)
        return grads


def ssm_scan(u, dt, Bc, Cc, A) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B,S,di), h_last (B,di,ds)), both fp32; differentiable in u, dt,
    Bc, Cc and A (not through h_last)."""
    if _needs_grad(u, dt, Bc, Cc, A):
        return SSMScanFn.apply(u, dt, Bc, Cc, A)
    if _on_cpu(u):
        return ref.ssm_scan(u, dt, Bc, Cc, A)
    return _ss.ssm_scan(u, dt, Bc, Cc, A)
