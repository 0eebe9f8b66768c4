"""Ring attention over sequence chunks on one card: the cp (context-parallel)
hop kernels and the host ring (port of ``repro/kernels/ring_attention.py``).

The sequence is split into ``cp`` contiguous, possibly unequal chunks,
padded to the largest and stacked on a leading rank axis.  At ring step
``s`` rank ``r`` folds the KV block of rank ``(r - s) % cp`` into its
carried online-softmax state ``(m, l, acc)``.  On one card the ring's
``jnp.roll`` becomes that index: nothing is copied, the kernel reads the
source rank's block in place (``ring_hops``).

``ring_step`` wraps ``csrc/ring_attention.cu::ring_step_fwd``, which
replaces the Pallas kernel ``repro/kernels/ring_attention.py::ring_step``
(body ``_step_kernel``).  One launch folds one ring step for ALL ranks:
its grid runs over rank x B x H x 64-row q tile, the counterpart of the
``jax.vmap(_fold)`` over ranks in ``repro/parallel/context.py``; with one
rank it is exactly the Pallas hop.  Bound: at the training shapes it must
read and write the fp32 carry (~180 MB at cp 4, S 4096), more time at the
card's byte rate than the hop's visible products at the bf16 tensor rate.
bf16 inputs run on the tensor cores (``mma.sync`` from ``cp.async``-staged
bf16 tiles; P enters PV as a bf16 hi + lo pair, since the carry is not
normalised), fp32 inputs on the fp32 FMA kernel.

``ring_step_bwd`` wraps ``ring_step_bwd`` of the same source: one hop's
VJP in the FA2 form (P recomputed from the final logsumexp), for all
ranks at once, added into fp32 dq (per rank) and dk/dv (per SOURCE rank).
The JAX package has no backward kernel: it differentiates the jnp fold.
With one rank it is the flash backward, so it also takes what the flash
forward takes: a sliding window, a logit softcap, and any head dim that
is a multiple of 8 up to 128 (run in the next tile width, its extra
columns zero-filled on load and never stored).  The ring forward
``ring_step`` keeps the tile widths and neither window nor softcap: the
cp loss refuses both (as JAX's ``repro/parallel/context.py`` does), and
h2o-danube-3-4b, the one registry arch at a head dim between the tile
widths (120), is windowed, so no cp path needs them.
Bound: by operations (five products per visible (q, k) pair) at long
chunks, by the fp32 accumulators' bytes at short ones.  bf16 inputs run
on the tensor cores (``mma.sync``, P and dS rounded to bf16 as SDPA does);
fp32 inputs on the fp32 FMA kernel.

Each hop carries both chunks' real row counts, so the pad rows of the
rank layout are skipped by the kernels and masked by the plain versions:
their forward output is dropped by ``unpad_chunks`` and their gradient
is 0 there, so the real rows are unchanged.

Plain versions: ``kernels/ref.py::ring_step`` and ``ring_step_bwd``.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128)   # the ring forward's head dims, the tiles
MAX_RANKS = 64      # hop table entries the kernels' parameter block holds
launches = 0        # ring_step launches since the last reset
bwd_launches = 0    # ring_step_bwd launches since the last reset

# (q_start, src, k_start, k_valid, q_valid): the global positions of the
# rank's q chunk and the visiting KV chunk, and their real (non-pad) rows
Hop = Tuple[int, int, int, int, int]


def chunk_starts(cp_chunks: Sequence[int]) -> Tuple[int, ...]:
    """Global start position of each ring rank's sequence chunk."""
    starts, b = [], 0
    for c in cp_chunks:
        starts.append(b)
        b += c
    return tuple(starts)


def pad_chunks(x: torch.Tensor, cp_chunks: Sequence[int],
               dim: int = 1) -> torch.Tensor:
    """Split ``x`` along ``dim`` into the (ragged) cp chunks and pad each to
    the largest with zeros: (..., S, ...) -> (cp, ..., Cmax, ...)."""
    cmax = max(cp_chunks)
    out = []
    for c, chunk in zip(cp_chunks, torch.split(x, list(cp_chunks), dim)):
        if c < cmax:
            shape = list(chunk.shape)
            shape[dim] = cmax - c
            chunk = torch.cat([chunk, chunk.new_zeros(shape)], dim)
        out.append(chunk)
    return torch.stack(out, 0)


def unpad_chunks(x: torch.Tensor, cp_chunks: Sequence[int],
                 dim: int = 1) -> torch.Tensor:
    """Inverse of ``pad_chunks``: (cp, ..., Cmax, ...) -> (..., S, ...)."""
    return torch.cat([x[r].narrow(dim, 0, c)
                      for r, c in enumerate(cp_chunks)], dim)


def ring_hops(cp_chunks: Sequence[int], step: int) -> List[Hop]:
    """The hop table of ring step ``step``: rank r folds rank
    ``(r - step) % cp``'s KV block; each rank's real q rows are its
    chunk."""
    starts, cp = chunk_starts(cp_chunks), len(cp_chunks)
    out = []
    for r in range(cp):
        src = (r - step) % cp
        out.append((starts[r], src, starts[src], cp_chunks[src],
                    cp_chunks[r]))
    return out


def _check_hops(hops: Sequence[Hop], R: int, Rk: int, Cq: int,
                Ck: int) -> None:
    if len(hops) != R:
        raise ValueError(f"{len(hops)} hops for {R} ranks")
    if R > MAX_RANKS:
        raise ValueError(f"{R} ranks exceed the kernels' {MAX_RANKS}")
    for hop in hops:
        if len(hop) != 5:
            raise ValueError(f"hop {tuple(hop)}: want (q_start, src, "
                             "k_start, k_valid, q_valid)")
        _, src, _, k_valid, q_valid = hop
        if not 0 <= src < Rk:
            raise ValueError(f"source rank {src} not in [0, {Rk})")
        if not 0 <= k_valid <= Ck:
            raise ValueError(f"k_valid {k_valid} not in [0, {Ck}]")
        if not 0 <= q_valid <= Cq:
            raise ValueError(f"q_valid {q_valid} not in [0, {Cq}]")


def _hop_array(hops: Sequence[Hop]):
    flat = [int(x) for h in hops for x in h]
    return (ctypes.c_int * len(flat))(*flat)


def _check_qkv(q, k, v, *, any_hd: bool = False):
    """The shapes of q, k, v; ``any_hd``: any head dim that is a multiple
    of 8 up to 128 (the backward), else one of ``HEAD_DIMS``."""
    if q.dim() != 5 or k.dim() != 5 or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: want (R,B,C,H,hd), k == v")
    R, B, Cq, H, hd = q.shape
    Rk, Ck, Hk = k.shape[0], k.shape[2], k.shape[3]
    if k.shape[1] != B or k.shape[4] != hd:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch or head dim")
    if Hk == 0 or H % Hk:
        raise ValueError(f"n_heads {H} not a multiple of n_kv_heads {Hk}")
    if any_hd:
        if hd % 8 or not 8 <= hd <= HEAD_DIMS[-1]:
            raise ValueError(f"head dim {hd}: the backward takes multiples "
                             f"of 8 up to {HEAD_DIMS[-1]}")
    elif hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes differ: {q.dtype} {k.dtype} {v.dtype}")
    if R * B > 65535 or H > 65535:
        raise ValueError(f"shape {tuple(q.shape)} exceeds the launch grid")
    return R, Rk, B, Cq, Ck, H, Hk, hd


def _need(name: str, t: torch.Tensor, shape, dtype) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype \
            or not t.is_contiguous():
        raise ValueError(f"{name}: want contiguous {tuple(shape)} {dtype}, "
                         f"got {tuple(t.shape)} {t.dtype}")


def ring_step(q, k, v, m, l, acc, hops: Sequence[Hop], *,
              causal: bool = True):
    """Fold one ring step into the carry of every rank.

    q: (R,B,Cq,H,hd); k/v: (Rk,B,Ck,Hk,hd), bf16 or fp32, contiguous;
    m/l: (R,B,Cq,H,1) and acc (R,B,Cq,H,hd) fp32, contiguous.  Returns new
    (m, l, acc): the carry is copied in and the old tensors are untouched.
    Keys at or past a hop's ``k_valid``, (causal) keys after a query's
    global position, and every key for rows at or past ``q_valid`` add
    nothing; a hop that shows a row no key leaves its carry bit for
    bit.  bf16 inputs go to the tensor-core kernel, whose 16-byte copies
    need 16-byte aligned tensors."""
    global launches
    build.forbid_grad("ring_step", "call kernels.ops.ring_attention",
                      q, k, v, m, l, acc)
    dev = build.require_cuda(q, k, v, m, l, acc)
    R, Rk, B, Cq, Ck, H, Hk, hd = _check_qkv(q, k, v)
    f32 = torch.float32
    _need("m", m, (R, B, Cq, H, 1), f32)
    _need("l", l, (R, B, Cq, H, 1), f32)
    _need("acc", acc, (R, B, Cq, H, hd), f32)
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("ring_step kernel takes contiguous q, k, v")
    if q.dtype == torch.bfloat16:
        build.require_aligned16("ring_step", q=q, k=k, v=v)
    _check_hops(hops, R, Rk, Cq, Ck)
    code = build.dtype_code(q)
    m_out, l_out, acc_out = (torch.empty_like(t) for t in (m, l, acc))
    if B == 0 or Cq == 0:
        return m_out, l_out, acc_out
    err = build.library().ring_step_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(),
        l.data_ptr(), acc.data_ptr(), m_out.data_ptr(), l_out.data_ptr(),
        acc_out.data_ptr(), R, Rk, B, Cq, Ck, H, Hk, hd, _hop_array(hops),
        int(causal), 1.0 / math.sqrt(hd), code, build.stream_handle(dev))
    build.check(err, "ring_step")
    launches += 1
    return m_out, l_out, acc_out


def ring_step_bwd(q, k, v, dout, lse, delta, dq, dk, dv,
                  hops: Sequence[Hop], *, causal: bool = True,
                  window: Optional[int] = None,
                  softcap: Optional[float] = None):
    """Add one hop's gradient into dq (R,B,Cq,H,hd) and dk/dv
    (Rk,B,Ck,Hk,hd), fp32 and contiguous, in place; return them.

    q, dout: (R,B,Cq,H,hd) and k/v: (Rk,B,Ck,Hk,hd) of one dtype, hd a
    multiple of 8 up to 128; lse and delta (R,B,Cq,H) fp32.  ``window``:
    a key is seen only while its global position is past the query's
    minus the window; ``softcap``: the forward's scores were
    cap * tanh(s / cap), and lse is theirs.  The sources of the hops must differ (one ring
    step is a permutation), so each dk/dv row has one writer per launch;
    dq rows are summed over key tiles with fp32 atomics (their order, and
    so the last bits, vary from run to run); rows at or past a hop's
    ``q_valid`` get nothing.  bf16 inputs go to the tensor-core kernel,
    whose 16-byte copies need 16-byte aligned tensors."""
    global bwd_launches
    build.forbid_grad("ring_step_bwd", "call kernels.ops.ring_attention",
                      q, k, v, dout, lse, delta)
    dev = build.require_cuda(q, k, v, dout, lse, delta, dq, dk, dv)
    R, Rk, B, Cq, Ck, H, Hk, hd = _check_qkv(q, k, v, any_hd=True)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap < 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    f32 = torch.float32
    _need("dout", dout, q.shape, q.dtype)
    _need("lse", lse, (R, B, Cq, H), f32)
    _need("delta", delta, (R, B, Cq, H), f32)
    _need("dq", dq, q.shape, f32)
    _need("dk", dk, k.shape, f32)
    _need("dv", dv, k.shape, f32)
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("ring_step_bwd kernel takes contiguous q, k, v")
    if q.dtype == torch.bfloat16:
        build.require_aligned16("ring_step_bwd", q=q, k=k, v=v, dout=dout)
    _check_hops(hops, R, Rk, Cq, Ck)
    srcs = [h[1] for h in hops]
    if len(set(srcs)) != len(srcs):
        raise ValueError(f"hop sources {srcs} repeat: dk/dv would race")
    code = build.dtype_code(q)
    if B == 0 or Cq == 0 or Ck == 0:
        return dq, dk, dv
    err = build.library().ring_step_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), R, Rk, B, Cq, Ck, H, Hk, hd, _hop_array(hops),
        int(causal), window or 0, float(softcap or 0.0), 1.0 / math.sqrt(hd),
        code, build.stream_handle(dev))
    build.check(err, "ring_step_bwd")
    bwd_launches += 1
    return dq, dk, dv


def ring_flash_attention(q, k, v, cp_chunks: Sequence[int], *,
                         causal: bool = True) -> torch.Tensor:
    """Full ring attention on one card (or the CPU), in the distributed
    ring's accumulation order, differentiable.  q: (B,S,H,hd); k/v:
    (B,S,Hk,hd); ``cp_chunks`` sum to S.  Returns (B,S,H,hd) in q.dtype.
    The tensors' device picks the kernels or their plain versions."""
    from repro_torch.kernels import ops
    S = q.shape[1]
    if sum(cp_chunks) != S or min(cp_chunks) < 1:
        raise ValueError(f"chunks {tuple(cp_chunks)} do not split S={S}")
    o = ops.ring_attention(pad_chunks(q, cp_chunks), pad_chunks(k, cp_chunks),
                           pad_chunks(v, cp_chunks), cp_chunks,
                           causal=causal)
    return unpad_chunks(o, cp_chunks)
