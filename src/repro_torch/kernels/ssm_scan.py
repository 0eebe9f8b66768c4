"""Mamba-1 selective scan on the card: wrapper of ``csrc/ssm_scan.cu``.

Replaces the Pallas kernel ``repro/kernels/ssm_scan.py::ssm_scan``.  One
thread keeps four states of one channel in registers for the whole
sequence (four lanes a channel, 32 channels a block): it reads dt and u of
its channel once a step, B and C of its states as ``float4`` broadcasts,
and sums its part of y[t, d] in a register.  The channel's four lanes add
their parts once a group of four steps: three shuffles leave each lane
with the whole y of one step of the group.  The block walks S in chunks of 64 steps, the next
chunk copied into shared memory (``cp.async``) while the current one
runs, so any S and any d_inner are taken (the Pallas kernel asserts
``S % chunk == 0``).  Its floor at the prefill shape is the
special-function units' rate for the B*S*di*ds exponentials, a little
above the bytes it must move.  One call is one launch.  Plain version:
``kernels/ref.py::ssm_scan``.

For training the forward also stores the state entering every chunk of
``CHUNK`` steps (``keep_chunks``), and ``ssm_scan_bwd`` is the scan's VJP,
split over time.  The one serial link of the VJP, the reverse carry of
dL/dh, is linear: a chunk passes on L + Q c, where c is the carry it
receives, Q the product of its decays and L its carry from a zero start.
One block takes one (chunk, 32 channels, batch row): it copies the chunk's
inputs into shared memory (``cp.async``), walks the chunk forward from its
stored state taking L and Q and keeping the state every 8 steps, receives
c from the block of the chunk after it and passes L + Q c on (an integer
flag; blocks take their work by ticket, the last chunk first, so a block
only waits for one that is running), then takes the 8-step sub-chunks in
reverse: recomputes their states and decays into registers and walks them
backwards.  Two exponentials a state and step (the forward walk's and the
recompute's; the reverse walk reuses the recompute's), which at
falcon-mamba-7b's training shape are a floor of 0.257 ms on the H100's
special-function units, above the 0.171 ms of the bytes it must move.
Tensor cores do not apply: each step's sums are matrix-vector products
with a new matrix every step.  Sums go in a fixed order with no float
atomics, so a repeated call gives the same bits: dB and dC over a cluster
of 8 blocks (256 channels) through distributed shared memory into one
partial a cluster, which a second pass adds in cluster order; dA along
the chunks' chain into one partial a batch row.  A call counts once in
``bwd_launches``: the flags' memset, the walk's kernel and the three
passes that add its partials.  Plain version:
``kernels/ref.py::ssm_scan_bwd``; ``kernels/ref.py::ssm_scan_bwd_chunked``
mirrors the split in plain PyTorch.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

MAX_STATE = 16   # the largest d_state the kernel takes
CHUNK = 64       # the steps between two stored states (kChunk)
CHANNELS = 32    # channels a block (kChannels)
CLUSTER = 8      # blocks a cluster (kCluster): one partial of dB, dC each
launches = 0     # forward launches since the last reset
bwd_launches = 0  # backward launches since the last reset


def n_chunks(S: int) -> int:
    return -(-S // CHUNK)


def _check(u, dt, Bc, Cc, A) -> Tuple[int, int, int, int]:
    """(B, S, di, ds) of valid scan inputs; raise otherwise."""
    if u.dim() != 3 or dt.shape != u.shape:
        raise ValueError(f"u {tuple(u.shape)} and dt {tuple(dt.shape)}: "
                         "want equal (B,S,di)")
    B, S, di = u.shape
    ds = A.shape[-1] if A.dim() == 2 else -1
    if tuple(A.shape) != (di, ds) or Bc.shape != (B, S, ds) \
            or Cc.shape != Bc.shape:
        raise ValueError(f"A {tuple(A.shape)}, Bc {tuple(Bc.shape)}, Cc "
                         f"{tuple(Cc.shape)}: want (di,ds) and (B,S,ds) "
                         f"for u {tuple(u.shape)}")
    if not 1 <= ds <= MAX_STATE:
        raise ValueError(f"d_state {ds} not in [1, {MAX_STATE}]")
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the launch grid")
    for name, t in (("dt", dt), ("Bc", Bc), ("Cc", Cc), ("A", A)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    return B, S, di, ds


def ssm_scan(u: torch.Tensor, dt: torch.Tensor, Bc: torch.Tensor,
             Cc: torch.Tensor, A: torch.Tensor, keep_chunks: bool = False):
    """u: (B,S,di) bf16 or fp32; dt: (B,S,di), Bc/Cc: (B,S,ds), A: (di,ds)
    fp32, any strides (copied to contiguous where they are not).  Returns
    y (B,S,di) and the last state h (B,di,ds), both fp32; with
    ``keep_chunks`` also the state entering each chunk of ``CHUNK`` steps,
    (B, n_chunks(S), di, ds) fp32, which ``ssm_scan_bwd`` takes (y and h
    are the same bits either way)."""
    global launches
    build.forbid_grad("ssm_scan", "differentiate through kernels.ops."
                      "ssm_scan", u, dt, Bc, Cc, A)
    dev = build.require_cuda(u, dt, Bc, Cc, A)
    B, S, di, ds = _check(u, dt, Bc, Cc, A)
    code = build.dtype_code(u)
    y = torch.empty((B, S, di), dtype=torch.float32, device=dev)
    h = torch.zeros((B, di, ds), dtype=torch.float32, device=dev)
    hc = (torch.zeros((B, n_chunks(S), di, ds), dtype=torch.float32,
                      device=dev) if keep_chunks else None)
    if B and S and di:
        u, dt, Bc, Cc, A = (t.contiguous() for t in (u, dt, Bc, Cc, A))
        err = build.library().ssm_scan_fwd(
            u.data_ptr(), dt.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
            A.data_ptr(), y.data_ptr(), h.data_ptr(),
            hc.data_ptr() if keep_chunks else None, B, S, di, ds, code,
            build.stream_handle(dev))
        build.check(err, "ssm_scan")
        launches += 1
    return (y, h, hc) if keep_chunks else (y, h)


def ssm_scan_bwd(u: torch.Tensor, dt: torch.Tensor, Bc: torch.Tensor,
                 Cc: torch.Tensor, A: torch.Tensor, chunk_h: torch.Tensor,
                 dy: torch.Tensor):
    """The VJP of ``ssm_scan`` for dy = dL/dy (B,S,di), no gradient on the
    last state: (du in u's dtype, ddt (B,S,di), dB, dC (B,S,ds), dA
    (di,ds)), all but du fp32.  ``chunk_h`` is what ``ssm_scan(...,
    keep_chunks=True)`` returned for the same inputs."""
    global bwd_launches
    build.forbid_grad("ssm_scan_bwd", "differentiate through kernels.ops."
                      "ssm_scan", u, dt, Bc, Cc, A, dy)
    dev = build.require_cuda(u, dt, Bc, Cc, A, chunk_h, dy)
    B, S, di, ds = _check(u, dt, Bc, Cc, A)
    if tuple(chunk_h.shape) != (B, n_chunks(S), di, ds) \
            or chunk_h.dtype != torch.float32:
        raise ValueError(f"chunk_h {tuple(chunk_h.shape)} {chunk_h.dtype}: "
                         f"want ({B}, {n_chunks(S)}, {di}, {ds}) float32")
    if dy.shape != u.shape or dy.dtype != torch.float32:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype}: want "
                         f"{tuple(u.shape)} float32")
    code = build.dtype_code(u)
    f32 = dict(dtype=torch.float32, device=dev)
    run = bool(B and S and di)
    new = torch.empty if run else torch.zeros   # the kernels write all
    du = new(u.shape, dtype=u.dtype, device=dev)
    ddt = new((B, S, di), **f32)
    dB, dC = new((B, S, ds), **f32), new((B, S, ds), **f32)
    dA = new((di, ds), **f32)
    if run:
        u, dt, Bc, Cc, A, chunk_h, dy = (t.contiguous() for t in (
            u, dt, Bc, Cc, A, chunk_h, dy))
        n_cl = -(-di // (CHANNELS * CLUSTER))
        part_b = torch.empty((n_cl, B, S, ds), **f32)
        part_c = torch.empty((n_cl, B, S, ds), **f32)
        part_a = torch.empty((B, di, ds), **f32)
        carry = torch.empty((B, di, ds), **f32)
        flags = torch.empty(1 + 2 * B * CLUSTER * n_cl, dtype=torch.int32,
                            device=dev)
        err = build.library().ssm_scan_bwd(
            *(t.data_ptr() for t in (u, dt, Bc, Cc, A, chunk_h, dy, du, ddt,
                                     dB, dC, dA, part_b, part_c, part_a,
                                     carry, flags)),
            B, S, di, ds, code, build.stream_handle(dev))
        build.check(err, "ssm_scan_bwd")
        bwd_launches += 1
    return du, ddt, dB, dC, dA
