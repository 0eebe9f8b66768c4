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
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

MAX_STATE = 16   # the largest d_state the kernel takes
launches = 0     # kernel launches since the last reset


def ssm_scan(u: torch.Tensor, dt: torch.Tensor, Bc: torch.Tensor,
             Cc: torch.Tensor, A: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u: (B,S,di) bf16 or fp32; dt: (B,S,di), Bc/Cc: (B,S,ds), A: (di,ds)
    fp32, any strides (copied to contiguous where they are not).  Returns
    y (B,S,di) and the last state h (B,di,ds), both fp32."""
    global launches
    build.forbid_grad("ssm_scan", "the selective scan has no backward yet: "
                      "ROADMAP.md queue A, item 9", u, dt, Bc, Cc, A)
    dev = build.require_cuda(u, dt, Bc, Cc, A)
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
    code = build.dtype_code(u)
    y = torch.empty((B, S, di), dtype=torch.float32, device=dev)
    h = torch.zeros((B, di, ds), dtype=torch.float32, device=dev)
    if B == 0 or S == 0 or di == 0:
        return y, h
    u, dt, Bc, Cc, A = (t.contiguous() for t in (u, dt, Bc, Cc, A))
    err = build.library().ssm_scan_fwd(
        u.data_ptr(), dt.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
        A.data_ptr(), y.data_ptr(), h.data_ptr(), B, S, di, ds, code,
        build.stream_handle(dev))
    build.check(err, "ssm_scan")
    launches += 1
    return y, h
