"""Mamba-1 block (port of ``repro/models/mamba.py``), falcon-mamba-7b.

Prefill and training run the selective scan through
``kernels.ops.ssm_scan``: the Hopper kernel on the card, its plain
sequential loop on the CPU; a gradient goes through its autograd
function (the scan's VJP kernel on the card, ``ref.ssm_scan_bwd`` on the
CPU), and the D skip, the ``silu(z)`` gate, ``_ssm_params`` and the conv
are plain torch, as in JAX, differentiated by autograd.  The JAX
package runs its own chunked associative scan there, the same scan up to
fp32 rounding, which reshapes S into ``S // 128`` equal chunks and so
fails when that count does not divide S (S = 500 or 1000); here any S
works.  The scan also returns its last state, which the prefill keeps as
the decode state (JAX's ``transformer._mamba_prefill_state``).

Decode is the O(1) recurrence in plain torch, as in the JAX package; it
updates the state and the conv tail in place.

Parameters are stacked on a leading layer dim (``init_mamba(..., n)``), as
JAX's ``vmap``-ed init stacks them.  ``A_log`` and ``D`` are fp32 whatever
the parameter dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _he_stacked


def init_mamba(gen: torch.Generator, cfg: ModelConfig, n: int) -> dict:
    D, di, ds, dr = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank_
    dev, dt = gen.device, cfg.pdtype
    a = torch.arange(1, ds + 1, dtype=torch.float32, device=dev)
    return {
        "in_proj": _he_stacked(gen, n, (D, 2 * di), dt),
        "conv_w": _he_stacked(gen, n, (cfg.ssm_conv, di), dt),  # fan-in K
        "conv_b": torch.zeros((n, di), dtype=dt, device=dev),
        "x_proj": _he_stacked(gen, n, (di, dr + 2 * ds), dt),
        "dt_proj": _he_stacked(gen, n, (dr, di), dt),
        "dt_bias": torch.full((n, di), -4.6, dtype=dt, device=dev),
        "A_log": torch.log(a).expand(n, di, ds).contiguous(),
        "D": torch.ones((n, di), dtype=torch.float32, device=dev),
        "out_proj": _he_stacked(gen, n, (di, D), dt),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state=None):
    """Depthwise causal conv1d.  x: (B,S,di), w: (K,di); state: (B,K-1,di)
    trailing context (None: zeros).  Returns (y, new_state), both x.dtype."""
    K, S = w.shape[0], x.shape[1]
    if state is None:
        pad = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                       # (B, S+K-1, di)
    y = xp[:, 0:S] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + S] * w[i]
    return (y + b).to(x.dtype), xp[:, -(K - 1):]


def _ssm_params(p: dict, u: torch.Tensor, cfg: ModelConfig):
    """u: (B,S,di) post-conv activations -> dt (B,S,di), Bc, Cc (B,S,ds),
    fp32 (JAX's preferred_element_type=float32 products)."""
    ds, dr = cfg.ssm_state, cfg.dt_rank_
    proj = u.float() @ p["x_proj"].float()
    dt, Bc, Cc = proj.split([dr, ds, ds], dim=-1)
    dt = dt @ p["dt_proj"].float()
    dt = F.softplus(dt + p["dt_bias"].float())
    return dt, Bc, Cc


def selective_scan(u, dt, Bc, Cc, A, D, z):
    """u, dt, z: (B,S,di); Bc, Cc: (B,S,ds); A: (di,ds).  The scan, then
    the ``u * D`` skip and the ``silu(z)`` gate in fp32.  Returns
    (y (B,S,di) in u.dtype, last state (B,di,ds) fp32)."""
    y, h_last = ops.ssm_scan(u, dt, Bc, Cc, A)
    y = y + u.float() * D
    return (y * F.silu(z.float())).to(u.dtype), h_last


def mamba_block(p: dict, x: torch.Tensor, cfg: ModelConfig,
                return_state: bool = False):
    """x: (B,S,D) -> (B,S,D); with ``return_state`` also the decode state
    after the last position: (out, h (B,di,ds) fp32, conv tail
    (B,K-1,di))."""
    xz = x @ p["in_proj"]
    u, z = xz.chunk(2, dim=-1)
    u, conv_tail = _causal_conv(u, p["conv_w"], p["conv_b"])
    u = F.silu(u.float()).to(x.dtype)
    dt, Bc, Cc = _ssm_params(p, u, cfg)
    A = -torch.exp(p["A_log"])
    y, h_last = selective_scan(u, dt, Bc, Cc, A, p["D"], z)
    out = y @ p["out_proj"]
    return (out, h_last, conv_tail) if return_state else out


def init_mamba_state(cfg: ModelConfig, batch: int, n_layers: int,
                     device) -> dict:
    di, ds, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    return {"h": torch.zeros((n_layers, batch, di, ds), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((n_layers, batch, K - 1, di),
                                dtype=cfg.adtype, device=device)}


def mamba_decode(p: dict, x: torch.Tensor, h: torch.Tensor,
                 conv_state: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One-step recurrence.  x: (B,1,D); h: (B,di,ds) and conv_state:
    (B,K-1,di) are updated IN PLACE (views into the layer-stacked state).
    Returns out (B,1,D)."""
    xz = x @ p["in_proj"]
    u, z = xz.chunk(2, dim=-1)
    u, new_conv = _causal_conv(u, p["conv_w"], p["conv_b"], conv_state)
    conv_state.copy_(new_conv)
    u = F.silu(u.float()).to(x.dtype)
    dt, Bc, Cc = _ssm_params(p, u, cfg)                  # (B,1,.)
    A = -torch.exp(p["A_log"])
    dt0, B0, C0, u0 = dt[:, 0], Bc[:, 0], Cc[:, 0], u[:, 0].float()
    decay = torch.exp(dt0[..., None] * A)                # (B,di,ds)
    h.mul_(decay).add_((dt0 * u0)[..., None] * B0[:, None, :])
    y = (h * C0[:, None, :]).sum(-1) + u0 * p["D"]
    y = (y * F.silu(z[:, 0].float()))[:, None].to(x.dtype)
    return y @ p["out_proj"]
