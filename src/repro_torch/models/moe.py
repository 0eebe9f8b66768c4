"""Mixture-of-Experts layer: top-k router and per-row capacity dispatch
(port of ``repro/models/moe.py``, its ``_moe_mlp_gspmd``).

Static shapes, as on the TPU: each batch row dispatches its own tokens
into a ``(E, C, D)`` buffer of C slots an expert (``row_capacity``), the
experts run as batched products over ``(B, E, C)`` and the kept slots are
gathered back, weighted by their renormalised gates.  A token's slot in
its expert is its rank among the row's earlier picks of that expert for
the same k, after the picks of the earlier k; a slot at or past C drops
the token for that k (its weight is 0).  The Switch aux loss
``E * sum(me * ce)`` (mean gate times mean pick count of each expert over
the batch's tokens) comes back beside the output.

The expert products are ``torch.einsum`` (batched GEMMs): JAX computes
them outside any Pallas kernel.  A ``swiglu`` config's expert activation
goes through ``kernels.ops.swiglu`` (the ported kernel) on the flattened
``(B*E*C, F)`` rows, as the dense MLP's does; ``sq_relu`` stays plain
torch as in JAX (``relu(g + u)^2``).  The tensor- and expert-parallel
variants (``moe_mlp_manual``) are not ported: they run only under a mesh
(ROADMAP.md queue A, item A9b).

``jax.lax.top_k`` takes the lower index among equal gates; a stable
descending sort does the same here, so ties route as in JAX.

Parameters are stacked on a leading layer dim: router ``(L, D, E)`` fp32,
``w_gate``/``w_up`` ``(L, E, D, F)`` and ``w_down`` ``(L, E, F, D)`` in the
parameter dtype.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _he


def init_moe(gen: torch.Generator, cfg: ModelConfig, n: int) -> dict:
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    dev, dt = gen.device, cfg.pdtype

    def stacked(shape, dtype, fan_in):
        out = torch.empty((n, *shape), dtype=dtype, device=dev)
        for i in range(n):
            out[i] = _he(gen, shape, dtype, fan_in)
        return out

    return {"router": stacked((D, E), torch.float32, D),
            "w_gate": stacked((E, D, Fd), dt, D),
            "w_up": stacked((E, D, Fd), dt, D),
            "w_down": stacked((E, Fd, D), dt, Fd)}


def row_capacity(seq: int, cfg: ModelConfig) -> int:
    """Slots an expert takes of one row of ``seq`` tokens: ``seq * top_k *
    capacity_factor / n_experts``, rounded up to a multiple of 8 from 8
    tokens on, at least 1."""
    c = int(seq * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(1, -(-c // 8) * 8) if seq >= 8 else max(1, c)


class Routing(NamedTuple):
    """Where each (token, k) goes: ``idx`` (B,S,K) its expert, ``pos``
    (B,S,K) its slot (0 where dropped), ``keep`` (B,S,K) bool, ``weight``
    (B,S,K) fp32 its renormalised gate (0 where dropped), ``aux`` the
    Switch load-balance loss."""
    idx: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    weight: torch.Tensor
    aux: torch.Tensor


def top_k(gates: torch.Tensor, k: int):
    """(values, indices) of the k largest gates, ties to the lower index
    (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(router: torch.Tensor, x: torch.Tensor, cfg: ModelConfig,
          capacity: int) -> Routing:
    """The router and the per-row dispatch of x (B,S,D) at ``capacity``
    slots an expert."""
    E, K = cfg.n_experts, cfg.top_k
    gates = torch.softmax(x.float() @ router.float(), dim=-1)     # (B,S,E)
    gval, gidx = top_k(gates, K)
    gval = gval / gval.sum(dim=-1, keepdim=True)
    me = gates.mean(dim=(0, 1))
    ce = F.one_hot(gidx, E).float().sum(dim=2).mean(dim=(0, 1))
    aux = E * torch.sum(me * ce)
    fill = torch.zeros(x.shape[0], E, dtype=torch.int64, device=x.device)
    pos_k, keep_k = [], []
    for k in range(K):
        e = gidx[..., k]                                          # (B,S)
        oh = F.one_hot(e, E)                                      # (B,S,E)
        rank = torch.cumsum(oh, dim=1) - oh                       # in row
        pos = rank.gather(2, e[..., None])[..., 0] + fill.gather(1, e)
        keep_k.append(pos < capacity)
        pos_k.append(torch.where(keep_k[-1], pos, 0))
        fill = fill + oh.sum(dim=1)
    keep = torch.stack(keep_k, dim=-1)
    return Routing(gidx, torch.stack(pos_k, dim=-1), keep,
                   torch.where(keep, gval, 0.0), aux)


def _experts(p: dict, buf: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """buf (B,E,C,D) -> (B,E,C,D): every expert's MLP on its slots."""
    B, E, C, D = buf.shape
    g = torch.einsum("becd,edf->becf", buf, p["w_gate"])
    u = torch.einsum("becd,edf->becf", buf, p["w_up"])
    if cfg.act == "swiglu":
        h = ops.swiglu(g.reshape(B * E * C, -1), u.reshape(B * E * C, -1),
                       out_dtype=buf.dtype).reshape(g.shape)
    elif cfg.act == "sq_relu":
        h = torch.relu(g.float() + u.float()).square().to(buf.dtype)
    else:
        raise ValueError(f"MoE experts take swiglu or sq_relu, not "
                         f"{cfg.act!r} (as JAX's moe_mlp)")
    return torch.einsum("becf,efd->becd", h, p["w_down"])


def moe_mlp(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """x: (B,S,D) -> (out (B,S,D) in x.dtype, aux fp32 scalar)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = row_capacity(S, cfg)
    r = route(p["router"], x, cfg, C)
    # slot (b, e, c) of the flattened buffer: (b * E + e) * C + c
    rows = torch.arange(B, device=x.device)[:, None, None]
    slot = ((rows * E + r.idx) * C + r.pos)                       # (B,S,K)
    kept = r.keep.reshape(-1)
    src = x[:, :, None, :].expand(B, S, K, D).reshape(-1, D)[kept]
    # kept slots are distinct, so the put writes each slot once
    buf = x.new_zeros((B * E * C, D)).index_put(
        (slot.reshape(-1)[kept],), src)
    y = _experts(p, buf.view(B, E, C, D), cfg).reshape(B * E * C, D)
    picked = y[slot.reshape(-1)].view(B, S, K, D).float()
    out = (r.weight[..., None] * picked).sum(dim=2)
    return out.to(x.dtype), r.aux
