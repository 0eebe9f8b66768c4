"""Transformer layers (port of ``repro/models/layers.py``).

Plain functions on dicts of tensors, with the JAX package's layouts:
weights ``(in, out)`` (``wq (D, H*hd)``, ``w_gate (D, F)``), attention
tensors ``(B, S, H, hd)``, KV caches ``(L, B, S, Hk, hd)``.

RMSNorm, the SwiGLU gate and prefill attention go through ``kernels.ops``
(the Hopper kernels on the card, their plain versions on the CPU).  Cached
decode attention is plain torch, as in the JAX package.

Where bf16 rounds: a ``torch.matmul`` of bf16 operands accumulates in fp32
and rounds its output to bf16 once, which is what the JAX code's
``preferred_element_type=float32`` followed by ``.astype(x.dtype)`` does,
except for the MLP's g/u (see ``mlp``).  In fp32 the two agree to rounding.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig


def _he(gen: torch.Generator, shape, dtype, fan_in: int) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return w.mul_(math.sqrt(1.0 / fan_in)).to(dtype)


def _he_stacked(gen: torch.Generator, n: int, shape, dtype) -> torch.Tensor:
    """(n, *shape) filled one layer at a time (bounded fp32 scratch)."""
    out = torch.empty((n, *shape), dtype=dtype, device=gen.device)
    for i in range(n):
        out[i] = _he(gen, shape, dtype, shape[0])
    return out


# ---------------------------------------------------------------- norms ----
def init_rmsnorm(d: int, dtype, device, n: Optional[int] = None) -> dict:
    shape = (d,) if n is None else (n, d)
    return {"scale": torch.ones(shape, dtype=dtype, device=device)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    return ops.rmsnorm(x, p["scale"], eps)


# ----------------------------------------------------------------- rope ----
def rope_freqs(hd: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, pos: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); pos: (S,) or (B, 1), broadcastable to x's S."""
    hd = x.shape[-1]
    ang = pos[..., None].float() * rope_freqs(hd, theta, x.device)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------ attention ----
def init_attention(gen: torch.Generator, cfg: ModelConfig, n: int) -> dict:
    D, H, Hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": _he_stacked(gen, n, (D, H * hd), cfg.pdtype),
        "wk": _he_stacked(gen, n, (D, Hk * hd), cfg.pdtype),
        "wv": _he_stacked(gen, n, (D, Hk * hd), cfg.pdtype),
        "wo": _he_stacked(gen, n, (H * hd, D), cfg.pdtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, cfg.pdtype, gen.device, n)
        p["k_norm"] = init_rmsnorm(hd, cfg.pdtype, gen.device, n)
    return p


def _qkv(p: dict, x: torch.Tensor, cfg: ModelConfig, pos: torch.Tensor):
    B, S, _ = x.shape
    H, Hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"]).view(B, S, H, hd)
    k = (x @ p["wk"]).view(B, S, Hk, hd)
    v = (x @ p["wv"]).view(B, S, Hk, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    return q, k, v


def attention(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
              causal: bool = True, pos_offset: int = 0,
              return_kv: bool = False):
    """Full-sequence attention (prefill).  ``cfg.attn_chunk`` is moot: the
    flash kernel never materializes the (Sq, Sk) scores."""
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device) + pos_offset
    q, k, v = _qkv(p, x, cfg, pos)
    o = ops.flash_attention(q, k, v, causal=causal, window=cfg.window,
                            softcap=cfg.attn_logit_softcap)
    out = o.reshape(B, S, cfg.n_heads * cfg.hd) @ p["wo"]
    if return_kv:
        return out, k, v
    return out


# ----------------------------------------------------- cached decoding -----
def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  n_layers: int, device) -> dict:
    """Cache for the attention layers, stacked on a leading layer dim."""
    if cfg.window:
        raise NotImplementedError(
            "rolling-buffer SWA cache is not ported yet (ROADMAP.md queue A, "
            "item 1)")
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.adtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.adtype, device=device)}


def decode_attention(p: dict, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """One-token attention against a cache, updated IN PLACE.

    x: (B,1,D); cache_k/v: (B,S,Hk,hd) (views into the layer-stacked
    cache); pos: scalar (whole batch at one position) or (B,) (per-row
    positions: the serving engine's slots advance independently).
    Returns out (B,1,D).
    """
    if cfg.window:
        raise NotImplementedError(
            "rolling-buffer SWA decode is not ported yet (ROADMAP.md queue A, "
            "item 1)")
    B, S = x.shape[0], cache_k.shape[1]
    H, Hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    posv = pos.expand(B) if pos.dim() == 0 else pos
    q, k, v = _qkv(p, x, cfg, posv[:, None])
    # JAX rewrites the whole cache through a one-hot select per row
    # (repro/models/layers.py:189-194); here each row writes its one slot in
    # place: the same cache, no full-cache copy.  A free engine slot keeps
    # stepping past the cache end; it writes the last slot (as JAX's clamped
    # dynamic_update_slice does) and is never read before it is refilled.
    rows = torch.arange(B, device=x.device)
    slot = posv.clamp(max=S - 1)
    cache_k[rows, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[rows, slot] = v[:, 0].to(cache_v.dtype)
    valid = torch.arange(S, device=x.device)[None, :] <= posv[:, None]
    G = H // Hk
    qg = q.view(B, Hk, G, hd).float()
    # scores in fp32 like JAX's preferred_element_type (upcasts a bf16 cache)
    s = torch.matmul(qg, cache_k.float().permute(0, 2, 3, 1)) / math.sqrt(hd)
    if cfg.attn_logit_softcap:
        c = cfg.attn_logit_softcap
        s = c * torch.tanh(s / c)
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    w = torch.softmax(s, dim=-1).to(x.dtype)   # JAX casts weights, too
    o = torch.matmul(w, cache_v.permute(0, 2, 1, 3).to(x.dtype))
    return o.reshape(B, 1, H * hd) @ p["wo"]


# ------------------------------------------------------------------ mlp ----
def init_mlp(gen: torch.Generator, cfg: ModelConfig, n: int) -> dict:
    if cfg.act != "swiglu":
        raise NotImplementedError(
            f"activation {cfg.act!r} is not ported yet (ROADMAP.md queue A, "
            "item 1)")
    D, F = cfg.d_model, cfg.d_ff
    return {"w_gate": _he_stacked(gen, n, (D, F), cfg.pdtype),
            "w_up": _he_stacked(gen, n, (D, F), cfg.pdtype),
            "w_down": _he_stacked(gen, n, (F, D), cfg.pdtype)}


def mlp(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.act != "swiglu":
        raise NotImplementedError(
            f"activation {cfg.act!r} is not ported yet (ROADMAP.md queue A, "
            "item 1)")
    # g/u leave the matmul in x.dtype: in bf16 they are rounded once, where
    # JAX keeps them fp32 (preferred_element_type).  The swiglu kernel
    # upcasts, computes silu(g)*u in fp32 and writes x.dtype directly.
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    h = ops.swiglu(g, u, out_dtype=x.dtype)
    return h @ p["w_down"]
