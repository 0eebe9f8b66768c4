"""Transformer layers (port of ``repro/models/layers.py``).

Plain functions on dicts of tensors, with the JAX package's layouts:
weights ``(in, out)`` (``wq (D, H*hd)``, ``w_gate (D, F)``), attention
tensors ``(B, S, H, hd)``, KV caches ``(L, B, S, Hk, hd)``.

RMSNorm (qk_norm's too), the SwiGLU gate and prefill attention go through
``kernels.ops`` (the Hopper kernels on the card, their plain versions on
the CPU), whose autograd functions carry the backward kernels, so
``lm_forward`` trains.  Cached decode attention is plain torch, as in the
JAX package, and so are the other MLP activations (``sq_relu``, ``gelu``,
``geglu``), for which the JAX package has no kernel either.

Where bf16 rounds: a ``torch.matmul`` of bf16 operands accumulates in fp32
and rounds its output to bf16 once, which is what the JAX code's
``preferred_element_type=float32`` followed by ``.astype(x.dtype)`` does,
except for the MLP's g/u (see ``mlp``).  In fp32 the two agree to rounding.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.iccl.communicator import Communicator
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.tensor import copy_to_model, reduce_from_model


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
    """x: (..., S, D) -> q (..., S, H, hd), k/v (..., S, Hk, hd); ``pos``
    broadcastable to x's leading dims and S (the cp route passes each
    rank's global positions, (cp, 1, Cmax)).  H and Hk are the heads the
    weights hold: a model rank's share under tensor parallelism."""
    lead = x.shape[:-1]
    hd = cfg.hd
    H, Hk = p["wq"].shape[-1] // hd, p["wk"].shape[-1] // hd
    q = (x @ p["wq"]).view(*lead, H, hd)
    k = (x @ p["wk"]).view(*lead, Hk, hd)
    v = (x @ p["wv"]).view(*lead, Hk, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    return q, k, v


def _local_kv(k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig,
              n_q: int, model_rank: int):
    """The kv heads that this model rank's ``n_q`` q heads read, of k/v
    replicated over the ranks: global q head h reads kv head
    h // (H / Hk), so a contiguous run of kv heads, which the flash kernel
    maps onto the local q heads as GQA again."""
    group = cfg.n_heads // cfg.n_kv_heads
    lo = model_rank * n_q // group
    hi = ((model_rank + 1) * n_q - 1) // group + 1
    n = hi - lo
    if n_q % n or any((model_rank * n_q + i) // group - lo != i // (n_q // n)
                      for i in range(n_q)):
        raise ValueError(f"{cfg.name}: {n_q} q heads a rank do not map onto "
                         f"whole kv heads (H {cfg.n_heads}, Hk "
                         f"{cfg.n_kv_heads})")
    return k[..., lo:hi, :], v[..., lo:hi, :]


def attention(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
              causal: bool = True, pos_offset: int = 0,
              return_kv: bool = False,
              model: Optional[Communicator] = None):
    """Full-sequence attention (prefill).  ``cfg.attn_chunk`` is moot: the
    flash kernel never materializes the (Sq, Sk) scores.  With a ``model``
    communicator and q heads split over it (``parallel/sharding.py``),
    this rank runs its heads: x goes in through ``copy_to_model`` and the
    ``wo`` product's partial sums leave through ``reduce_from_model``."""
    B, S, _ = x.shape
    hd = cfg.hd
    n_q = p["wq"].shape[-1] // hd
    split = model if n_q != cfg.n_heads else None
    x = copy_to_model(x, split)
    pos = torch.arange(S, device=x.device) + pos_offset
    q, k, v = _qkv(p, x, cfg, pos)
    kq, vq = k, v
    if split is not None and k.shape[-2] == cfg.n_kv_heads:
        kq, vq = _local_kv(k, v, cfg, n_q, split.index())
    o = ops.flash_attention(q, kq, vq, causal=causal, window=cfg.window,
                            softcap=cfg.attn_logit_softcap)
    out = reduce_from_model(o.reshape(B, S, n_q * hd) @ p["wo"], split)
    if return_kv:
        return out, k, v
    return out


# ----------------------------------------------------- cached decoding -----
def kv_len(cfg: ModelConfig, max_len: int) -> int:
    """Positions a KV cache holds: an SWA arch keeps a rolling buffer of
    ``min(max_len, window)``, where position a sits at index a mod its
    length."""
    return min(max_len, cfg.window) if cfg.window else max_len


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  n_layers: int, device) -> dict:
    """Cache for the attention layers, stacked on a leading layer dim."""
    shape = (n_layers, batch, kv_len(cfg, max_len), cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.adtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.adtype, device=device)}


def decode_mask(S: int, posv: torch.Tensor,
                window: Optional[int]) -> torch.Tensor:
    """(B, S) bool: the cache indices a query at position ``posv`` (B,)
    reads.  Under SWA index i of the rolling buffer holds the latest
    position a <= pos with a mod S == i, read while a > pos - window
    (JAX's algebra, ``repro/models/layers.py:210-216``)."""
    idx = torch.arange(S, device=posv.device)[None, :]
    pcol = posv[:, None]
    if not window:
        return idx <= pcol
    n_wrap = (pcol // S) * S
    kabs = idx + torch.where(idx <= pcol % S, n_wrap, n_wrap - S)
    return (kabs >= 0) & (kabs <= pcol) & (kabs > pcol - window)


def decode_attention(p: dict, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """One-token attention against a cache, updated IN PLACE.

    x: (B,1,D); cache_k/v: (B,S,Hk,hd) (views into the layer-stacked
    cache); pos: scalar (whole batch at one position) or (B,) (per-row
    positions: the serving engine's slots advance independently).
    Returns out (B,1,D).  Under SWA the cache is a rolling buffer: position
    a is written at index a mod S (``decode_mask`` reads it).
    """
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
    slot = posv % S if cfg.window else posv.clamp(max=S - 1)
    cache_k[rows, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[rows, slot] = v[:, 0].to(cache_v.dtype)
    valid = decode_mask(S, posv, cfg.window)
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
GATED = ("swiglu", "geglu")          # three matrices: w_gate, w_up, w_down
ACTS = GATED + ("sq_relu", "gelu")    # the others: w_up, w_down


def init_mlp(gen: torch.Generator, cfg: ModelConfig, n: int) -> dict:
    if cfg.act not in ACTS:
        raise ValueError(f"unknown activation {cfg.act!r}; known: {ACTS}")
    D, F = cfg.d_model, cfg.d_ff
    if cfg.act in GATED:
        return {"w_gate": _he_stacked(gen, n, (D, F), cfg.pdtype),
                "w_up": _he_stacked(gen, n, (D, F), cfg.pdtype),
                "w_down": _he_stacked(gen, n, (F, D), cfg.pdtype)}
    return {"w_up": _he_stacked(gen, n, (D, F), cfg.pdtype),
            "w_down": _he_stacked(gen, n, (F, D), cfg.pdtype)}


def mlp(p: dict, x: torch.Tensor, cfg: ModelConfig,
        model: Optional[Communicator] = None) -> torch.Tensor:
    """With a ``model`` communicator and d_ff split over it, this rank's
    columns of ``w_gate``/``w_up`` and rows of ``w_down``, between
    ``copy_to_model`` and ``reduce_from_model``: every activation is
    elementwise over d_ff, so a split needs no exchange before ``w_down``,
    whose partial sums the reduction adds.

    g/u leave the matmul in x.dtype: in bf16 they are rounded once, where
    JAX keeps them fp32 (preferred_element_type).  The swiglu kernel
    upcasts, computes silu(g)*u in fp32 and writes x.dtype directly; the
    other activations run in fp32 on the upcast g/u as JAX's do (``gelu``
    is ``jax.nn.gelu``'s tanh form) and round once to x.dtype."""
    split = model if p["w_up"].shape[-1] != cfg.d_ff else None
    x = copy_to_model(x, split)
    u = x @ p["w_up"]
    if cfg.act == "swiglu":
        h = ops.swiglu(x @ p["w_gate"], u, out_dtype=x.dtype)
    elif cfg.act == "geglu":
        g = (x @ p["w_gate"]).float()
        h = (F.gelu(g, approximate="tanh") * u.float()).to(x.dtype)
    elif cfg.act == "sq_relu":
        h = torch.relu(u.float()).square().to(x.dtype)
    elif cfg.act == "gelu":
        h = F.gelu(u.float(), approximate="tanh").to(x.dtype)
    else:
        raise ValueError(f"unknown activation {cfg.act!r}; known: {ACTS}")
    return reduce_from_model(h @ p["w_down"], split)
