"""Whisper-style encoder-decoder (port of ``repro/models/encdec.py``):
whisper-tiny.

As in the JAX package the audio frontend is a stub: the batch supplies
precomputed frame embeddings ``frames`` (B, S_enc, D).  Positions are
sinusoidal and added to the embeddings, on top of the RoPE that every
self-attention applies to its q and k (``layers._qkv``).

Encoder layers: bidirectional self-attention and a GELU MLP.  Decoder
layers: causal self-attention, cross-attention over the encoder's output,
and a GELU MLP.  Cross-attention takes no RoPE and no mask: it is the
flash kernel without causality at Sq != Sk (the decoder's positions
against the encoder's), and at decode at Sq 1 against the cross K/V that
the prefill stored.  The decoder's cached self-attention at decode is
plain torch, as for every other family (``layers.decode_attention``).

Public entry points (the parameter tree is JAX's, blocks stacked on a
leading layer dim, so ``convert.from_jax`` is the identity):
  init_encdec(cfg, seed=, device=)                      -> params
  encode(params, frames, cfg)                           -> (B, S_enc, D)
  encdec_forward(params, frames, tokens, cfg)           -> (logits, aux 0)
  encdec_init_cache(cfg, batch, max_len, s_enc, device) -> cache
  encdec_prefill(params, frames, tokens, cfg, max_len)  -> (logits, cache)
  encdec_decode_step(params, token, cache, cfg)         -> (logits, cache)

Unlike JAX the decode step updates the cache in place and returns the
same dict, and its ``pos`` may be a scalar or (B,), as
``transformer.lm_decode_step`` takes it.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (_he, attention, decode_attention,
                                       init_attention, init_mlp,
                                       init_rmsnorm, mlp, rmsnorm)
from repro_torch.models.transformer import (_embed, layer, remat_blocks,
                                            run_blocks)
from repro_torch.utils.device import DeviceLike, resolve_device


def check_encdec(cfg: ModelConfig) -> None:
    if cfg.family != "encdec" or cfg.n_encoder_layers < 1:
        raise ValueError(f"{cfg.name}: family {cfg.family!r} with "
                         f"{cfg.n_encoder_layers} encoder layers is not an "
                         "enc-dec config")


def _sinusoid(S: int, D: int, offset=0, device=None) -> torch.Tensor:
    """fp32 (S, D): sin then cos of positions ``offset + [0, S)``; an
    offset of shape (B,) gives (B, S, D), one row of positions each."""
    pos = torch.arange(S, dtype=torch.float32, device=device)
    if isinstance(offset, torch.Tensor) and offset.dim() == 1:
        pos = pos[None, :] + offset.float()[:, None]
    else:
        pos = pos + offset
    inv = 1.0 / (10000 ** (torch.arange(0, D, 2, dtype=torch.float32,
                                        device=device) / D))
    ang = pos[..., None] * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ------------------------------------------------------------------ init ---
def init_encdec(cfg: ModelConfig, *, seed: int = 0,
                device: DeviceLike = None) -> dict:
    """He-initialized parameters from a seeded generator on the device, in
    JAX's tree: ``embed``, ``enc_blocks{ln1, attn, ln2, mlp}``,
    ``enc_norm``, ``dec_blocks{ln1, attn, ln_x, xattn, ln2, mlp}``,
    ``final_norm``, ``unembed``."""
    check_encdec(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    D, L, Le, V = (cfg.d_model, cfg.num_layers, cfg.n_encoder_layers,
                   cfg.vocab_size)
    norm = functools.partial(init_rmsnorm, D, cfg.pdtype, dev)
    return {
        "embed": _he(gen, (V, D), cfg.pdtype, V),
        "enc_blocks": {"ln1": norm(Le), "attn": init_attention(gen, cfg, Le),
                       "ln2": norm(Le), "mlp": init_mlp(gen, cfg, Le)},
        "enc_norm": norm(),
        "dec_blocks": {"ln1": norm(L), "attn": init_attention(gen, cfg, L),
                       "ln_x": norm(L), "xattn": init_attention(gen, cfg, L),
                       "ln2": norm(L), "mlp": init_mlp(gen, cfg, L)},
        "final_norm": norm(),
        "unembed": _he(gen, (D, V), cfg.pdtype, D),
    }


# ---------------------------------------------------------------- blocks ---
def _cross_kv(p: dict, enc_out: torch.Tensor, cfg: ModelConfig):
    """The cross-attention's K and V (B, S_enc, Hk, hd) of the encoder's
    output: no RoPE."""
    B, Sk, _ = enc_out.shape
    hd = cfg.hd
    Hk = p["wk"].shape[-1] // hd
    return ((enc_out @ p["wk"]).view(B, Sk, Hk, hd),
            (enc_out @ p["wv"]).view(B, Sk, Hk, hd))


def _cross_attn(p: dict, x: torch.Tensor, ek: torch.Tensor,
                ev: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x (B, Sq, D) attends to every row of ek/ev (B, Sk, Hk, hd): the
    flash kernel without causality, its queries without RoPE."""
    B, Sq, _ = x.shape
    hd = cfg.hd
    H = p["wq"].shape[-1] // hd
    q = (x @ p["wq"]).view(B, Sq, H, hd)
    o = ops.flash_attention(q, ek, ev, causal=False)
    return o.reshape(B, Sq, H * hd) @ p["wo"]


def _enc_block(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """An encoder layer: (x, aux = None)."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    x = x + attention(p["attn"], h, cfg, causal=False)
    x = x + mlp(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)
    return x, None


def _dec_block(p: dict, x: torch.Tensor, enc_out: torch.Tensor,
               cfg: ModelConfig, return_kv: bool = False):
    """A decoder layer: (x, aux = None), with ``return_kv`` (x, k, v,
    cross k, cross v)."""
    o, k, v = attention(p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps), cfg,
                        return_kv=True)
    x = x + o
    ek, ev = _cross_kv(p["xattn"], enc_out, cfg)
    x = x + _cross_attn(p["xattn"], rmsnorm(p["ln_x"], x, cfg.norm_eps),
                        ek, ev, cfg)
    x = x + mlp(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)
    return (x, k, v, ek, ev) if return_kv else (x, None)


def _positions(x: torch.Tensor, cfg: ModelConfig, offset=0) -> torch.Tensor:
    return x + _sinusoid(x.shape[1], cfg.d_model, offset,
                         x.device).to(cfg.adtype)


def _embed_dec(params: dict, tokens, cfg: ModelConfig, offset=0):
    return _positions(_embed(params, tokens, cfg), cfg, offset)


# --------------------------------------------------------------- forward ---
def encode(params: dict, frames, cfg: ModelConfig) -> torch.Tensor:
    """frames (B, S_enc, D), the frontend stub's embeddings -> the
    encoder's output (B, S_enc, D) after its final norm.  With
    ``cfg.remat`` and a gradient to take, each layer runs under
    ``torch.utils.checkpoint``."""
    x = torch.as_tensor(frames, device=params["embed"].device)
    x = _positions(x.to(cfg.adtype), cfg)
    blocks = params["enc_blocks"]
    x, _ = run_blocks((layer(blocks, i) for i in range(cfg.n_encoder_layers)),
                      x, functools.partial(_enc_block, cfg=cfg),
                      remat_blocks(cfg, blocks, x))
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def encdec_forward(params: dict, frames, tokens, cfg: ModelConfig):
    """The training forward: frames (B, S_enc, D), tokens (B, S_dec) ->
    (logits (B, S_dec, V) fp32, aux = 0).  Each encoder and decoder layer
    is a remat unit under ``cfg.remat`` when a gradient is taken."""
    check_encdec(cfg)
    enc_out = encode(params, frames, cfg)
    x = _embed_dec(params, tokens, cfg)
    blocks = params["dec_blocks"]
    x, _ = run_blocks((layer(blocks, i) for i in range(cfg.num_layers)), x,
                      functools.partial(_dec_block, enc_out=enc_out, cfg=cfg),
                      remat_blocks(cfg, blocks, x))
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return ((x @ params["unembed"]).float(),
            torch.zeros((), dtype=torch.float32, device=x.device))


# ---------------------------------------------------------------- decode ---
def encdec_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                      s_enc: int, device: DeviceLike = None) -> dict:
    """The self-attention K/V (L, B, max_len, Hk, hd) and the static cross
    K/V (L, B, s_enc, Hk, hd), both stacked on the decoder's layers."""
    check_encdec(cfg)
    dev = resolve_device(device)
    L, Hk, hd = cfg.num_layers, cfg.n_kv_heads, cfg.hd

    def kv(n):
        return {k: torch.zeros((L, batch, n, Hk, hd), dtype=cfg.adtype,
                               device=dev) for k in ("k", "v")}

    return {"pos": torch.zeros((), dtype=torch.int64, device=dev),
            "kv": kv(max_len), "xkv": kv(s_enc)}


def encdec_prefill(params: dict, frames, tokens, cfg: ModelConfig,
                   max_len: int):
    """The encoder, then the decoder over the prompt: (the last position's
    logits (B, V) fp32, a cache of the prompt's self K/V at the front of
    ``max_len`` and every layer's cross K/V, ``pos`` = S)."""
    check_encdec(cfg)
    enc_out = encode(params, frames, cfg)
    x = _embed_dec(params, tokens, cfg)
    B, S = x.shape[0], x.shape[1]
    if S > max_len:
        raise ValueError(f"prompt of {S} tokens exceeds max_len {max_len}")
    cache = encdec_init_cache(cfg, B, max_len, enc_out.shape[1], x.device)
    kv, xkv = cache["kv"], cache["xkv"]
    for i in range(cfg.num_layers):
        x, k, v, ek, ev = _dec_block(layer(params["dec_blocks"], i), x,
                                     enc_out, cfg, return_kv=True)
        kv["k"][i, :, :S], kv["v"][i, :, :S] = k, v
        xkv["k"][i], xkv["v"][i] = ek, ev
    x = rmsnorm(params["final_norm"], x[:, -1:].contiguous(), cfg.norm_eps)
    cache["pos"].fill_(S)
    return (x @ params["unembed"]).float()[:, 0], cache


def encdec_decode_step(params: dict, token, cache: Dict[str, Any],
                       cfg: ModelConfig):
    """token (B, 1): one decoder step against the cache, updated in place
    (``pos`` scalar or (B,)).  Returns (logits (B, V) fp32, cache).  The
    cross-attention is the flash kernel at Sq 1 against the stored cross
    K/V."""
    pos = cache["pos"]
    x = _embed_dec(params, token, cfg, pos)
    kv, xkv = cache["kv"], cache["xkv"]
    for i in range(cfg.num_layers):
        p = layer(params["dec_blocks"], i)
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        x = x + decode_attention(p["attn"], h, kv["k"][i], kv["v"][i], pos,
                                 cfg)
        x = x + _cross_attn(p["xattn"], rmsnorm(p["ln_x"], x, cfg.norm_eps),
                            xkv["k"][i], xkv["v"][i], cfg)
        x = x + mlp(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    cache["pos"] = pos + 1
    return (x @ params["unembed"]).float()[:, 0], cache
