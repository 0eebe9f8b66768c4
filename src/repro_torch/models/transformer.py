"""Decoder-only LM, uniform stacks (port of ``repro/models/transformer.py``,
dense and ssm families).

Public entry points:
  init_lm(cfg, seed=, device=)                   -> params
  lm_forward(params, tokens, cfg)                -> (logits, aux_loss)
  lm_features(params, tokens, cfg)               -> (features, w, aux_loss)
  init_cache(cfg, batch, max_len, device=)       -> cache
  lm_prefill(params, tokens, cfg, max_len)       -> (last_logits, cache)
  lm_decode_step(params, token, cache, cfg)      -> (logits, cache)

Blocks are stacked on a leading layer dim as in the JAX package; its
``lax.scan`` over layers is a Python loop over views of the stacks.  A
dense block is ``{ln1, attn, ln2, mlp}`` and caches K/V; an ssm block
(Mamba-1) is ``{ln1, ssm}`` and caches the scan state ``h`` and the conv
tail, whose size does not grow with the sequence.  The
unembed returns fp32 logits: a bf16 matmul rounds them to bf16 first,
where JAX accumulates straight into fp32.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.iccl.communicator import Communicator
from repro_torch.models import mamba
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (_he, attention, decode_attention,
                                       init_attention, init_kv_cache,
                                       init_mlp, init_rmsnorm, kv_len, mlp,
                                       rmsnorm)
from repro_torch.parallel import tensor
from repro_torch.utils.device import DeviceLike, resolve_device


def check_supported(cfg: ModelConfig) -> None:
    """The port serves the uniform dense attention stack (qk_norm, SWA,
    every MLP activation of the registry) and the uniform Mamba-1
    stack."""
    if cfg.family not in ("dense", "ssm") or cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet "
            "(ROADMAP.md queue A, item 9)")


# ------------------------------------------------------------------ init ---
def init_lm(cfg: ModelConfig, *, seed: int = 0,
            device: DeviceLike = None) -> dict:
    """He-initialized parameters from a seeded generator on the device."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    D, L = cfg.d_model, cfg.num_layers
    params: Dict[str, Any] = {
        "embed": _he(gen, (cfg.vocab_size, D), cfg.pdtype, cfg.vocab_size),
        "final_norm": init_rmsnorm(D, cfg.pdtype, dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = _he(gen, (D, cfg.vocab_size), cfg.pdtype, D)
    if cfg.family == "ssm":
        params["blocks"] = {"ln1": init_rmsnorm(D, cfg.pdtype, dev, L),
                            "ssm": mamba.init_mamba(gen, cfg, L)}
        return params
    params["blocks"] = {
        "ln1": init_rmsnorm(D, cfg.pdtype, dev, L),
        "attn": init_attention(gen, cfg, L),
        "ln2": init_rmsnorm(D, cfg.pdtype, dev, L),
        "mlp": init_mlp(gen, cfg, L),
    }
    return params


def layer(blocks: dict, i: int) -> dict:
    """Views of layer ``i`` of the stacked blocks."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


# --------------------------------------------------------------- forward ---
# ``model``: the model axis's communicator on a tensor-parallel rank, which
# holds its share of each leaf the sharding rules split
# (``parallel/sharding.py``); None leaves every path as it is.
def _embed(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
           model: Optional[Communicator] = None) -> torch.Tensor:
    """The rows of ``tokens``.  A lookup, not indexing: on the card its
    gradient sums a token's positions in fp32 and rounds once, where
    indexing's adds them one at a time into the bf16 gradient, which
    loses a frequent token's later terms."""
    table = params["embed"]
    tokens = torch.as_tensor(tokens, device=table.device)
    if model is not None and table.shape[0] != cfg.vocab_size:
        return tensor.vocab_parallel_embed(table, tokens, cfg.adtype, model)
    return torch.nn.functional.embedding(tokens.long(), table).to(cfg.adtype)


def _unembed_weight(params: dict, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]


def vocab_model(w: torch.Tensor, cfg: ModelConfig,
                model: Optional[Communicator]) -> Optional[Communicator]:
    """``model`` when the unembedding ``w`` holds a vocab slice, else
    None: the communicator of the logits' cross-entropy."""
    return model if w.shape[-1] != cfg.vocab_size else None


def _unembed(params: dict, x: torch.Tensor, cfg: ModelConfig,
             model: Optional[Communicator] = None) -> torch.Tensor:
    """fp32 logits; this rank's vocab slice of them when the unembedding
    is split over ``model``."""
    w = _unembed_weight(params, cfg)
    x = tensor.copy_to_model(x, vocab_model(w, cfg, model))
    return (x @ w).float()


def _block(p: dict, x: torch.Tensor, cfg: ModelConfig,
           return_kv: bool = False,
           model: Optional[Communicator] = None):
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    o, k, v = attention(p["attn"], h, cfg, return_kv=True, model=model)
    x = x + o
    x = x + mlp(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg, model)
    return (x, k, v) if return_kv else x


def _ssm_block(p: dict, x: torch.Tensor, cfg: ModelConfig):
    return x + mamba.mamba_block(p["ssm"], rmsnorm(p["ln1"], x, cfg.norm_eps),
                                 cfg)


def _requires_grad(tree) -> bool:
    if isinstance(tree, dict):
        return any(_requires_grad(v) for v in tree.values())
    return tree.requires_grad


def remat_blocks(cfg: ModelConfig, blocks: dict, x: torch.Tensor) -> bool:
    """Whether a loss runs each block under ``torch.utils.checkpoint``:
    ``cfg.remat``, and a gradient to take (autograd on, and the blocks'
    weights or their input need one); a forward for serving or a probe
    under ``no_grad`` runs the blocks plainly."""
    return (cfg.remat and torch.is_grad_enabled()
            and (x.requires_grad or _requires_grad(blocks)))


def lm_features(params: dict, tokens, cfg: ModelConfig,
                model: Optional[Communicator] = None):
    """The forward WITHOUT the unembed: (features (B,S,D) after the final
    norm, unembed weight (D,V), aux_loss), so a loss can run the head over
    sequence chunks (``train.steps.make_loss_fn`` with ``cfg.loss_chunk``).
    With ``cfg.remat`` and a gradient to take, each block runs under
    ``torch.utils.checkpoint`` (JAX's ``jax.checkpoint`` of every block):
    only the blocks' inputs are kept, and the backward runs each block's
    forward again, so its kernels launch twice a step; the loss and the
    gradients are those of the kept forward, bit for bit.  On a
    tensor-parallel rank (``model``) the features are whole and the
    weight is this rank's vocab slice, (D, V / tp), when the rules split
    the vocab; a recomputed block all-reduces again."""
    check_supported(cfg)
    if model is not None and cfg.family == "ssm":
        raise NotImplementedError(
            f"{cfg.name}: tensor parallelism over the ssm stack waits for "
            "its training kernels (ROADMAP.md queue A, item 9)")
    x = _embed(params, tokens, cfg, model)
    block = (functools.partial(_ssm_block, cfg=cfg) if cfg.family == "ssm"
             else functools.partial(_block, cfg=cfg, model=model))
    remat = remat_blocks(cfg, params["blocks"], x)
    for i in range(cfg.num_layers):
        p = layer(params["blocks"], i)
        x = (checkpoint(block, p, x, use_reentrant=False) if remat
             else block(p, x))
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, _unembed_weight(params, cfg), aux


def lm_forward(params: dict, tokens, cfg: ModelConfig):
    """tokens: (B,S) int -> (logits (B,S,V) fp32, aux_loss)."""
    x, w, aux = lm_features(params, tokens, cfg)
    return (x @ w).float(), aux


# --------------------------------------------------------------- prefill ---
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> dict:
    check_supported(cfg)
    dev = resolve_device(device)
    cache = {"pos": torch.zeros((), dtype=torch.int64, device=dev)}
    if cfg.family == "ssm":   # fixed size: max_len does not apply
        cache["ssm"] = mamba.init_mamba_state(cfg, batch, cfg.num_layers,
                                              dev)
    else:
        cache["kv"] = init_kv_cache(cfg, batch, max_len, cfg.num_layers, dev)
    return cache


def lm_prefill(params: dict, tokens, cfg: ModelConfig, max_len: int):
    """Forward + cache construction.  Returns (last-token logits (B,V)
    fp32, cache).  A KV cache holds the last ``min(S, max_len)`` positions
    at its front, as in the JAX package.  An SWA cache of length Sw holds
    the last ``min(S, Sw)`` with position a at index a mod Sw, where
    ``decode_attention`` reads it: JAX's layout where S <= Sw or S is a
    multiple of Sw; otherwise JAX writes them at the front, which its own
    decode misreads (ROADMAP.md, reference behaviours).  An ssm cache
    holds each layer's scan state and conv tail after position S."""
    dev = params["embed"].device
    x = _embed(params, tokens, cfg)
    B, S = x.shape[0], x.shape[1]
    cache = init_cache(cfg, B, max_len, dev)
    if cfg.family == "ssm":
        hs, cs = cache["ssm"]["h"], cache["ssm"]["conv"]
        for i in range(cfg.num_layers):
            p = layer(params["blocks"], i)
            y, hs[i], cs[i] = mamba.mamba_block(
                p["ssm"], rmsnorm(p["ln1"], x, cfg.norm_eps), cfg,
                return_state=True)
            x = x + y
    else:
        Sw = kv_len(cfg, max_len)
        keep = min(S, Sw)
        # the rolling buffer's kept positions S-Sw..S-1 sit at a mod Sw
        shift = S % Sw if cfg.window and keep == Sw else 0
        ck, cv = cache["kv"]["k"], cache["kv"]["v"]
        for i in range(cfg.num_layers):
            x, k, v = _block(layer(params["blocks"], i), x, cfg,
                             return_kv=True)
            if shift:
                ck[i] = torch.roll(k[:, S - keep:], shift, dims=1)
                cv[i] = torch.roll(v[:, S - keep:], shift, dims=1)
            else:
                ck[i, :, :keep] = k[:, S - keep:]
                cv[i, :, :keep] = v[:, S - keep:]
    # the final norm is per row: normalize only the row the logits need
    x = rmsnorm(params["final_norm"], x[:, -1:].contiguous(), cfg.norm_eps)
    cache["pos"].fill_(S)
    return _unembed(params, x, cfg)[:, 0], cache


# ----------------------------------------------------------- decode step ---
def lm_decode_step(params: dict, token, cache: dict, cfg: ModelConfig):
    """token: (B,1) int; cache from init_cache/lm_prefill, with ``pos``
    scalar or (B,).  Returns (logits (B,V) fp32, cache): unlike JAX the
    cache is updated in place and the same dict is returned.  The ssm
    recurrence does not read ``pos``; it advances all the same, so the
    engine keeps one bookkeeping for both families."""
    pos = cache["pos"]
    x = _embed(params, token, cfg)
    if cfg.family == "ssm":
        hs, cs = cache["ssm"]["h"], cache["ssm"]["conv"]
        for i in range(cfg.num_layers):
            p = layer(params["blocks"], i)
            h = rmsnorm(p["ln1"], x, cfg.norm_eps)
            x = x + mamba.mamba_decode(p["ssm"], h, hs[i], cs[i], cfg)
    else:
        ck, cv = cache["kv"]["k"], cache["kv"]["v"]
        for i in range(cfg.num_layers):
            p = layer(params["blocks"], i)
            h = rmsnorm(p["ln1"], x, cfg.norm_eps)
            x = x + decode_attention(p["attn"], h, ck[i], cv[i], pos, cfg)
            x = x + mlp(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    cache["pos"] = pos + 1
    return _unembed(params, x, cfg)[:, 0], cache
