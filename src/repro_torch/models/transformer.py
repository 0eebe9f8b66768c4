"""Decoder-only LM (port of ``repro/models/transformer.py``: the dense,
MoE and ssm families' uniform stacks, the hybrid family's groups, and the
VLM's dense stack behind its prepended image embeddings).

Public entry points:
  init_lm(cfg, seed=, device=)                   -> params
  lm_forward(params, tokens, cfg, extra_embeds=) -> (logits, aux_loss)
  lm_features(params, tokens, cfg, extra_embeds=)
                                                 -> (features, w, aux_loss)
  init_cache(cfg, batch, max_len, device=)       -> cache
  lm_prefill(params, tokens, cfg, max_len, extra_embeds=)
                                                 -> (last_logits, cache)
  lm_decode_step(params, token, cache, cfg)      -> (logits, cache)

``extra_embeds`` (B, N, D), the VLM frontend stub's image embeddings, are
cast to the activation dtype and prepended to the token embeddings (JAX's
``_embed_tokens``): the sequence is then N + S positions, the labels and
the cache cover all of them.  The enc-dec family has a tree and a forward
of its own (``models/encdec.py``).

Blocks are stacked on a leading layer dim as in the JAX package; its
``lax.scan`` over layers is a Python loop over views of the stacks.  A
dense block is ``{ln1, attn, ln2, mlp}`` and caches K/V; a MoE block is
``{ln1, attn, ln2, moe}`` (``models/moe.py``) and caches K/V; an ssm
block (Mamba-1) is ``{ln1, ssm}`` and caches the scan state ``h`` and the
conv tail, whose size does not grow with the sequence.

The hybrid stack (recurrentgemma-9b) has JAX's scanned layout, so that
``convert.from_jax`` is the identity: ``params["groups"]`` holds one
block a slot of the pattern (``{"b0", "b1", "b2"}`` for (rec, rec,
attn)), each leaf stacked on the number of whole pattern cycles, and
``params["tail"]`` is a list of the ``num_layers % len(pattern)``
trailing blocks (38 = 12 x 3 + 2 rec).  A rec block is ``{ln1, rec, ln2,
mlp}`` (``models/griffin.py``) and caches its RG-LRU state and conv tail;
an attn block is the dense block and caches K/V.  Under remat a loss
checkpoints each group and each tail block whole, as JAX remats
``group_fwd`` and each tail block.  Every block
returns its auxiliary loss beside its output (the MoE router's Switch
loss; None where a block has none), which the forward sums over the
layers as JAX's ``lax.scan`` does.  The
unembed returns fp32 logits: a bf16 matmul rounds them to bf16 first,
where JAX accumulates straight into fp32.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.iccl.communicator import Communicator
from repro_torch.models import griffin, mamba, moe
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (_he, attention, decode_attention,
                                       init_attention, init_kv_cache,
                                       init_mlp, init_rmsnorm, kv_len, mlp,
                                       rmsnorm)
from repro_torch.parallel import tensor
from repro_torch.utils.device import DeviceLike, resolve_device


FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")
HYBRID_KINDS = ("rec", "attn")


def check_supported(cfg: ModelConfig) -> None:
    """This stack runs the uniform dense attention stack (qk_norm, SWA,
    every MLP activation of the registry; the VLM's too), the uniform MoE
    stack, the uniform Mamba-1 stack and the hybrid stack of RG-LRU and
    attention blocks in JAX's scanned layout."""
    if cfg.family == "encdec":
        raise ValueError(
            f"{cfg.name}: the enc-dec family runs models/encdec.py "
            "(registry.bundle_for routes it there), not the decoder-only "
            "stack")
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}; "
                         f"known: {FAMILIES + ('encdec',)}")
    if cfg.family == "hybrid" and (
            not cfg.scan_layers
            or not set(cfg.layer_kinds()) <= set(HYBRID_KINDS)):
        raise ValueError(
            f"{cfg.name}: the hybrid stack takes the blocks {HYBRID_KINDS} "
            f"in JAX's scanned layout (kinds {sorted(set(cfg.layer_kinds()))}"
            f", scan_layers {cfg.scan_layers})")
    if (cfg.family == "moe") != bool(cfg.n_experts) or (
            cfg.n_experts and not 1 <= cfg.top_k <= cfg.n_experts):
        raise ValueError(
            f"{cfg.name}: family {cfg.family!r} with n_experts "
            f"{cfg.n_experts}, top_k {cfg.top_k}: the moe family, and only "
            "it, takes experts (1 <= top_k <= n_experts)")


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
    if cfg.family == "hybrid":
        pat, n_groups, tail = hybrid_layout(cfg)
        params["groups"] = {f"b{i}": _init_hybrid(gen, cfg, kind, n_groups)
                            for i, kind in enumerate(pat)}
        params["tail"] = [layer(_init_hybrid(gen, cfg, kind, 1), 0)
                          for kind in tail]
        return params
    params["blocks"] = {
        "ln1": init_rmsnorm(D, cfg.pdtype, dev, L),
        "attn": init_attention(gen, cfg, L),
        "ln2": init_rmsnorm(D, cfg.pdtype, dev, L),
    }
    if cfg.n_experts:
        params["blocks"]["moe"] = moe.init_moe(gen, cfg, L)
    else:
        params["blocks"]["mlp"] = init_mlp(gen, cfg, L)
    return params


def hybrid_layout(cfg: ModelConfig):
    """(pattern, whole pattern cycles, the tail's kinds): JAX's
    ``_hybrid_layout``."""
    pat = cfg.block_pattern or ("rec", "rec", "attn")
    n_groups = cfg.num_layers // len(pat)
    return pat, n_groups, cfg.layer_kinds()[n_groups * len(pat):]


def _init_hybrid(gen: torch.Generator, cfg: ModelConfig, kind: str,
                 n: int) -> dict:
    """n stacked hybrid blocks of ``kind``: ``{ln1, attn | rec, ln2,
    mlp}``."""
    D, dev = cfg.d_model, gen.device
    p: Dict[str, Any] = {"ln1": init_rmsnorm(D, cfg.pdtype, dev, n)}
    if kind == "attn":
        p["attn"] = init_attention(gen, cfg, n)
    else:
        p["rec"] = griffin.init_rglru_block(gen, cfg, n)
    p["ln2"] = init_rmsnorm(D, cfg.pdtype, dev, n)
    p["mlp"] = init_mlp(gen, cfg, n)
    return p


def layer(blocks: dict, i: int) -> dict:
    """Views of layer ``i`` of the stacked blocks."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


def hybrid_layers(params: dict, cfg: ModelConfig):
    """The hybrid stack's (kind, block) pairs in layer order: the groups'
    slots in group order (views), then the tail."""
    pat, n_groups, tail = hybrid_layout(cfg)
    for g in range(n_groups):
        for i, kind in enumerate(pat):
            yield kind, layer(params["groups"][f"b{i}"], g)
    yield from zip(tail, params["tail"])


# --------------------------------------------------------------- forward ---
# ``model``: the model axis's communicator on a tensor-parallel rank, which
# holds its share of each leaf the sharding rules split
# (``parallel/sharding.py``); None leaves every path as it is.
def _embed(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
           model: Optional[Communicator] = None,
           extra_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The rows of ``tokens``, after ``extra_embeds`` (B, N, D) when given
    (cast to the activation dtype; on a tensor-parallel rank prepended to
    the whole rows the vocab-parallel lookup returns).  A lookup, not
    indexing: on the card its gradient sums a token's positions in fp32
    and rounds once, where indexing's adds them one at a time into the
    bf16 gradient, which loses a frequent token's later terms."""
    table = params["embed"]
    tokens = torch.as_tensor(tokens, device=table.device)
    if model is not None and table.shape[0] != cfg.vocab_size:
        x = tensor.vocab_parallel_embed(table, tokens, cfg.adtype, model)
    else:
        x = torch.nn.functional.embedding(tokens.long(), table).to(
            cfg.adtype)
    if extra_embeds is None:
        return x
    extra = torch.as_tensor(extra_embeds, device=table.device)
    return torch.cat([extra.to(cfg.adtype), x], dim=1)


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


def _ffn(p: dict, h: torch.Tensor, cfg: ModelConfig,
         model: Optional[Communicator] = None):
    """The block's feed-forward half on the normed h: (out, aux), aux None
    but for MoE."""
    if "moe" in p:
        return moe.moe_mlp(p["moe"], h, cfg)
    return mlp(p["mlp"], h, cfg, model), None


def _block(p: dict, x: torch.Tensor, cfg: ModelConfig,
           return_kv: bool = False,
           model: Optional[Communicator] = None):
    """An attention block: (x, aux), with ``return_kv`` (x, aux, k, v)."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    o, k, v = attention(p["attn"], h, cfg, return_kv=True, model=model)
    x = x + o
    y, aux = _ffn(p, rmsnorm(p["ln2"], x, cfg.norm_eps), cfg, model)
    x = x + y
    return (x, aux, k, v) if return_kv else (x, aux)


def _ssm_block(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """A Mamba-1 block: (x, aux = None)."""
    return x + mamba.mamba_block(p["ssm"], rmsnorm(p["ln1"], x, cfg.norm_eps),
                                 cfg), None


def _rec_block(p: dict, x: torch.Tensor, cfg: ModelConfig,
               return_state: bool = False):
    """An RG-LRU block and its MLP: (x, aux = None); with
    ``return_state`` (x, h, conv tail), its decode state."""
    y = griffin.rglru_block(p["rec"], rmsnorm(p["ln1"], x, cfg.norm_eps),
                            cfg, return_state=return_state)
    y, state = (y[0], y[1:]) if return_state else (y, None)
    x = x + y
    x = x + mlp(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)
    return (x, *state) if return_state else (x, None)


def _hybrid_fn(cfg: ModelConfig, kind: str):
    """A hybrid block of ``kind``, ``(p, x) -> (x, aux = None)``."""
    return functools.partial(_rec_block if kind == "rec" else _block,
                             cfg=cfg)


def _group(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """One whole cycle of the hybrid pattern, ``p`` its ``{"b0", ...}``
    slots (JAX's ``group_fwd``): (x, aux = None)."""
    pat = hybrid_layout(cfg)[0]
    for i, kind in enumerate(pat):
        x, _ = _hybrid_fn(cfg, kind)(p[f"b{i}"], x)
    return x, None


def hybrid_units(params: dict, cfg: ModelConfig):
    """The hybrid stack's remat units in order, (block fn, params): each
    group, then each tail block."""
    pat, n_groups, tail = hybrid_layout(cfg)
    group = functools.partial(_group, cfg=cfg)
    units = [(group, layer(params["groups"], g)) for g in range(n_groups)]
    return units + [(_hybrid_fn(cfg, kind), p)
                    for kind, p in zip(tail, params["tail"])]


def block_fn(cfg: ModelConfig, model: Optional[Communicator] = None):
    """The stack's block, ``(p, x) -> (x, aux)``."""
    if cfg.family == "ssm":
        return functools.partial(_ssm_block, cfg=cfg)
    return functools.partial(_block, cfg=cfg, model=model)


def run_blocks(layers, x: torch.Tensor, block, remat: bool):
    """x through the layers' blocks in order, each under
    ``torch.utils.checkpoint`` when ``remat``: (x, the sum of their aux
    losses, None where no block has one)."""
    aux = None
    for p in layers:
        x, a = (checkpoint(block, p, x, use_reentrant=False) if remat
                else block(p, x))
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def _requires_grad(tree) -> bool:
    if isinstance(tree, dict):
        return any(_requires_grad(v) for v in tree.values())
    if isinstance(tree, list):
        return any(_requires_grad(v) for v in tree)
    return tree.requires_grad


def remat_blocks(cfg: ModelConfig, blocks: dict, x: torch.Tensor) -> bool:
    """Whether a loss runs each block under ``torch.utils.checkpoint``:
    ``cfg.remat``, and a gradient to take (autograd on, and the blocks'
    weights or their input need one); a forward for serving or a probe
    under ``no_grad`` runs the blocks plainly."""
    return (cfg.remat and torch.is_grad_enabled()
            and (x.requires_grad or _requires_grad(blocks)))


def check_tp_supported(cfg: ModelConfig) -> None:
    """Tensor parallelism splits the dense stack (the VLM's too); the
    others raise, naming their ROADMAP item."""
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: tensor parallelism over the enc-dec stack (JAX "
            "splits its enc_blocks/dec_blocks by _fsdp_spec, where the "
            "port's rules split the decoder-only blocks) is not ported yet "
            "(ROADMAP.md queue A, item A9h)")
    if cfg.family == "hybrid":
        raise NotImplementedError(
            f"{cfg.name}: tensor parallelism over the hybrid stack (the "
            "RG-LRU width split over the model ranks, JAX's shard_lru "
            "rules) is not ported yet (ROADMAP.md queue A, item A9g)")
    if cfg.family == "ssm":
        raise NotImplementedError(
            f"{cfg.name}: tensor parallelism over the ssm stack (d_inner "
            "split over the model ranks) is not ported yet (ROADMAP.md "
            "queue A, item A9a)")
    if cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: tensor and expert parallelism over MoE "
            "(JAX's moe_mlp_manual) is not ported yet (ROADMAP.md queue A, "
            "item A9b)")


def lm_features(params: dict, tokens, cfg: ModelConfig,
                model: Optional[Communicator] = None,
                extra_embeds: Optional[torch.Tensor] = None):
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
    the vocab; a recomputed block all-reduces again.  ``aux_loss`` is the
    sum of the blocks' auxiliary losses (the MoE router's), under remat
    too.  ``extra_embeds`` are prepended (``_embed``): the features cover
    N + S positions."""
    check_supported(cfg)
    if model is not None:
        check_tp_supported(cfg)
    x = _embed(params, tokens, cfg, model, extra_embeds)
    # the block stack: ``blocks``, or the hybrid stack's groups and tail
    remat = remat_blocks(cfg, {k: params[k] for k in ("blocks", "groups",
                                                      "tail") if k in params},
                         x)
    if cfg.family == "hybrid":
        for fn, p in hybrid_units(params, cfg):
            x, aux = run_blocks((p,), x, fn, remat)
    else:
        x, aux = run_blocks((layer(params["blocks"], i)
                             for i in range(cfg.num_layers)), x,
                            block_fn(cfg, model), remat)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, _unembed_weight(params, cfg), aux


def lm_forward(params: dict, tokens, cfg: ModelConfig,
               extra_embeds: Optional[torch.Tensor] = None):
    """tokens: (B,S) int -> (logits (B,N+S,V) fp32, aux_loss), N the
    prepended ``extra_embeds``' rows (0 without)."""
    x, w, aux = lm_features(params, tokens, cfg, extra_embeds=extra_embeds)
    return (x @ w).float(), aux


# --------------------------------------------------------------- prefill ---
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> dict:
    check_supported(cfg)
    dev = resolve_device(device)
    cache = {"pos": torch.zeros((), dtype=torch.int64, device=dev)}
    kinds = cfg.layer_kinds()
    n_attn, n_rec = kinds.count("attn"), kinds.count("rec")
    if cfg.family == "ssm":   # fixed size: max_len does not apply
        cache["ssm"] = mamba.init_mamba_state(cfg, batch, cfg.num_layers,
                                              dev)
    if n_attn:
        cache["kv"] = init_kv_cache(cfg, batch, max_len, n_attn, dev)
    if n_rec:   # the hybrid stack's rec layers, in layer order
        cache["rec"] = griffin.init_rglru_state(cfg, batch, n_rec, dev)
    return cache


def lm_prefill(params: dict, tokens, cfg: ModelConfig, max_len: int,
               extra_embeds: Optional[torch.Tensor] = None):
    """Forward + cache construction.  Returns (last-token logits (B,V)
    fp32, cache).  A KV cache holds the last ``min(S, max_len)`` positions
    at its front, as in the JAX package.  An SWA cache of length Sw holds
    the last ``min(S, Sw)`` with position a at index a mod Sw, where
    ``decode_attention`` reads it: JAX's layout where S <= Sw or S is a
    multiple of Sw; otherwise JAX writes them at the front, which its own
    decode misreads (ROADMAP.md, reference behaviours).  An ssm cache
    holds each layer's scan state and conv tail after position S, and so
    does a hybrid cache for each rec layer (JAX's
    ``_rglru_prefill_state``), beside the attn layers' K/V.  With
    ``extra_embeds`` (N rows) prepended, S counts them: the cache and
    ``pos`` cover N + S_text positions."""
    dev = params["embed"].device
    x = _embed(params, tokens, cfg, extra_embeds=extra_embeds)
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
        ck, cv = (cache["kv"]["k"], cache["kv"]["v"]) if "kv" in cache \
            else (None, None)
        if cfg.family == "hybrid":
            hs, cs = cache["rec"]["h"], cache["rec"]["conv"]
            blocks = hybrid_layers(params, cfg)
        else:
            blocks = (("attn", layer(params["blocks"], i))
                      for i in range(cfg.num_layers))
        ai = ri = 0
        for kind, p in blocks:
            if kind == "rec":
                x, hs[ri], cs[ri] = _rec_block(p, x, cfg, return_state=True)
                ri += 1
                continue
            x, _, k, v = _block(p, x, cfg, return_kv=True)
            if shift:
                ck[ai] = torch.roll(k[:, S - keep:], shift, dims=1)
                cv[ai] = torch.roll(v[:, S - keep:], shift, dims=1)
            else:
                ck[ai, :, :keep] = k[:, S - keep:]
                cv[ai, :, :keep] = v[:, S - keep:]
            ai += 1
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
        ck, cv = (cache["kv"]["k"], cache["kv"]["v"]) if "kv" in cache \
            else (None, None)
        if cfg.family == "hybrid":
            hs, cs = cache["rec"]["h"], cache["rec"]["conv"]
            blocks = hybrid_layers(params, cfg)
        else:
            blocks = (("attn", layer(params["blocks"], i))
                      for i in range(cfg.num_layers))
        ai = ri = 0
        for kind, p in blocks:
            h = rmsnorm(p["ln1"], x, cfg.norm_eps)
            if kind == "rec":
                x = x + griffin.rglru_decode(p["rec"], h, hs[ri], cs[ri], cfg)
                ri += 1
            else:
                x = x + decode_attention(p["attn"], h, ck[ai], cv[ai], pos,
                                         cfg)
                ai += 1
            x = x + _ffn(p, rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)[0]
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    cache["pos"] = pos + 1
    return _unembed(params, x, cfg)[:, 0], cache
