"""Context-parallel (cp) execution on one card: the ring-attention loss
(port of ``repro/parallel/context.py``).

``make_cp_loss_fn`` splits every sequence into the plan's (possibly
unequal) ``cp_chunks``, pads each to the largest and stacks them on a new
leading rank axis, as the JAX package lays them on the mesh's ``pod``
axis.  Each block then runs rank-locally the qkv projection, with every
rank's RoPE positions carrying its GLOBAL chunk offset; the ring, as one
``ops.ring_attention`` (cp ``ring_step`` launches, each folding ring step
s for all ranks, where rank r reads the KV block of rank (r - s) % cp in
place: JAX's ``jnp.roll`` hop becomes an index); then the output
projection, the residual and the MLP.

Every rank runs all cp steps: there is no causal skip at the level of
ranks, as in the SPMD program.  A step whose keys all lie in a rank's
future leaves its carry unchanged; the kernel skips its tiles.  Each
layer notes the ring's cp - 1 hops of K and of V to the ICCL tap
(``iccl/communicator.py``): the notes the JAX ring makes while its block,
a ``lax.scan`` body, is traced once.  With ``cfg.remat`` (and a gradient
to take) each block runs under ``torch.utils.checkpoint``, as JAX's cp loss
wraps its block in ``jax.checkpoint``: the backward runs the block's
forward again, ring included, and the notes stay one forward's (they are
made outside the checkpointed block).

``make_cp_rank_loss_fn`` is the same ring across processes, one ring rank
each (the rank route of a pp 1, cp > 1 plan, ``pipeline.PPRankStep``):
the rank embeds only its chunk of the sequence, runs each block on it
(its RoPE positions the chunk's global ones) with
``ops.ring_attention_ranks`` in place of the stacked ring, its K and V
padded to the largest chunk and passed one hop a ring step over the
``pod`` axis's ``Communicator``, forward and backward, and adds up its
chunk's cross-entropy sums (``steps._ce_sums``) over the data group's
whole token count: summed over the ring, the rank losses are the
sequence mean and JAX's z-loss.  At tp > 1 each block is the Megatron
split of the pp 1 rank route (``parallel/tensor.py``) and the ring moves
only this model rank's KV heads.  Under ``cfg.remat`` the recompute runs
the ring's forward hops again, on every ring rank in the same order.

Numerics: the loss is ``steps.make_loss_fn``'s (CE with z-loss plus
``AUX_COEF`` times aux) and matches it within float tolerance (2e-5 fp32;
the online-softmax regrouping is not bit-associative).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.iccl.communicator import Communicator, _note
from repro_torch.kernels import ops
from repro_torch.kernels.ring_attention import (chunk_starts, pad_chunks,
                                                unpad_chunks)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _local_kv, _qkv, mlp, rmsnorm
from repro_torch.models.transformer import (_embed, _unembed,
                                            _unembed_weight, layer,
                                            remat_blocks, vocab_model)
from repro_torch.parallel.tensor import copy_to_model, reduce_from_model
from repro_torch.train.steps import (Z_COEF, LossFn, _ce_sums,
                                     cross_entropy, with_aux)


def check_cp_family(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for the families whose loss reads more
    than tokens and labels: the cp loss, like JAX's, reads those two
    only, so a cp plan of these has no route (the trainer raises rather
    than keep the reference loss)."""
    extra = {"encdec": "frames", "vlm": "image_embeds"}.get(cfg.family)
    if extra is not None:
        raise NotImplementedError(
            f"{cfg.name}: the cp loss reads tokens and labels only, as "
            f"JAX's (repro/parallel/context.py); the {cfg.family} loss "
            f"also reads {extra}, so a cp > 1 plan has no route")


def check_cp_supported(cfg: ModelConfig) -> None:
    """Raise ValueError when ``cfg`` falls outside the cp loss's scope (the
    trainer calls this before routing a cp > 1 plan here), and
    NotImplementedError for a family that reads more than tokens
    (``check_cp_family``)."""
    check_cp_family(cfg)
    kinds = cfg.layer_kinds()
    if set(kinds) != {"attn"} or not cfg.scan_layers:
        raise ValueError(
            "cp execution needs a uniform scanned attention stack "
            f"(got kinds={sorted(set(kinds))}, scan_layers={cfg.scan_layers})")
    if cfg.window is not None:
        raise ValueError("cp execution does not support sliding-window "
                         "attention (cfg.window)")
    if cfg.attn_logit_softcap:
        raise ValueError("cp execution does not support attn_logit_softcap")
    if cfg.n_experts:
        raise ValueError("cp execution does not support MoE blocks")


def make_cp_loss_fn(cfg: ModelConfig, cp_chunks: Sequence[int]) -> LossFn:
    """loss_fn(params, batch) running the cp ring on one device.
    ``cp_chunks``: per-rank chunk sizes summing to the batch's sequence
    length (``ParallelPlan.cp_chunk_sizes``).  Interchangeable with
    ``steps.make_loss_fn``'s loss: same value, same metrics dict."""
    check_cp_supported(cfg)
    chunks = tuple(int(c) for c in cp_chunks)
    cp = len(chunks)
    if cp < 2:
        raise ValueError("cp = 1 plans keep the reference loss")
    starts = chunk_starts(chunks)
    cmax = max(chunks)
    H, hd = cfg.n_heads, cfg.hd

    def block_fwd(p, x, pos):
        """One attention block on the (cp, B, Cmax, D) rank layout."""
        h = rmsnorm(p["ln1"], x, cfg.norm_eps)
        q, k, v = _qkv(p["attn"], h, cfg, pos)
        o = ops.ring_attention(q, k, v, chunks, causal=True)
        x = x + o.reshape(*x.shape[:-1], H * hd) @ p["attn"]["wo"]
        h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
        return x + mlp(p["mlp"], h2, cfg)

    def loss_fn(params, batch):
        x = _embed(params, batch["tokens"], cfg)              # (B, S, D)
        if x.shape[1] != sum(chunks):
            raise ValueError(f"sequence {x.shape[1]} != sum of the cp "
                             f"chunks {chunks}")
        pos = (torch.tensor(starts, device=x.device)[:, None, None]
               + torch.arange(cmax, device=x.device))      # (cp, 1, Cmax)
        xs = pad_chunks(x, chunks)                          # (cp, B, Cmax, D)
        remat = remat_blocks(cfg, params["blocks"], xs)
        for i in range(cfg.num_layers):
            p = layer(params["blocks"], i)
            # the KV blocks' hops around the ring, K's and V's
            kv = torch.empty(xs.shape[:-1] + (p["attn"]["wk"].shape[-1] // hd,
                                              hd), dtype=xs.dtype,
                             device="meta")
            for _ in range(2 * (cp - 1)):
                _note("cp_ring", "pod", kv)
            xs = (checkpoint(block_fwd, p, xs, pos, use_reentrant=False)
                  if remat else block_fwd(p, xs, pos))
        x = unpad_chunks(xs, chunks)
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        ce = cross_entropy(_unembed(params, x, cfg), batch["labels"])
        return with_aux(ce, torch.zeros((), dtype=torch.float32,
                                        device=x.device))

    return loss_fn


def make_cp_rank_loss_fn(cfg: ModelConfig, cp_chunks: Sequence[int],
                         ring: int, pod: Communicator,
                         model: Optional[Communicator] = None) -> LossFn:
    """loss_fn(params, batch) of ring rank ``ring`` of a cp ring across
    processes (``pod``: the ring's communicator; ``model``: this rank's
    tensor-parallel one, its params the rank's shard).  ``batch`` holds
    the data group's rows whole, ``(B, S)``; the rank reads its chunk.
    Its loss is its part: the ranks' losses sum to ``make_cp_loss_fn``'s,
    and its gradients are partial sums of the replicated parameters' (the
    caller sums them over ``pod``)."""
    check_cp_supported(cfg)
    chunks = tuple(int(c) for c in cp_chunks)
    cp = len(chunks)
    if cp < 2:
        raise ValueError("cp = 1 plans keep the reference loss")
    lo, n, cmax = chunk_starts(chunks)[ring], chunks[ring], max(chunks)
    hd = cfg.hd

    def hop(x):
        return pod.shift(x, 1, wrap=True)

    def pad(t):         # (B, n, h, hd) -> (1, B, Cmax, h, hd)
        return F.pad(t, (0, 0, 0, 0, 0, cmax - n))[None]

    def block_fwd(p, x, pos):
        """One attention block on this rank's chunk (B, n, D): the pp 1
        rank route's block with the ring in place of flash."""
        a = p["attn"]
        n_q = a["wq"].shape[-1] // hd
        split = model if n_q != cfg.n_heads else None
        h = copy_to_model(rmsnorm(p["ln1"], x, cfg.norm_eps), split)
        q, k, v = _qkv(a, h, cfg, pos)
        if split is not None and k.shape[-2] == cfg.n_kv_heads:
            k, v = _local_kv(k, v, cfg, n_q, split.index())
        o = ops.ring_attention_ranks(pad(q), pad(k), pad(v), chunks, ring,
                                     hop, causal=True)[0, :, :n]
        x = x + reduce_from_model(o.reshape(*x.shape[:-1], n_q * hd)
                                  @ a["wo"], split)
        h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
        return x + mlp(p["mlp"], h2, cfg, model)

    def loss_fn(params, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        if tokens.shape[1] != sum(chunks):
            raise ValueError(f"sequence {tokens.shape[1]} != sum of the cp "
                             f"chunks {chunks}")
        x = _embed(params, tokens[:, lo:lo + n], cfg, model)    # (B, n, D)
        pos = torch.arange(lo, lo + n, device=x.device)
        remat = remat_blocks(cfg, params["blocks"], x)
        for i in range(cfg.num_layers):
            p = layer(params["blocks"], i)
            x = (checkpoint(block_fwd, p, x, pos, use_reentrant=False)
                 if remat else block_fwd(p, x, pos))
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        vocab = vocab_model(_unembed_weight(params, cfg), cfg, model)
        s_ce, s_z, _ = _ce_sums(_unembed(params, x, cfg, model),
                                labels[:, lo:lo + n], vocab)
        count = tokens.numel()      # the group's tokens, every chunk's
        return with_aux(s_ce / count + Z_COEF * (s_z / count),
                        torch.zeros((), dtype=torch.float32,
                                    device=x.device))

    return loss_fn
