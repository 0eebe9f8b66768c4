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
made outside the checkpointed block).  A ring across cards is not ported
(ROADMAP.md queue A, item A8).

Numerics: the loss is ``steps.make_loss_fn``'s (CE with z-loss plus
``AUX_COEF`` times aux) and matches it within float tolerance (2e-5 fp32;
the online-softmax regrouping is not bit-associative).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.iccl.communicator import _note
from repro_torch.kernels import ops
from repro_torch.kernels.ring_attention import (chunk_starts, pad_chunks,
                                                unpad_chunks)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _qkv, mlp, rmsnorm
from repro_torch.models.transformer import (_embed, _unembed, layer,
                                            remat_blocks)
from repro_torch.train.steps import LossFn, cross_entropy, with_aux


def check_cp_supported(cfg: ModelConfig) -> None:
    """Raise ValueError when ``cfg`` falls outside the cp loss's scope (the
    trainer calls this before routing a cp > 1 plan here)."""
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
