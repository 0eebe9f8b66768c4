"""Pipeline-parallel (pp) execution on one card: the pipeline loss (port of
``repro/parallel/pipeline.py``).

HETHUB's headline mechanism is the non-uniform pipeline: the planner gives
more layers to the faster accelerator kind, and the trainer runs that
split.  The JAX package runs it as one SPMD program: a stage buffer
``(n_stages[, vpp], B_tick, S, D)`` sharded over the ``pod`` axis, each
tick applying every stage to its slot (a stage padded to the longest
stage's layer count, its padding layers masked to the identity) and
rolling the buffer one stage on.  On one device that program runs
unsharded, and its bubble slots and padding layers are work that never
reaches the loss.

``make_pp_loss_fn`` keeps the tick structure and leaves that work out.
Microbatch j is embedded at tick j and passes virtual stage vs at tick
j + vs.  At each tick only the valid slots (``0 <= t - vs < m``) run, each
over its real layers, read as views of the canonical ``(L, ...)`` stacks:
virtual stage ``vs = c * pp + s`` (chunk c of stage s under ``vpp > 1``)
holds the contiguous layers after those of virtual stages 0..vs-1, so
virtual order is layer order.  The parameters, the train state, AdamW and
``steps.make_train_step`` are the reference route's, and no padding row
takes optimizer state.  Each tick notes the stage hop the SPMD program
makes (``pp_shift``, the bytes of the buffer it rolls; ``pp_reshard``
before it when stages of mixed tp widths hop model-sharded activations) to
the ICCL tap, so one call notes what one trace of the JAX loss notes.

``stack_blocks_for_stages`` and ``unstack_blocks_for_stages`` convert
between the canonical layout and the JAX package's stacked pp layout
``(pp[, vpp], Lmax, ...)``: a JAX pp state converts with
``convert.from_jax`` followed by the unstack.

Scope: the uniform dense (attention) stack.  Mamba training waits for the
scan's backward kernel (ROADMAP.md queue A, item 9).  Stage tp and
activation sharding are bookkeeping on one card (ROADMAP A5b runs stages
on separate ranks).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.iccl.communicator import _note
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rmsnorm
from repro_torch.models.transformer import _block, _embed, _unembed
from repro_torch.optim.adamw import tree_map
from repro_torch.train.steps import LossFn, cross_entropy, with_aux


def check_pp_supported(cfg: ModelConfig) -> None:
    """Raise ValueError when ``cfg`` falls outside the pipeline loss's
    scope (the uniform dense stack)."""
    kinds = set(cfg.layer_kinds())
    if len(kinds) != 1:
        raise ValueError("pp execution needs a uniform scanned stack "
                         f"(got kinds={sorted(kinds)})")
    if kinds != {"attn"} or cfg.n_experts:
        raise ValueError(
            f"{cfg.name}: pp execution trains the uniform dense stack; "
            f"kinds={sorted(kinds)}, n_experts={cfg.n_experts} need "
            "training kernels not ported yet (ROADMAP.md queue A, item 9)")


def virtual_stage_layers(n_layers: int, n_stages: int,
                         layers_per_stage: Optional[Sequence[int]] = None,
                         vpp: int = 1) -> List[int]:
    """Real layers of each virtual stage, in virtual order (an even split
    when ``layers_per_stage`` is None)."""
    V = n_stages * vpp
    if layers_per_stage is None:
        if n_layers % V:
            raise ValueError(f"{n_layers} layers do not split evenly over "
                             f"{V} virtual stages")
        return [n_layers // V] * V
    ls = [int(n) for n in layers_per_stage]
    if len(ls) != V:
        raise ValueError(f"vpp={vpp} needs {V} virtual-stage layer counts, "
                         f"got {len(ls)}")
    if sum(ls) != n_layers or min(ls) < 0:
        raise ValueError(f"layer counts {ls} do not cover {n_layers} layers")
    return ls


def _n_layers(blocks: Dict[str, Any], axis: int) -> int:
    leaf = blocks
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.shape[axis]


def stack_blocks_for_stages(params: Dict[str, Any], n_stages: int,
                            layers_per_stage: Optional[Sequence[int]] = None,
                            vpp: int = 1) -> Dict[str, Any]:
    """Canonical ``(L, ...)`` blocks -> the JAX pp layout ``(n_stages,
    Lmax, ...)``, or ``(n_stages, vpp, Lmax, ...)`` with virtual stage
    ``c * n_stages + s`` at ``[s, c]``; short stages padded with zero
    rows.  ``layers_per_stage`` is per virtual stage, in virtual order."""
    vl = virtual_stage_layers(_n_layers(params["blocks"], 0), n_stages,
                              layers_per_stage, vpp)
    lmax = max(vl)

    def restack(a):
        pieces, off = [], 0
        for ls in vl:
            pad = a.new_zeros((lmax - ls,) + a.shape[1:])
            pieces.append(torch.cat([a[off:off + ls], pad]))
            off += ls
        stages = torch.stack(pieces)               # (V, Lmax, ...)
        if vpp == 1:
            return stages
        return stages.reshape((vpp, n_stages) + stages.shape[1:]).transpose(
            0, 1).contiguous()

    return dict(params, blocks=tree_map(restack, params["blocks"]))


def unstack_blocks_for_stages(params: Dict[str, Any], n_stages: int,
                              layers_per_stage: Optional[Sequence[int]] = None,
                              vpp: int = 1) -> Dict[str, Any]:
    """The inverse of ``stack_blocks_for_stages`` (port of
    ``_unstack_blocks`` in ``repro/ckpt/checkpoint.py``): padding rows are
    dropped.  With ``layers_per_stage`` None every stage is full."""
    lmax = _n_layers(params["blocks"], 1 if vpp == 1 else 2)
    V = n_stages * vpp
    vl = virtual_stage_layers(V * lmax if layers_per_stage is None
                              else sum(layers_per_stage), n_stages,
                              layers_per_stage, vpp)

    def un(a):
        pieces = []
        for vs, ls in enumerate(vl):
            s, c = vs % n_stages, vs // n_stages
            pieces.append(a[s, c, :ls] if vpp > 1 else a[s, :ls])
        return torch.cat(pieces)

    return dict(params, blocks=tree_map(un, params["blocks"]))


def _mixed_tp(stage_tp: Optional[Sequence[int]]) -> bool:
    return stage_tp is not None and len(set(stage_tp)) > 1


def _layer_views(blocks: Dict[str, Any], n_layers: int) -> List[Dict]:
    """Every layer's views of the stacks, made once a call: a layer that
    several microbatches read sums its gradient before one unbind
    backward writes the stacks' gradient."""
    unbound = tree_map(torch.unbind, blocks)
    return [tree_map(lambda vs, i=i: vs[i], unbound)
            for i in range(n_layers)]


def make_pp_loss_fn(cfg: ModelConfig, n_stages: int, n_microbatches: int,
                    layers_per_stage: Optional[Sequence[int]] = None,
                    vpp: int = 1,
                    stage_tp: Optional[Sequence[int]] = None) -> LossFn:
    """loss_fn(params, batch) running the pipeline's ticks on one device.

    ``params``: the canonical tree (blocks stacked ``(L, ...)``);
    ``batch``: tokens and labels microbatched ``(m, B_tick, S)``.
    ``layers_per_stage`` is per virtual stage in virtual order
    (``ParallelPlan.virtual_layers``); ``stage_tp`` the per-stage tensor
    widths (``ParallelPlan.tps``).  Each block runs under
    ``torch.utils.checkpoint`` when ``cfg.remat``.  The final norm, the
    unembed and the cross-entropy run on the whole microbatch at its
    finishing tick (no ``loss_chunk``, as in JAX).  The loss is the mean
    over microbatches of the CE plus ``AUX_COEF`` times the mean aux:
    the reference loss's value on the same tokens, same metrics dict."""
    check_pp_supported(cfg)
    if stage_tp is not None and len(stage_tp) != n_stages:
        raise ValueError(f"stage_tp needs {n_stages} entries, got "
                         f"{len(stage_tp)}")
    m = n_microbatches
    vl = virtual_stage_layers(cfg.num_layers, n_stages, layers_per_stage,
                              vpp)
    V = len(vl)
    starts = [sum(vl[:vs]) for vs in range(V)]
    reshard = _mixed_tp(stage_tp) and bool(cfg.act_sharding)
    block = functools.partial(_block, cfg=cfg)

    def run_stage(layers, vs: int, x: torch.Tensor) -> torch.Tensor:
        for p in layers[starts[vs]:starts[vs] + vl[vs]]:
            x = (checkpoint(block, p, x, use_reentrant=False) if cfg.remat
                 else block(p, x))
        return x

    def loss_fn(params, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        if tokens.shape[0] != m:
            raise ValueError(f"the batch holds {tokens.shape[0]} "
                             f"microbatches, the pipeline {m}")
        layers = _layer_views(params["blocks"], cfg.num_layers)
        Bt, S = tokens.shape[1], tokens.shape[2]
        # the stage buffer the SPMD program rolls each tick: noted, not made
        slots = (n_stages,) if vpp == 1 else (n_stages, vpp)
        hop = torch.empty(slots + (Bt, S, cfg.d_model), dtype=cfg.adtype,
                          device="meta")
        acts: Dict[int, torch.Tensor] = {}     # microbatch -> activation
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=params["embed"].device)
        for t in range(m + V - 1):
            if t < m:
                acts[t] = _embed(params, tokens[t], cfg)
            # the valid slots: virtual stage vs holds microbatch t - vs
            for vs in range(max(0, t - m + 1), min(t, V - 1) + 1):
                acts[t - vs] = run_stage(layers, vs, acts[t - vs])
            j_out = t - (V - 1)
            if j_out >= 0:
                h = rmsnorm(params["final_norm"], acts.pop(j_out),
                            cfg.norm_eps)
                loss_sum = loss_sum + cross_entropy(
                    _unembed(params, h, cfg), labels[j_out])
            if reshard:
                _note("pp_reshard", "model", hop)
            _note("pp_shift", "pod", hop)
        # dense blocks have no auxiliary loss: the valid slots' aux sum is 0
        return with_aux(loss_sum / m, torch.zeros_like(loss_sum))

    return loss_fn
