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

The rank route runs the same plans with each stage in its own processes
(``PPRankStep``): rank ``(stage, replica, model_rank)`` of
``groups.RankGrid`` holds only its stage's layers (under vpp > 1 its
chunks, virtual stages s, s + pp, ..., stacked in virtual order), plus
the embedding on stage 0 and the final norm and unembedding on the last,
and of each its model rank's share under the sharding rules
(``parallel/sharding.py``; ``split_state_for_rank``, ``init_rank_state``).
At dp > 1 its AdamW moments and fp32 master are its replica's ZeRO-1
slice of that share.  It runs its stage's static share of the plan's
schedule: ``cap`` forwards, then one backward and one forward in turn,
then the remaining backwards, ``cap`` the simulator's in-flight peak
(``core/simulator.peak_activation_microbatches``); under
``interleaved-1f1b``, Megatron's units (``interleaved_units``).
Activations go to the next virtual stage and their gradients back through
the ``pod`` axis's ``Communicator`` on the plan's transport, model rank r
of one stage to model rank r of the next (the activation is whole on
every model rank); the wrap from the last stage to stage 0's next chunk
too.  Each replica takes its rows of every microbatch, and gradients are
averaged over ``data``.  Within a stage the tp ranks split every dense
block Megatron-style over the ``model`` axis (``parallel/tensor.py``).  A
pp = 1 plan runs the same way with one stage and no hops: the reference
loss, data- and tensor-parallel.  A pp = 1, cp > 1 plan runs the cp ring
across ranks (``context.make_cp_rank_loss_fn``): the ``pod`` axis holds
the ring, each ring rank takes its chunk of its data group's rows, and
the ring ranks of a group are replicas of one state, whose partial
gradients are summed over ``pod``; ZeRO-1 slices over ``data``, the
groups, never over the ring (JAX's ``opt_state_spec``).

Scope: a uniform stack, dense, MoE or Mamba-1.  A MoE block's auxiliary
loss joins the loss as JAX's does: the sum over the valid slots of every
stage's aux, over m, times ``AUX_COEF``; on ranks each stage's backward
takes ``AUX_COEF / m`` of its own aux beside its output's gradient, so
the aux's gradient reaches the earlier stages through the hops.  A
replica's aux over its own rows is not JAX's aux over the whole batch,
so MoE at dp > 1 is refused (ROADMAP.md queue A, item A9c), and tp over
the ssm and MoE stacks waits for items A9a and A9b.  On one card, stage
tp and activation sharding are bookkeeping; on ranks, stages of mixed tp
widths (the ``pp_reshard`` boundary) and tied embeddings wait for
ROADMAP.md queue A, item A5c, which also records why interleaved plans
with m > pp and m % pp != 0 stay refused there.  The cp ring at pp > 1
on ranks waits for ROADMAP.md queue A, item A8b.
"""
from __future__ import annotations

from typing import (Any, Dict, List, NamedTuple, Optional, Sequence, Tuple,
                    Union)

import torch

from repro_torch.core.plan import ParallelPlan
from repro_torch.core.simulator import (interleaved_streams,
                                        peak_activation_microbatches)
from repro_torch.iccl.communicator import Communicator, _note
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rmsnorm
from repro_torch.models.registry import bundle_for
from repro_torch.models.transformer import (_embed, _unembed,
                                            _unembed_weight, block_fn,
                                            check_tp_supported, run_blocks,
                                            vocab_model)
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.parallel import context
from repro_torch.parallel.groups import RankGrid
from repro_torch.parallel.sharding import (ShardingRules, gather_trees,
                                           map_with_path, shard_tree,
                                           zero_dims, zero_gather_trees,
                                           zero_shard_tree)
from repro_torch.train.steps import (AUX_COEF, LossFn, cross_entropy,
                                     make_loss_fn, with_aux)


def check_pp_supported(cfg: ModelConfig) -> None:
    """Raise ValueError when ``cfg`` falls outside the pipeline loss's
    scope (a uniform stack: dense, VLM, MoE or Mamba-1), as JAX's
    assert."""
    if cfg.family == "encdec":
        raise ValueError(
            f"{cfg.name}: pp execution runs params['blocks'], as JAX's "
            "make_pp_loss_fn does; the enc-dec tree holds enc_blocks and "
            "dec_blocks and trains on the reference route only")
    kinds = set(cfg.layer_kinds())
    if len(kinds) != 1:
        raise ValueError("pp execution needs a uniform scanned stack "
                         f"(got kinds={sorted(kinds)})")


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


def _seq_total(tokens: torch.Tensor,
               extra: Optional[torch.Tensor]) -> int:
    """The positions a stage runs: the text's, after the prepended image
    embeddings' (microbatched, ``(m, B_tick, ...)``)."""
    return tokens.shape[2] + (0 if extra is None else extra.shape[2])


def make_pp_loss_fn(cfg: ModelConfig, n_stages: int, n_microbatches: int,
                    layers_per_stage: Optional[Sequence[int]] = None,
                    vpp: int = 1,
                    stage_tp: Optional[Sequence[int]] = None,
                    telemetry=None) -> LossFn:
    """loss_fn(params, batch) running the pipeline's ticks on one device.

    ``params``: the canonical tree (blocks stacked ``(L, ...)``);
    ``batch``: tokens and labels microbatched ``(m, B_tick, S)``, and a
    VLM's ``image_embeds`` ``(m, B_tick, N, D)``, which stage 0 prepends
    (its labels cover N + S positions).
    ``layers_per_stage`` is per virtual stage in virtual order
    (``ParallelPlan.virtual_layers``); ``stage_tp`` the per-stage tensor
    widths (``ParallelPlan.tps``).  Each block runs under
    ``torch.utils.checkpoint`` when ``cfg.remat``.  The final norm, the
    unembed and the cross-entropy run on the whole microbatch at its
    finishing tick (no ``loss_chunk``, as in JAX).  The loss is the mean
    over microbatches of the CE plus ``AUX_COEF`` times the mean aux:
    the reference loss's value on the same tokens (for MoE, JAX's pp
    loss: the aux of each microbatch, where the reference loss takes it
    over the whole batch), same metrics dict.

    ``telemetry`` (``telemetry.StageTelemetry``) takes a mark at the end
    of every tick, after its valid slots ran, and one after the last, as
    JAX's ``_tick_mark``: in the loss itself, so remat's recomputation in
    the backward marks nothing; a mark reads no value (the loss's running
    sum only names the device whose stream it marks)."""
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
    block = block_fn(cfg)

    def run_stage(layers, vs: int, x: torch.Tensor):
        """(x after virtual stage vs, the sum of its blocks' aux or
        None)."""
        return run_blocks(layers[starts[vs]:starts[vs] + vl[vs]], x, block,
                          cfg.remat)

    def loss_fn(params, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        extra = batch.get("image_embeds")
        if tokens.shape[0] != m:
            raise ValueError(f"the batch holds {tokens.shape[0]} "
                             f"microbatches, the pipeline {m}")
        layers = _layer_views(params["blocks"], cfg.num_layers)
        Bt, S = tokens.shape[1], _seq_total(tokens, extra)
        # the stage buffer the SPMD program rolls each tick: noted, not made
        slots = (n_stages,) if vpp == 1 else (n_stages, vpp)
        hop = torch.empty(slots + (Bt, S, cfg.d_model), dtype=cfg.adtype,
                          device="meta")
        acts: Dict[int, torch.Tensor] = {}     # microbatch -> activation
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=params["embed"].device)
        aux_sum = torch.zeros_like(loss_sum)
        for t in range(m + V - 1):
            if t < m:
                acts[t] = _embed(params, tokens[t], cfg, extra_embeds=(
                    None if extra is None else extra[t]))
            # the valid slots: virtual stage vs holds microbatch t - vs
            for vs in range(max(0, t - m + 1), min(t, V - 1) + 1):
                acts[t - vs], aux = run_stage(layers, vs, acts[t - vs])
                if aux is not None:
                    aux_sum = aux_sum + aux
            if telemetry is not None:
                telemetry.mark(t, loss_sum)
            j_out = t - (V - 1)
            if j_out >= 0:
                h = rmsnorm(params["final_norm"], acts.pop(j_out),
                            cfg.norm_eps)
                loss_sum = loss_sum + cross_entropy(
                    _unembed(params, h, cfg), labels[j_out])
            if reshard:
                _note("pp_reshard", "model", hop)
            _note("pp_shift", "pod", hop)
        if telemetry is not None:
            telemetry.mark(m + V - 1, loss_sum)
        return with_aux(loss_sum / m, aux_sum / m)

    return loss_fn


# ---------------------------------------------------------- the ranks ----
A5C = "ROADMAP.md queue A, item A5c"
A8B = "ROADMAP.md queue A, item A8b"
A9C = "ROADMAP.md queue A, item A9c"


def check_rank_plan(cfg: ModelConfig, plan: ParallelPlan) -> None:
    """Raise ValueError when ``plan`` falls outside the rank route's scope:
    a plan of the dense stack, one tp width and one dp width, under
    ``interleaved-1f1b`` with vpp > 1 a microbatch count that Megatron's
    order matches every message of (m <= pp, or m a multiple of pp), and
    cp > 1 only at pp 1 on a model in the cp loss's scope; tp > 1 on the
    dense stack only; MoE on one replica; not the hybrid stack (A9g) nor
    the enc-dec stack (A9h)."""
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: the rank routes (pp, dp, tp, ZeRO-1) over the "
            "enc-dec stack are not ported yet: JAX trains it over its data "
            "mesh axis (ROADMAP.md queue A, item A9h) and never through its "
            "pp or cp loss")
    if cfg.family == "hybrid":
        raise NotImplementedError(
            f"{cfg.name}: the rank routes (tp, dp, ZeRO-1) over the hybrid "
            "stack wait for JAX's shard_lru rules (ROADMAP.md queue A, item "
            "A9g)")
    check_pp_supported(cfg)
    m, pp = plan.micro_batches, plan.pp
    if max(plan.tps) > 1:
        check_tp_supported(cfg)
    if cfg.n_experts and max(plan.dps) > 1:
        raise ValueError(
            f"{cfg.name} at dp {max(plan.dps)}: JAX's MoE aux is a product "
            f"of means over the whole (micro)batch, and a replica's over "
            f"its own rows is another number; MoE at dp > 1 waits for "
            f"{A9C}")
    if plan.vpp > 1 and m > pp and m % pp:
        raise ValueError(
            f"interleaved-1f1b with vpp={plan.vpp} on ranks: Megatron's "
            f"order pairs every hop with its receive only for m <= pp or m "
            f"a multiple of pp (m={m}, pp={pp}); ragged m stays refused "
            f"({A5C})")
    if len(set(plan.tps)) > 1:
        raise ValueError(f"stage tp {plan.tps} on ranks: stages of mixed "
                         f"tp widths need the pp_reshard boundary, which "
                         f"waits for {A5C}")
    if cfg.tie_embeddings:
        raise ValueError(f"{cfg.name}: tied embeddings would be one tensor "
                         f"on stage 0 and the last stage; on ranks they "
                         f"wait for {A5C}")
    if plan.cp > 1:
        if plan.pp > 1:
            raise ValueError(f"cp={plan.cp} at pp={plan.pp} on ranks: the "
                             f"ring and the stages would share the pod "
                             f"axis; this waits for {A8B}")
        context.check_cp_supported(cfg)
    if len(set(plan.dps)) > 1:
        raise ValueError(f"stage dp widths {plan.dps} differ; the rank grid "
                         "has one dp")


LayersLike = Union[ParallelPlan, Sequence[int]]


def _layout(plan_or_layers: LayersLike) -> Tuple[List[int], int, int]:
    """(virtual layers, vpp, dp): a plan's own, dp the width of its
    ``data`` axis (at cp > 1 its data groups, ``dp / cp``: the ring ranks
    of a group hold one state); a list of stage layer counts is vpp 1 and
    dp 1."""
    if isinstance(plan_or_layers, ParallelPlan):
        p = plan_or_layers
        return list(p.virtual_layers), p.vpp, p.dps[0] // p.cp
    return [int(n) for n in plan_or_layers], 1, 1


def _chunks(layers: Sequence[int], stage: int,
            vpp: int) -> List[Tuple[int, int]]:
    """(first layer, layer count) of each chunk of stage ``stage``: virtual
    stages stage, stage + pp, ..., in virtual order."""
    pp = len(layers) // vpp
    return [(sum(layers[:vs]), layers[vs])
            for vs in range(stage, len(layers), pp)]


def stage_tree(tree: Dict[str, Any], layers: Sequence[int], stage: int,
               vpp: int = 1) -> Dict[str, Any]:
    """Stage ``stage``'s part of a canonical tree, copied: the layers of
    its chunks (``layers`` per virtual stage; under vpp > 1 chunk c is
    virtual stage ``c * pp + stage``), stacked in virtual order, the
    embedding on stage 0, and the rest (the final norm, the unembedding)
    on the last stage."""
    chunks = _chunks(layers, stage, vpp)
    first, last = stage == 0, stage == len(layers) // vpp - 1
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if k == "blocks":
            out[k] = tree_map(lambda a: torch.cat(
                [a[s:s + n] for s, n in chunks]), v)
        elif (first if k == "embed" else last):
            out[k] = tree_map(torch.clone, v)
    return out


def gather_stage_trees(trees: Sequence[Dict[str, Any]],
                       layers: Optional[Sequence[int]] = None
                       ) -> Dict[str, Any]:
    """The canonical tree from the stages' ``stage_tree``s, in stage
    order; ``layers`` (per virtual stage) puts interleaved chunks back in
    layer order (None: one chunk a stage)."""
    pp = len(trees)
    out = {k: v for k, v in trees[0].items() if k != "blocks"}
    out.update((k, v) for k, v in trees[-1].items()
               if k not in ("blocks", "embed"))

    def join(*stacks):
        if layers is None:
            return torch.cat(stacks)
        pieces, at = [], [0] * pp
        for vs, n in enumerate(layers):
            s = vs % pp
            pieces.append(stacks[s][at[s]:at[s] + n])
            at[s] += n
        return torch.cat(pieces)

    # the stacks last, as ``init_lm`` makes the tree
    out["blocks"] = tree_map(join, *(t["blocks"] for t in trees))
    return out


def _model_part(tree: Dict[str, Any], rules: Optional[ShardingRules],
                model_rank: int) -> Dict[str, Any]:
    if rules is None or rules.tp == 1:
        return tree
    return shard_tree(tree, rules, model_rank)


def _zero(params: Dict[str, Any], rules: Optional[ShardingRules],
          dp: int) -> Optional[Dict[str, Any]]:
    """The ZeRO-1 dims of a rank's parameters at data width ``dp`` (None
    at dp 1: the optimizer state is whole)."""
    if dp == 1:
        return None
    if rules is None:
        raise ValueError(f"dp={dp}: ZeRO-1 splits the optimizer state by "
                         "the sharding rules; pass rules")
    return zero_dims(params, rules, dp)


def split_state_for_rank(state: Dict[str, Any], plan_or_layers: LayersLike,
                         stage: int, rules: Optional[ShardingRules] = None,
                         model_rank: int = 0, *,
                         replica: int = 0) -> Dict[str, Any]:
    """What rank (stage ``stage``, ``replica``, ``model_rank``) owns of a
    whole train state (``steps.init_train_state``'s layout), copied: its
    share under ``rules`` (None: the whole stage) of its stage's
    parameters (its chunks' layers under vpp > 1); of their fp32 master,
    m and v the same share, and of that at dp > 1 its replica's ZeRO-1
    slice; the step and the AdamW count.  A plan gives the virtual
    layers, vpp and dp; a list of stage layer counts means vpp 1, dp 1.
    At cp > 1 ``replica`` is the data group: every ring rank of a group
    holds the same state."""
    layers, vpp, dp = _layout(plan_or_layers)

    def part(tree):
        return _model_part(stage_tree(tree, layers, stage, vpp), rules,
                           model_rank)

    params = part(state["params"])
    dims = _zero(params, rules, dp)

    def opt_part(tree):
        own = part(tree)
        return own if dims is None else \
            zero_shard_tree(own, dims, dp, replica)

    opt = {k: v.clone() if k == "count" else opt_part(v)
           for k, v in state["opt"].items()}
    return {"params": params, "opt": opt, "step": state["step"].clone()}


def _gather_states(states: Sequence[Dict[str, Any]], gather,
                   gather_opt=None) -> Dict[str, Any]:
    """A state from parts: ``gather`` joins the parts' trees
    (``gather_opt`` the optimizer's, when it differs)."""
    gather_opt = gather_opt or gather
    opt = {k: states[0]["opt"][k] if k == "count"
           else gather_opt([s["opt"][k] for s in states])
           for k in states[0]["opt"]}
    return {"params": gather([s["params"] for s in states]), "opt": opt,
            "step": states[0]["step"]}


def gather_rank_states(states: Sequence[Dict[str, Any]],
                       rules: Optional[ShardingRules] = None,
                       plan_or_layers: Optional[LayersLike] = None
                       ) -> Dict[str, Any]:
    """The inverse of ``split_state_for_rank``: the whole state from every
    rank's state, in rank order (``(stage * dp + replica) * tp +
    model_rank``; ``rules`` None: one rank a stage and replica; at cp > 1
    ``groups.RankGrid``'s, whose ring ranks 0 come first and are read).
    The plan gives the virtual layers, needed to put interleaved chunks
    back in order, and dp; None or a list of layer counts means dp 1."""
    layers, dp = None, 1
    if plan_or_layers is not None:
        layers, _, dp = _layout(plan_or_layers)
        cp = getattr(plan_or_layers, "cp", 1)
        states = states[:len(states) // cp]
    tp = 1 if rules is None else rules.tp

    def join_replicas(parts):
        dims = _zero(parts[0]["params"], rules, dp)
        return _gather_states(parts, lambda ts: ts[0],
                              lambda ts: zero_gather_trees(ts, dims))

    if dp > 1:      # each (stage, model rank): its replicas' ZeRO slices
        states = [join_replicas([states[(s * dp + q) * tp + r]
                                 for q in range(dp)])
                  for s in range(len(states) // (dp * tp))
                  for r in range(tp)]
    if tp > 1:
        states = [_gather_states(states[i:i + tp],
                                 lambda ts: gather_trees(ts, rules))
                  for i in range(0, len(states), tp)]
    return _gather_states(states,
                          lambda ts: gather_stage_trees(ts, layers))


Index = Tuple[slice, ...]


class LeafSlices(NamedTuple):
    """Where one leaf of a rank's state sits in the canonical whole leaf:
    ``pieces`` are ``(rank index, whole index)`` pairs of basic slices,
    ``shape`` the rank's leaf, ``whole`` the whole leaf's shape; ``writer``
    marks the one rank that writes these elements to a checkpoint."""
    shape: Tuple[int, ...]
    whole: Tuple[int, ...]
    pieces: Tuple[Tuple[Index, Index], ...]
    writer: bool


# a piece: (first index in the rank's leaf, first in the whole, size), per dim
_Piece = Tuple[Tuple[int, ...], Tuple[int, ...], Tuple[int, ...]]


def _cut(pieces: List[_Piece], shape: Tuple[int, ...], d: int, n: int,
         i: int) -> Tuple[List[_Piece], Tuple[int, ...]]:
    """Slice ``i`` of ``n`` equal slices along dim ``d`` (``Tensor.chunk``
    of a divisible dim) of a leaf made of ``pieces``."""
    k = shape[d] // n
    a, b = i * k, (i + 1) * k
    out = []
    for lo, wlo, size in pieces:
        s, e = max(lo[d], a), min(lo[d] + size[d], b)
        if s < e:
            out.append((lo[:d] + (s - a,) + lo[d + 1:],
                        wlo[:d] + (wlo[d] + s - lo[d],) + wlo[d + 1:],
                        size[:d] + (e - s,) + size[d + 1:]))
    return out, shape[:d] + (k,) + shape[d + 1:]


def rank_leaf_slices(whole: Dict[str, Any], plan_or_layers: LayersLike,
                     stage: int, rules: Optional[ShardingRules] = None,
                     model_rank: int = 0, *, replica: int = 0,
                     ring: int = 0) -> Dict[str, Any]:
    """``split_state_for_rank``'s tree for rank (``stage``, ``replica``,
    ``model_rank``) with a ``LeafSlices`` at each leaf: where the leaf's
    elements sit in the whole state ``whole`` (only its shapes are read; a
    ``meta`` tree will do).  The slices compose as the split takes them:
    the stage's chunks of layers in virtual order, the model rank's slice
    of ``rules.split_dim``, then for the AdamW moments and master at
    dp > 1 the replica's ZeRO-1 slice of ``zero_dim`` (which may cross a
    chunk boundary, hence a list of pieces).

    One rank writes each element: replica 0 the parameters and the
    optimizer leaves ZeRO-1 keeps whole, every replica its ZeRO-1 slice;
    of a leaf the ``model`` axis replicates (norms, kv heads that
    ``_local_kv`` replicates at tp > Hk), model rank 0; ``step`` and
    ``opt/count`` rank 0.  At cp > 1 ``replica`` is the data group and
    the ring ranks of a group hold the same elements: ring rank 0 writes
    them (``ring``: this rank's place on the ring)."""
    layers, vpp, dp = _layout(plan_or_layers)
    chunks = _chunks(layers, stage, vpp)
    first, last = stage == 0, stage == len(layers) // vpp - 1
    tp = 1 if rules is None else rules.tp
    if dp > 1 and rules is None:
        raise ValueError(f"dp={dp}: ZeRO-1 splits the optimizer state by "
                         "the sharding rules; pass rules")

    def part(path, a):
        """(pieces, shape, tp split dim) of the rank's share of ``a``."""
        shape = tuple(a.shape)
        zero = (0,) * len(shape)
        if path[0] == "blocks":     # the chunks stacked in virtual order
            pieces, off = [], 0
            for start, n in chunks:
                if n:
                    pieces.append(((off,) + zero[1:], (start,) + zero[1:],
                                   (n,) + shape[1:]))
                    off += n
            shape = (off,) + shape[1:]
        else:
            pieces = [(zero, zero, shape)]
        d = None if tp == 1 else rules.split_dim(path, len(shape))
        if d is not None:
            pieces, shape = _cut(pieces, shape, d, tp, model_rank)
        return pieces, shape, d

    def leaf(a, pieces, shape, writer):
        return LeafSlices(shape, tuple(a.shape), tuple(
            (tuple(slice(lo, lo + n) for lo, n in zip(lo, size)),
             tuple(slice(w, w + n) for w, n in zip(wlo, size)))
            for lo, wlo, size in pieces), writer)

    def own(tree):      # the stage's keys, as ``stage_tree`` keeps them
        return {k: v for k, v in tree.items()
                if k == "blocks" or (first if k == "embed" else last)}

    def params_tree(tree):
        def one(path, a):
            pieces, shape, d = part(path, a)
            return leaf(a, pieces, shape, replica == 0 and ring == 0 and
                        (d is not None or model_rank == 0))
        return map_with_path(one, own(tree))

    def opt_tree(tree):
        def one(path, a):
            pieces, shape, d = part(path, a)
            # the parameter's share has this shape: ``zero_dims`` of it
            z = None if dp == 1 else rules.zero_dim(path, shape, dp)
            if z is not None:
                pieces, shape = _cut(pieces, shape, z, dp, replica)
            return leaf(a, pieces, shape, (z is not None or replica == 0)
                        and ring == 0 and (d is not None or model_rank == 0))
        return map_with_path(one, own(tree))

    head = stage == 0 and replica == 0 and model_rank == 0 and ring == 0

    def scalar(a):
        return LeafSlices((), (), (((), ()),), head)

    opt = {k: scalar(v) if k == "count" else opt_tree(v)
           for k, v in whole["opt"].items()}
    return {"params": params_tree(whole["params"]), "opt": opt,
            "step": scalar(whole["step"])}


def init_rank_state(bundle, plan_or_layers: LayersLike, stage: int,
                    seed: int = 0, device=None,
                    rules: Optional[ShardingRules] = None,
                    model_rank: int = 0, *,
                    replica: int = 0) -> Dict[str, Any]:
    """``split_state_for_rank(steps.init_train_state(bundle, seed), ...)``
    without the whole fp32 state: ``init_lm`` draws every leaf from one
    generator in a fixed order, so the rank draws the whole parameter tree
    (bf16 at full width), keeps its share of its stage and makes the
    optimizer state of its ZeRO-1 slice only."""
    layers, vpp, dp = _layout(plan_or_layers)
    full = bundle.init(bundle.cfg, seed=seed, device=device)
    staged = stage_tree(full, layers, stage, vpp)
    del full
    params = _model_part(staged, rules, model_rank)
    del staged
    dims = _zero(params, rules, dp)
    mine = params if dims is None else tree_map(
        lambda p, d: p if d is None else p.chunk(dp, d)[replica],
        params, dims)
    first = tree_leaves(params)[0]
    return {"params": params,
            "opt": adamw.init_opt_state(
                mine, keep_master=bundle.cfg.param_dtype != "float32"),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


Op = Tuple            # ("F" | "B", j) at vpp 1; ("F" | "B", chunk, j)
Msg = Tuple[str, int, int]      # (kind, the virtual stage it feeds, j)
Hop = Tuple[str, int, Msg]      # ("send" | "recv", peer stage, message)


def rank_schedule(stage: int, n_stages: int, n_microbatches: int,
                  schedule: str = "1f1b", eager_slack: int = 2,
                  vpp: int = 1) -> List[Op]:
    """Stage ``stage``'s static order of forwards and backwards.

    ``1f1b``, ``1f1b-eager``, ``gpipe``: ``("F", j)`` and ``("B", j)``;
    ``cap`` forwards, then one backward and one forward in turn, then the
    remaining backwards.  ``cap`` is the simulator's in-flight peak
    (``min(m, pp - s)`` for 1f1b, plus ``eager_slack`` for 1f1b-eager, m
    for gpipe), at most m.

    ``interleaved-1f1b``: ``("F", c, j)`` and ``("B", c, j)`` for chunk c
    (virtual stage ``c * pp + stage``), Megatron's order
    (``interleaved_units``)."""
    if schedule == "interleaved-1f1b":
        return [op for unit in interleaved_units(
            stage, n_stages, n_microbatches, vpp) for op in unit]
    m = n_microbatches
    cap = min(m, peak_activation_microbatches(stage, n_stages, m, schedule,
                                              eager_slack))
    order = [("F", j) for j in range(cap)]
    nf = cap
    for j in range(m):
        order.append(("B", j))
        if nf < m:
            order.append(("F", nf))
            nf += 1
    return order


def interleaved_units(stage: int, n_stages: int, n_microbatches: int,
                      vpp: int) -> List[Tuple[Op, ...]]:
    """Megatron's interleaved-1F1B order for stage ``stage`` as units: W
    warmup forwards, then units of one forward and one backward, then
    the W cooldown backwards, the ops taken in turn from
    ``core/simulator.interleaved_streams``.  W = 2 (pp - 1 - s) +
    (vpp - 1) min(pp, m), at most vpp m: W + 1 is
    ``interleaved_inflight_cap``, the most chunk activations in flight."""
    pp, m = n_stages, n_microbatches
    fwd, bwd = interleaved_streams(pp, vpp, m)
    total = vpp * m
    warm = min(total, 2 * (pp - 1 - stage) + (vpp - 1) * min(pp, m))
    units: List[Tuple[Op, ...]] = [(("F",) + fwd[i],) for i in range(warm)]
    units += [(("F",) + fwd[warm + k], ("B",) + bwd[k])
              for k in range(total - warm)]
    units += [(("B",) + bwd[k],) for k in range(total - warm, total)]
    return units


def _unit_hops(stage: int, pp: int, vpp: int, unit: Sequence[Op]
               ) -> Tuple[List[Hop], List[Hop]]:
    """(the receives a unit needs, the sends it makes), each the forward's
    (an activation) before the backward's (a gradient)."""
    V, recvs, sends = pp * vpp, [], []
    prev, nxt = (stage - 1) % pp, (stage + 1) % pp
    for kind, c, j in unit:
        vs = c * pp + stage
        if kind == "F":
            if vs > 0:
                recvs.append(("recv", prev, ("F", vs, j)))
            if vs < V - 1:
                sends.append(("send", nxt, ("F", vs + 1, j)))
        else:
            if vs < V - 1:
                recvs.append(("recv", nxt, ("B", vs, j)))
            if vs > 0:
                sends.append(("send", prev, ("B", vs - 1, j)))
    return recvs, sends


def rank_boundaries(stage: int, n_stages: int, n_microbatches: int,
                    schedule: str = "1f1b", eager_slack: int = 2,
                    vpp: int = 1) -> List[Tuple[List[Hop], Tuple[Op, ...]]]:
    """``[(batch, unit)]``: each unit of the stage's order after the batch
    posted before it, then the last batch with no unit.  A unit is one op
    ``(kind, chunk, j)`` of ``rank_schedule`` at vpp 1 (chunk 0), one of
    Megatron's ``interleaved_units`` under ``interleaved-1f1b``.  A batch
    holds the previous unit's sends and this unit's receives (up to two
    each), sends first, each pair activation before gradient; a message is
    named by what it feeds, ``(kind, virtual stage, j)``.  The wrap hop
    (stage pp - 1's chunk c to stage 0's chunk c + 1, and its gradient
    back) is one of them."""
    if schedule == "interleaved-1f1b":
        units = interleaved_units(stage, n_stages, n_microbatches, vpp)
    else:
        units = [((kind, 0, j),) for kind, j in rank_schedule(
            stage, n_stages, n_microbatches, schedule, eager_slack)]
    out, sends = [], []
    for unit in units:
        recvs, nxt = _unit_hops(stage, n_stages, vpp, unit)
        out.append((sends + recvs, unit))
        sends = nxt
    out.append((sends, ()))
    return out


class PPRankStep:
    """One train step of this rank's share of a plan: the rank route.

    With pp > 1, ``loss_and_grads(params, batch)`` runs the stage's
    ``rank_schedule`` over this replica's microbatches ``(m, B_tick / dp,
    S)``.  A forward of chunk c (virtual stage ``vs = c * pp + stage``;
    one chunk under vpp 1) takes its input from the embedding (vs 0) or
    from the stage before (virtual stage vs - 1, on stage ``stage - 1``
    mod pp), runs the chunk's layers (each under ``torch.utils.
    checkpoint`` when ``cfg.remat``, as the one-card loss) and sends the
    activation on; virtual stage V - 1 computes the final norm, the
    unembedding and the cross-entropy, scaled by 1/m.  A backward takes
    the activation's gradient from virtual stage vs + 1 (or starts from
    the loss) and sends its input's gradient back.  Each boundary of the
    order (between two ops at vpp 1, two of Megatron's units under
    ``interleaved-1f1b``) posts one batch (``rank_boundaries``): the
    previous unit's sends and the next unit's receives, so two stages
    that send to each other at once cannot deadlock, and waits for all of
    it; under ``1f1b-eager`` an activation's send completes in the
    background and is waited on at the end of the step.  The order never
    depends on timing, so the gradients are the same from run to run.
    With pp = 1 it is the reference loss (``steps.make_loss_fn``) over
    this replica's rows ``(B / dp, S)``, each block under ``torch.utils.
    checkpoint`` when ``cfg.remat``, as on the reference route (a
    recomputed tp block all-reduces again); a plan of m > 1 microbatches
    of those rows takes them one at a time, adding up the gradients.  A
    pp = 1, cp > 1 plan's replica is a data group, whose rows ``(B / dp,
    S)`` every ring rank of the group takes whole: its loss is the cp
    ring across ranks (``context.make_cp_rank_loss_fn``) on its chunk,
    its K and V hopping over ``pod``.

    At tp > 1 every layer, the embedding and the loss run on this model
    rank's shard over the ``model`` axis's communicator, which takes the
    plan's transport as ``pod`` and ``data`` do; the gradients of the
    leaves that each rank holds only in part (k/v replicated under split q
    heads) are summed over ``model``.

    ``__call__(state, batch)`` then, at cp > 1, sums the gradients over
    ``pod`` (each ring rank's are partial sums of the same replicated
    parameters), averages them over ``data``, takes the squared global
    norm (split leaves summed over ``model``, replicated ones once, then
    at pp > 1 summed over ``pod``, whose stages hold different leaves;
    at cp > 1 taken once, every ring rank holding the whole gradient),
    applies AdamW with that norm, at dp > 1 to this replica's ZeRO-1
    slice of the state, the parameters all-gathered over ``data`` after,
    and reports the loss on every rank (summed over ``pod``, where only
    the last stage holds it or each ring rank its part, then averaged
    over ``data``; every model rank holds the same loss).
    ``peak_inflight`` is the most microbatches (chunk microbatches under
    interleaving) whose activations this rank held at once.  With
    ``clock`` set (``telemetry.OpClock``, at pp > 1) each F and B op is
    bracketed by its marks, and the step's span runs from before the
    first boundary to the end of the last op's sends."""

    def __init__(self, cfg: ModelConfig, plan: ParallelPlan, grid: RankGrid,
                 opt_cfg: Optional[adamw.AdamWConfig] = None):
        check_rank_plan(cfg, plan)
        if (grid.pp, grid.cp, grid.cp * grid.dp, grid.tp) != (
                plan.pp, plan.cp, plan.dps[0], plan.tps[0]):
            raise ValueError(f"the rank grid (pp {grid.pp}, cp {grid.cp}, "
                             f"dp {grid.dp}, tp {grid.tp}) does not hold "
                             f"plan {plan.describe()}")
        self.cfg, self.plan, self.grid = cfg, plan, grid
        self.opt_cfg = opt_cfg or adamw.AdamWConfig()
        self.m = plan.micro_batches
        self.stage = grid.stage
        # each chunk's (first layer, layer count) in the rank's own stacks
        own = [n for _, n in _chunks(plan.virtual_layers, grid.stage,
                                     plan.vpp)]
        self.chunks = [(sum(own[:c]), n) for c, n in enumerate(own)]
        self.n_layers = sum(own)
        self.pod = Communicator("pod", plan.transport)
        self.data = Communicator("data", plan.transport)
        self.model = (Communicator("model", plan.transport) if grid.tp > 1
                      else None)
        self.rules = ShardingRules(cfg, tp=grid.tp)
        self.async_sends = plan.schedule == "1f1b-eager"
        self.peak_inflight = 0
        self.clock = None
        self.last_aux = None    # this rank's aux sum / m of the last step
        self._block = block_fn(cfg, self.model)
        self.order: Optional[List[Op]] = None
        self.boundaries = None
        if plan.pp == 1:
            self._loss = (context.make_cp_rank_loss_fn(
                cfg, plan.cp_chunk_sizes, grid.ring, self.pod, self.model)
                if plan.cp > 1 else make_loss_fn(bundle_for(cfg), self.model))
            return
        self.order = rank_schedule(grid.stage, plan.pp, self.m,
                                   plan.schedule, plan.eager_slack, plan.vpp)
        self.boundaries = rank_boundaries(grid.stage, plan.pp, self.m,
                                          plan.schedule, plan.eager_slack,
                                          plan.vpp)
        if cfg.remat:
            # a process's first checkpoint call imports torch._dynamo (~6 s
            # on the card's host), and stage s + 1's first forward waits on
            # stage s's: imported here, the ranks pay it at once, not in turn
            import torch._dynamo  # noqa: F401

    def _exchange(self, batch: Sequence[Hop], outbox: Dict[Msg, Any],
                  inbox: Dict[Msg, Any], like: torch.Tensor,
                  later: List[Any]) -> None:
        """One boundary: the batch's sends (from ``outbox``) and receives
        (into ``inbox``) posted at once over ``pod``, in the batch's
        order, and waited for; under ``1f1b-eager`` an activation's send
        is left to complete in the background (its work goes to
        ``later``)."""
        if not batch:
            return
        ops = [(op, peer, outbox.pop(msg) if op == "send" else like)
               for op, peer, msg in batch]
        defer = self.async_sends and all(
            msg[0] == "F" for op, _, msg in batch if op == "send")
        got = iter(self.pod._isend_irecv_batch(ops, later if defer else None))
        for op, _, msg in batch:
            if op == "recv":
                inbox[msg] = next(got)

    def _run_layers(self, layers, x: torch.Tensor):
        return run_blocks(layers, x, self._block, self.cfg.remat)

    def _whole_grads(self, grads: Dict[str, Any]) -> Dict[str, Any]:
        """Sum over ``model`` the gradients each rank holds in part."""
        if self.model is None:
            return grads
        return map_with_path(
            lambda path, g: (self.model.iallreduce(g)
                             if self.rules.partial_grad(path) else g), grads)

    def loss_and_grads(self, params: Dict[str, Any],
                       batch: Dict[str, torch.Tensor]):
        """(this replica's loss on the last stage, 0 elsewhere; the
        gradients of this rank's parameters)."""
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        if self.plan.pp == 1:
            rows = batch["tokens"].shape[0]
            if rows % self.m:
                raise ValueError(f"the batch holds {rows} rows, not a "
                                 f"multiple of the plan's {self.m} "
                                 f"microbatches")
            return self._accumulated(p, batch, rows // self.m)
        cfg, s, m, pp = self.cfg, self.stage, self.m, self.plan.pp
        V = pp * self.plan.vpp
        tokens, labels = batch["tokens"], batch["labels"]
        extra = batch.get("image_embeds")    # stage 0 prepends them
        if tokens.shape[0] != m:
            raise ValueError(f"the batch holds {tokens.shape[0]} "
                             f"microbatches, the plan {m}")
        leaves = tree_leaves(p)
        views = _layer_views(p["blocks"], self.n_layers)
        layers = [views[a:a + n] for a, n in self.chunks]
        vocab = (vocab_model(_unembed_weight(p, cfg), cfg, self.model)
                 if s == pp - 1 else None)
        like = torch.empty((tokens.shape[1], _seq_total(tokens, extra),
                            cfg.d_model), dtype=cfg.adtype,
                           device=leaves[0].device)
        ce_sum = torch.zeros((), dtype=torch.float32, device=like.device)
        aux_sum = torch.zeros_like(ce_sum)
        saved: Dict[Tuple[int, int], Tuple[torch.Tensor, ...]] = {}

        def forward(c: int, j: int, x: Optional[torch.Tensor]):
            """Chunk c's forward of microbatch j from ``x`` (None: the
            embedding): the activation to send on, or None at V - 1."""
            nonlocal ce_sum, aux_sum
            vs = c * pp + s
            x = _embed(p, tokens[j], cfg, self.model,
                       None if extra is None else extra[j]) if vs == 0 \
                else x.requires_grad_()
            y, aux = self._run_layers(layers[c], x)
            if aux is not None:
                aux_sum = aux_sum + aux.detach()
                # the chunk's part of the loss's AUX_COEF * aux_sum / m
                aux = aux * (AUX_COEF / m)
            out = None
            if vs == V - 1:
                h = rmsnorm(p["final_norm"], y, cfg.norm_eps)
                ce = cross_entropy(_unembed(p, h, cfg, self.model),
                                   labels[j], vocab)
                ce_sum = ce_sum + ce.detach()
                y = ce / m
            else:
                out = y.detach()
            saved[(c, j)] = (x, y, aux)
            self.peak_inflight = max(self.peak_inflight, len(saved))
            return out

        def backward(c: int, j: int, dy: Optional[torch.Tensor]):
            """Chunk c's backward of microbatch j from ``dy`` (None: the
            loss): its input's gradient, or None at virtual stage 0."""
            vs = c * pp + s
            x, y, aux = saved.pop((c, j))
            if aux is not None and aux.requires_grad:
                torch.autograd.backward([y, aux], [dy, None])
            else:
                y.backward(dy)
            return x.grad if vs > 0 else None

        outbox: Dict[Msg, Any] = {}
        inbox: Dict[Msg, Any] = {}
        later: List[Any] = []
        clock = self.clock
        if clock is not None:
            clock.start_step()
        for hops, unit in self.boundaries:
            self._exchange(hops, outbox, inbox, like, later)
            for kind, c, j in unit:
                vs = c * pp + s
                t0 = clock.now() if clock is not None else None
                if kind == "F":
                    y = forward(c, j, inbox.pop(("F", vs, j), None))
                    if y is not None:
                        outbox[("F", vs + 1, j)] = y
                else:
                    dx = backward(c, j, inbox.pop(("B", vs, j), None))
                    if dx is not None:
                        outbox[("B", vs - 1, j)] = dx
                if clock is not None:
                    clock.op((kind, c, j), t0)
        if clock is not None:
            clock.end_step()
        for work, _ in later:
            work.wait()
        grads = tree_map(
            lambda t: torch.zeros_like(t) if t.grad is None else t.grad, p)
        self.last_aux = aux_sum / m
        return (ce_sum + AUX_COEF * aux_sum) / m, self._whole_grads(grads)

    def _accumulated(self, p: Dict[str, Any], batch: Dict[str, torch.Tensor],
                     rows: int):
        """pp 1 over the plan's m microbatches of ``rows`` rows, one at a
        time, each loss's gradient / m added into the leaves' grads (as
        the pipeline's backwards add theirs): the activations of one
        microbatch at a time, the memory the plan was priced at.  A MoE
        aux is each microbatch's, averaged: JAX's pp loss (the reference
        loss takes it over the whole batch, another number at m > 1)."""
        loss_sum = aux_sum = None
        for j in range(self.m):
            mb = {k: v[j * rows:(j + 1) * rows] for k, v in batch.items()}
            loss, metrics = self._loss(p, mb)
            (loss / self.m).backward()
            loss_sum = loss.detach() if loss_sum is None else \
                loss_sum + loss.detach()
            aux = metrics["aux"].detach()
            aux_sum = aux if aux_sum is None else aux_sum + aux
        grads = tree_map(
            lambda t: torch.zeros_like(t) if t.grad is None else t.grad, p)
        self.last_aux = aux_sum / self.m
        return loss_sum / self.m, self._whole_grads(grads)

    def __call__(self, state: Dict[str, Any],
                 batch: Dict[str, torch.Tensor]):
        dp, pp, cp = self.grid.dp, self.plan.pp, self.plan.cp
        params = state["params"]
        loss, grads = self.loss_and_grads(params, batch)
        # in place, so one leaf at a time is doubled
        if cp > 1:
            grads = tree_map(lambda g: g.copy_(self.pod.iallreduce(g)),
                             grads)
        if dp > 1:
            grads = tree_map(
                lambda g: g.copy_(self.data.iallreduce(g)).div_(dp), grads)
        split = map_with_path(
            lambda path, g: self.rules.split_dim(path, g.dim()) is not None,
            grads)
        sq = adamw.model_sq_norm(grads, split, self.model)
        gnorm = torch.sqrt(self.pod.iallreduce(sq) if pp > 1 else sq)
        params, opt, om = adamw.adamw_update(
            params, grads, state["opt"], self.opt_cfg, grad_norm=gnorm,
            data=self.data if dp > 1 else None,
            zero=_zero(params, self.rules, dp))
        aux = self.last_aux
        if pp > 1 or cp > 1:
            loss = self.pod.iallreduce(loss)
            if pp > 1 and self.cfg.n_experts:
                aux = self.pod.iallreduce(aux)
        if dp > 1:
            loss = self.data.iallreduce(loss) / dp
        metrics = {"ce": loss - AUX_COEF * aux, "aux": aux, "loss": loss,
                   **om}
        return {"params": params, "opt": opt,
                "step": state["step"] + 1}, metrics
