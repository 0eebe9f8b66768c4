"""Tensor-parallel sharding rules (port of the tp mode of
``repro/parallel/sharding.py``).

Megatron-style tensor parallelism over the ``model`` axis.  The JAX
package states, for every parameter leaf, a ``PartitionSpec`` that GSPMD
then realises; the port's ranks hold their shards themselves, so the same
table here answers "which dim of this leaf is split over ``model``, or
None", with the JAX package's divisibility resolution:

  * attention q/o projections split the head dim iff n_heads % tp == 0,
    else the whole attention is replicated;
  * GQA k/v projections split iff n_kv_heads % tp == 0, else KV is
    replicated across the model ranks (each rank then computes every kv
    head and uses those its own q heads read);
  * MoE expert tensors split the FFN dim, or the expert dim when
    n_experts % tp == 0 and ``ep``;
  * vocab-parallel embedding and unembedding;
  * SSM / RG-LRU inner dims split over ``model``.

A split dim is cut into ``tp`` contiguous slices: model rank r holds slice
r (``shard_tree``; ``gather_trees`` concatenates them back).

ZeRO-1 (``ShardingRules.opt_state_spec`` of the JAX package): wherever
``data`` is wider than 1, the AdamW moments and the fp32 master of each
leaf are split over ``data`` along the first dim that is not the leaf's
tp split dim and whose size the data width divides, or kept whole when
there is none (``zero_dim``; ``zero_dims`` over a rank's tree).  Replica
r holds slice r of ``dp`` contiguous slices (``zero_shard_tree``;
``zero_gather_trees`` joins them).  The fsdp mode stays unported.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import tree_map


def _divisible(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


class ShardingRules:
    """The tp mode of the JAX ``ShardingRules``: ``split_dim(path, ndim)``
    is the dim its ``_leaf_spec`` names ``model`` in, or None."""

    def __init__(self, cfg: ModelConfig, *, tp: int, ep: bool = False):
        self.cfg = cfg
        self.tp = tp
        c = cfg
        self.shard_q = _divisible(c.n_heads, tp)
        self.shard_kv = _divisible(c.n_kv_heads, tp)
        self.shard_ff = _divisible(c.d_ff, tp) and c.d_ff > 0
        self.shard_vocab = _divisible(c.vocab_size, tp)
        self.shard_inner = _divisible(c.d_inner, tp)
        self.shard_lru = _divisible(c.lru_width_, tp)
        self.ep = ep and _divisible(c.n_experts, tp)

    def split_dim(self, path: Tuple[str, ...], ndim: int) -> Optional[int]:
        name = path[-1]
        in_moe = "moe" in path

        def col(ok):    # (..., D_in, D_out): the output dim
            return ndim - 1 if ok else None

        def row(ok):    # (..., D_in, D_out): the input dim
            return ndim - 2 if ok else None

        if name == "embed":
            return 0 if self.shard_vocab else None
        if name == "unembed":
            return 1 if self.shard_vocab else None
        if name == "scale":          # norms
            return None
        if name == "wq":
            return col(self.shard_q)
        if name in ("wk", "wv"):
            return col(self.shard_kv)
        if name == "wo":
            return row(self.shard_q)
        if in_moe and name in ("w_gate", "w_up", "w_down"):
            if self.ep:
                return ndim - 3
            return (col if name != "w_down" else row)(self.shard_ff)
        if name == "router":
            return None
        if name in ("w_gate", "w_up"):
            return col(self.shard_ff)
        if name == "w_down":
            return row(self.shard_ff)
        # ---- mamba ----
        if name in ("in_proj", "dt_proj"):
            return col(self.shard_inner)
        if name in ("conv_w", "conv_b"):
            return col(self.shard_inner or self.shard_lru)
        if name in ("x_proj", "out_proj"):
            return row(self.shard_inner)
        if name in ("dt_bias", "D"):
            return col(self.shard_inner)
        if name == "A_log":
            return row(self.shard_inner)
        # ---- rg-lru ----
        if name in ("in_x", "in_gate", "w_input_gate", "w_rec_gate", "lam"):
            return col(self.shard_lru)
        if name == "out":
            return row(self.shard_lru)
        return None

    def zero_dim(self, path: Tuple[str, ...], shape: Sequence[int],
                 dp: int) -> Optional[int]:
        """The dim ZeRO-1 splits this leaf's moments and master along over
        ``dp`` replicas (where ``opt_state_spec`` names ``data``), or None:
        the first dim other than ``split_dim`` that ``dp`` divides."""
        tp_dim = self.split_dim(path, len(shape))
        for d, n in enumerate(shape):
            if d != tp_dim and _divisible(n, dp):
                return d
        return None

    def partial_grad(self, path: Tuple[str, ...]) -> bool:
        """A replicated leaf whose gradient each model rank holds only in
        part: k/v replicated under split q heads, where each rank's
        gradient covers the kv heads its q heads read; and qk_norm's
        scales under split heads, each rank's covering its own q heads
        and the kv heads they read.  The ranks' sum over ``model`` is the
        gradient (GSPMD's all-reduce in the JAX package)."""
        if not (self.shard_q and self.tp > 1):
            return False
        if path[-1] in ("wk", "wv"):
            return not self.shard_kv
        return len(path) > 1 and path[-2] in ("q_norm", "k_norm")


def map_with_path(fn, tree: Any, prefix: Tuple[str, ...] = ()) -> Any:
    """``fn(path, leaf)`` over nested dicts of tensors."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, prefix + (k,))
                for k, v in tree.items()}
    return fn(prefix, tree)


def shard_tree(tree: Dict[str, Any], rules: ShardingRules,
               model_rank: int) -> Dict[str, Any]:
    """Model rank ``model_rank``'s part of a parameter-shaped tree
    (parameters, a master copy, a moment): slice ``model_rank`` of each
    split dim, cut into ``rules.tp`` contiguous slices, and the replicated
    leaves, each cloned."""
    def cut(path, a):
        d = rules.split_dim(path, a.dim())
        if d is None:
            return a.clone()
        if a.shape[d] % rules.tp:
            raise ValueError(f"{'/'.join(path)} {tuple(a.shape)}: dim {d} "
                             f"does not split over tp {rules.tp}")
        return a.chunk(rules.tp, d)[model_rank].clone()

    return map_with_path(cut, tree)


def gather_trees(trees: Sequence[Dict[str, Any]],
                 rules: ShardingRules) -> Dict[str, Any]:
    """The inverse of ``shard_tree``: the whole tree from the model ranks'
    parts, in model-rank order."""
    def join(path, a):
        leaves = [a] + [_at(t, path) for t in trees[1:]]
        d = rules.split_dim(path, a.dim())
        return a if d is None else torch.cat(leaves, d)

    return map_with_path(join, trees[0])


def zero_dims(tree: Dict[str, Any], rules: ShardingRules,
              dp: int) -> Dict[str, Any]:
    """``rules.zero_dim`` of every leaf of a rank's parameter tree (its
    tp share of its stage): a tree of ints and Nones."""
    return map_with_path(lambda path, a: rules.zero_dim(path, a.shape, dp),
                         tree)


def zero_shard_tree(tree: Dict[str, Any], dims: Dict[str, Any], dp: int,
                    replica: int) -> Dict[str, Any]:
    """Replica ``replica``'s ZeRO-1 part of a parameter-shaped tree: slice
    ``replica`` of ``dp`` contiguous slices along each leaf's dim of
    ``dims`` (``zero_dims``), the leaves with None whole; each cloned."""
    def cut(a, d):
        return a.clone() if d is None else \
            a.chunk(dp, d)[replica].clone()

    return tree_map(cut, tree, dims)


def zero_gather_trees(trees: Sequence[Dict[str, Any]],
                      dims: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of ``zero_shard_tree``: the rank's whole tree from the
    replicas' parts, in replica order."""
    return tree_map(lambda d, *parts: parts[0] if d is None
                    else torch.cat(parts, d), dims, *trees)


def _at(tree: Dict[str, Any], path: Tuple[str, ...]) -> Any:
    for k in path:
        tree = tree[k]
    return tree
