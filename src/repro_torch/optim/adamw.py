"""AdamW with fp32 master weights (port of ``repro/optim/adamw.py``).

The state is ``{master?, m, v, count}`` over the parameter tree (nested
dicts of tensors): master weights exist only when the parameters are low
precision (bf16); the moments are always fp32.  The arithmetic is the JAX
package's, term for term, in fp32: global-norm clipping, linear warmup,
bias correction, decoupled weight decay on the master.  Unlike JAX the
update is in place: it returns the trees it was given, updated leaf by
leaf, so its scratch is a few fp32 copies of the largest leaf (the
embedding), not a second copy of the state.  A caller that must keep the
state it started from copies it first (``Trainer`` does).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts of tensors (same keys)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def init_opt_state(params: Any, keep_master: bool = True) -> Dict[str, Any]:
    def f32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    first = tree_leaves(params)[0]
    state = {"m": tree_map(f32, params), "v": tree_map(f32, params),
             "count": torch.zeros((), dtype=torch.int32,
                                  device=first.device)}
    if keep_master:
        state["master"] = tree_map(lambda p: p.detach().float().clone(),
                                   params)
    return state


def _schedule(cfg: AdamWConfig, count: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(count.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def _sq_sum(leaves) -> torch.Tensor:
    return sum(torch.sum(torch.square(x.float())) for x in leaves)


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(_sq_sum(tree_leaves(tree)))


def model_sq_norm(grads: Any, split: Any, model) -> torch.Tensor:
    """The squared global norm of the model from one tensor-parallel
    rank's gradients: the squares of the leaves ``split`` marks (a tree of
    bools: the sharding rules split them over the ranks) summed over
    ``model`` (a ``Communicator``), the replicated leaves, equal on every
    rank, counted once.  With ``model`` None every leaf is the rank's
    own (``split`` is not read)."""
    if model is None:
        return _sq_sum(tree_leaves(grads))
    pairs = list(zip(tree_leaves(grads), tree_leaves(split)))
    mine = _sq_sum([g for g, s in pairs if s])
    if not torch.is_tensor(mine):       # no split leaf on this rank
        mine = torch.zeros((), dtype=torch.float32,
                           device=tree_leaves(grads)[0].device)
    return model.iallreduce(mine) + _sq_sum(g for g, s in pairs if not s)


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: Dict[str, Any],
                 cfg: AdamWConfig, grad_norm: Optional[torch.Tensor] = None,
                 data=None, zero: Any = None):
    """Returns (new_params, new_state, metrics) as the JAX function does,
    but updates IN PLACE: the returned trees hold the tensors of
    ``params`` and ``state``, so the update needs no second copy of the
    fp32 state (30 GB for llama3-8b at 4 layers).  Each in-place op rounds
    as the JAX expression it replaces.  ``grad_norm`` is the global norm
    for clipping when ``grads`` hold only part of the model (a pipeline
    rank's stage, its norm summed over the stages' ranks); None takes it
    from ``grads``.

    ZeRO-1: with ``data`` (a ``Communicator`` over the replicas) and
    ``zero`` (``sharding.zero_dims`` of ``params``), ``state``'s m, v and
    master hold this replica's slice of each leaf whose dim is not None.
    The replica updates only that slice, from the same slice of the
    (whole, averaged) gradient, writes it into its view of the parameter
    and all-gathers the slices over ``data`` into the whole parameter.
    The arithmetic is elementwise, so the result is the unsharded
    update's bit for bit."""
    count = state["count"] + 1
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = _schedule(cfg, count)
    cf = count.float()
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, device=cf.device), cf)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, device=cf.device), cf)
    keep_master = "master" in state
    if zero is None or data is None:
        zero = tree_map(lambda _: None, params)

    def upd(p, g, m, v, master, d):
        mine = p
        if d is not None:   # this replica's slice: views of p and g
            i, n = data.index(), data.size()
            mine, g = p.chunk(n, d)[i], g.chunk(n, d)[i]
        if not keep_master:
            master = mine
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        step = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        master.sub_(lr * (step + cfg.weight_decay * master))
        if master is not mine:
            mine.copy_(master)
        if d is not None:
            p.copy_(data.iallgather(mine, axis=d))

    tree_map(upd, params, grads, state["m"], state["v"],
             state["master"] if keep_master else params, zero)
    state["count"] = count
    return params, state, {"grad_norm": gnorm, "lr": lr}
