"""Tensor parallelism's autograd operators over the ``model`` axis.

The JAX package leaves them to GSPMD: from the sharding rules
(``parallel/sharding.py``) it inserts an all-reduce after each
row-parallel product and one on the gradient of each column-parallel
product's input.  The port's model ranks run them as Megatron does, each
a ``torch.autograd.Function`` over the ``model`` ``Communicator`` (so the
ICCL tap notes every collective):

  * ``copy_to_model``: identity forward, all-reduce of the gradient
    backward; before each column-parallel product (``wq``/``wk``/``wv``,
    ``w_gate``/``w_up``, the vocab-split unembedding), whose input every
    rank holds whole while each rank's gradient of it is a part;
  * ``reduce_from_model``: all-reduce forward, identity backward; after
    each row-parallel product (``wo``, ``w_down``), whose outputs are
    partial sums.  Every rank then holds the same activation, and the
    loss downstream is the same on every rank, so each takes the whole
    gradient as its own;
  * ``vocab_parallel_embed``: rank r holds rows ``[r V/tp, (r+1) V/tp)``
    of the table, zeroes the lookups it does not own, then reduces;
  * ``vocab_parallel_lse_gold``: the cross-entropy's log-sum-exp and gold
    logit over vocab-split logits.  The per-row max is a constant: an
    ``iallgather`` of each rank's max, then a max taken locally (the
    ``Communicator`` has no max reduction).  The sum of exp and the gold
    logit, which only the rank owning the label holds, are reduced in one
    ``iallreduce``.  With them ``train.steps.cross_entropy`` equals itself
    on the gathered logits.

Every collective takes the communicator it is given; None (tp 1, or a
part the rules replicate) makes each operator the identity or the plain
lookup.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.iccl.communicator import Communicator


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.iallreduce(g.contiguous()), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        return comm.iallreduce(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor,
                  comm: Optional[Communicator]) -> torch.Tensor:
    return x if comm is None else _CopyToModel.apply(x, comm)


def reduce_from_model(x: torch.Tensor,
                      comm: Optional[Communicator]) -> torch.Tensor:
    return x if comm is None else _ReduceFromModel.apply(x, comm)


def _owned(ids: torch.Tensor, n_local: int,
           comm: Communicator) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids local to this rank's slice of n_local rows, clamped into it;
    which ids the slice owns)."""
    local = ids.long() - comm.index() * n_local
    own = (local >= 0) & (local < n_local)
    return local.clamp(0, n_local - 1), own


def vocab_parallel_embed(table: torch.Tensor, tokens: torch.Tensor,
                         dtype: torch.dtype,
                         comm: Communicator) -> torch.Tensor:
    """``table`` is this rank's (V / tp, D) rows: the lookup of
    ``tokens``, whole on every rank (one rank adds each row, the others
    zeros, so the reduction is exact)."""
    local, own = _owned(tokens, table.shape[0], comm)
    x = torch.nn.functional.embedding(local, table).to(dtype).masked_fill(
        ~own[..., None], 0)     # a lookup: see ``transformer._embed``
    return reduce_from_model(x, comm)


def vocab_parallel_lse_gold(logits: torch.Tensor, labels: torch.Tensor,
                            comm: Communicator):
    """(lse, gold) of (..., V / tp) fp32 logits, this rank's vocab slice:
    the same rows on every rank."""
    logits = logits.float()
    m_local = logits.detach().amax(dim=-1)
    m = comm.iallgather(m_local, axis=0, tiled=False).amax(dim=0)
    sumexp = torch.exp(logits - m[..., None]).sum(dim=-1)
    local, own = _owned(labels, logits.shape[-1], comm)
    gold = torch.gather(logits, -1, local[..., None])[..., 0]
    sumexp, gold = reduce_from_model(
        torch.stack([sumexp, gold.masked_fill(~own, 0)]), comm).unbind(0)
    return m + torch.log(sumexp), gold
