"""The loss and the train step (port of ``repro/train/steps.py``).

``make_loss_fn`` is the reference loss: the full forward, fp32 logits,
cross-entropy with z-loss, plus ``AUX_COEF`` times the model's auxiliary
loss; with ``cfg.loss_chunk`` the unembed and the CE run over sequence
chunks so the (B, S, V) logits never exist at once (each chunk is
recomputed in the backward when ``cfg.remat``).  ``make_train_step``
differentiates any such loss (the cp ring's too) and applies AdamW, with
optional gradient accumulation over microbatches.

On one card the gold logit is a gather: JAX's one-hot product
(``repro/train/steps.py:38-39``) exists to keep a vocab-sharded gather out
of GSPMD and would add a (B, S, V) tensor here; it is the same function
with the same gradient.  On a tensor-parallel rank (``model``, a
``Communicator`` over the model axis) the loss runs the rank's shares of
the blocks and its vocab slice of the logits, and the CE's log-sum-exp
and gold logit are reduced over the ranks
(``parallel/tensor.vocab_parallel_lse_gold``): every rank gets the loss
of the whole model.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.iccl.communicator import Communicator
from repro_torch.models import transformer
from repro_torch.models.registry import ArchBundle
from repro_torch.optim import adamw
from repro_torch.parallel import tensor

AUX_COEF = 0.01
Z_COEF = 1e-4

LossFn = Callable[[Any, Dict[str, torch.Tensor]], Any]


def _lse_gold(logits: torch.Tensor, labels: torch.Tensor,
              model: Optional[Communicator] = None):
    """``model``: the communicator over whose ranks the logits' vocab is
    split (None: whole logits)."""
    if model is not None:
        return tensor.vocab_parallel_lse_gold(logits, labels, model)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return lse, gold


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  model: Optional[Communicator] = None) -> torch.Tensor:
    """Stable mean CE over (..., V) fp32 logits, plus the z-loss
    ``Z_COEF * mean(lse^2)``."""
    lse, gold = _lse_gold(logits, labels, model)
    return torch.mean(lse - gold) + Z_COEF * torch.mean(torch.square(lse))


def with_aux(ce: torch.Tensor, aux: torch.Tensor):
    """(loss, metrics) of a CE and the model's auxiliary loss: the tail of
    every loss here and of the cp ring's."""
    return ce + AUX_COEF * aux, {"ce": ce, "aux": aux}


def _ce_sums(logits: torch.Tensor, labels: torch.Tensor,
             model: Optional[Communicator] = None):
    """(sum of (lse - gold), sum of lse^2, count): chunk-combinable."""
    lse, gold = _lse_gold(logits, labels, model)
    return torch.sum(lse - gold), torch.sum(torch.square(lse)), lse.numel()


def make_loss_fn(bundle: ArchBundle,
                 model: Optional[Communicator] = None) -> LossFn:
    """The reference loss; ``model``: this rank's tensor-parallel
    communicator, its ``params`` the rank's shard
    (``parallel/sharding.shard_tree``).  The enc-dec family takes its
    whole forward (``frames`` and ``tokens``) and no ``loss_chunk``, as
    in JAX; the VLM's ``image_embeds`` are prepended and its labels cover
    the image positions too."""
    cfg = bundle.cfg
    if cfg.family == "encdec":
        if model is not None:
            transformer.check_tp_supported(cfg)

        def encdec_loss(params, batch):
            logits, aux = bundle.forward(params, batch, cfg)
            return with_aux(cross_entropy(logits, batch["labels"]), aux)

        return encdec_loss

    def loss_fn(params, batch):
        feats, w, aux = transformer.lm_features(
            params, batch["tokens"], cfg, model,
            extra_embeds=batch.get("image_embeds"))
        vocab = transformer.vocab_model(w, cfg, model)
        feats = tensor.copy_to_model(feats, vocab)
        if cfg.loss_chunk:
            labels = batch["labels"]
            S = feats.shape[1]
            c = min(cfg.loss_chunk, S)
            n = S // c             # as JAX: a tail shorter than c is dropped

            def body(f, lab):
                ce, z, _ = _ce_sums((f @ w).float(), lab, vocab)
                return ce, z

            s_ce = s_z = torch.zeros((), device=feats.device)
            for i in range(n):
                f, lab = feats[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
                ce, z = (checkpoint(body, f, lab, use_reentrant=False)
                         if cfg.remat else body(f, lab))
                s_ce, s_z = s_ce + ce, s_z + z
            cnt = feats.shape[0] * n * c
            return with_aux(s_ce / cnt + Z_COEF * (s_z / cnt), aux)
        logits = (feats @ w).float()
        return with_aux(cross_entropy(logits, batch["labels"], vocab), aux)

    return loss_fn


def _or_zeros(g: Optional[torch.Tensor], p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p) if g is None else g


def make_train_step(bundle: ArchBundle,
                    opt_cfg: Optional[adamw.AdamWConfig] = None,
                    grad_accum: int = 1, loss_fn: Optional[LossFn] = None):
    """Returns train_step(state, batch) -> (state, metrics).

    ``grad_accum > 1`` splits the batch into microbatches whose fp32
    gradients are summed and averaged.  A custom ``loss_fn`` (the cp ring)
    replaces the reference loss.  The state is updated in place (AdamW)
    and returned."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    loss_fn = loss_fn or make_loss_fn(bundle)

    def grads_of(params, batch):
        leaves = adamw.tree_leaves(params)
        loss, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        it = iter(grads)
        # a parameter the loss does not read gets a zero gradient, as in JAX
        return loss.detach(), metrics, adamw.tree_map(
            lambda p: _or_zeros(next(it), p), params)

    def train_step(state, batch):
        params = adamw.tree_map(lambda p: p.detach().requires_grad_(),
                                state["params"])
        if grad_accum == 1:
            loss, metrics, grads = grads_of(params, batch)
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            micro = {k: v.reshape(grad_accum, v.shape[0] // grad_accum,
                                  *v.shape[1:]) for k, v in batch.items()}
            grads = adamw.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
            loss = torch.zeros((), device=adamw.tree_leaves(params)[0].device)
            for i in range(grad_accum):
                l, _, g = grads_of(params, {k: v[i] for k, v in micro.items()})
                grads = adamw.tree_map(torch.add, grads, g)
                loss = loss + l
            grads = adamw.tree_map(lambda g: g / grad_accum, grads)
            loss = loss / grad_accum
            metrics = {"ce": loss, "aux": torch.zeros_like(loss)}
        params = adamw.tree_map(lambda p: p.detach(), params)
        new_params, new_opt, om = adamw.adamw_update(
            params, grads, state["opt"], opt_cfg)
        metrics = dict(metrics, loss=loss, **om)
        return {"params": new_params, "opt": new_opt,
                "step": state["step"] + 1}, metrics

    return train_step


def init_train_state(bundle: ArchBundle, seed: int = 0,
                     device=None) -> Dict[str, Any]:
    params = bundle.init(bundle.cfg, seed=seed, device=device)
    keep_master = bundle.cfg.param_dtype != "float32"
    first = adamw.tree_leaves(params)[0]
    return {"params": params,
            "opt": adamw.init_opt_state(params, keep_master=keep_master),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def train_state_shapes(bundle: ArchBundle) -> Dict[str, Any]:
    """``init_train_state``'s tree as ``meta`` tensors (shapes and dtypes,
    no storage), traced through the init under fake tensors: the whole
    state's leaves that a rank of a plan does not hold."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        state = init_train_state(bundle, device="cpu")
    return adamw.tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), state)
