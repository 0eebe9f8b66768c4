"""RG-LRU recurrent block (port of ``repro/models/griffin.py``),
recurrentgemma-9b's hybrid stack: two recurrent blocks to one local
attention block.  The recurrence is diagonal, per channel:

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
    a_t = exp(-c * softplus(Lambda) * sigmoid(r_t))

The JAX package has no kernel here: it runs ``jax.lax.associative_scan``,
and the port runs the same scan in plain torch, fp32 (``rglru_scan``):
Hillis-Steele over S, ceil(log2 S) levels of whole-tensor ops with JAX's
combine, so a prefill or a training forward launches a few dozen kernels
a block and never loops over S in Python; autograd differentiates it.
Decode is the O(1) recurrence, updating the state and the conv tail in
place, as ``mamba.mamba_decode`` does.

Where bf16 rounds, as in JAX: ``u = x @ in_x`` is rounded to the
activation dtype (JAX's ``.astype(x.dtype)``); the gate branch and both
gate products stay fp32 (``preferred_element_type=float32``): exact
products of the bf16 operands summed in fp32 (``_mm_f32``); ``gelu`` is
``jax.nn.gelu``'s tanh form.

Parameters are stacked on a leading dim (``init_rglru_block(..., n)``),
as JAX's ``vmap``-ed group init stacks them; ``lam`` is fp32 whatever
the parameter dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _he_stacked
from repro_torch.models.mamba import _causal_conv

_C = 8.0


def init_rglru_block(gen: torch.Generator, cfg: ModelConfig, n: int) -> dict:
    D, W, K = cfg.d_model, cfg.lru_width_, cfg.ssm_conv
    dev, dt = gen.device, cfg.pdtype
    return {
        "in_x": _he_stacked(gen, n, (D, W), dt),
        "in_gate": _he_stacked(gen, n, (D, W), dt),
        "conv_w": _he_stacked(gen, n, (K, W), dt),          # fan-in K
        "conv_b": torch.zeros((n, W), dtype=dt, device=dev),
        "w_input_gate": _he_stacked(gen, n, (W, W), dt),
        "w_rec_gate": _he_stacked(gen, n, (W, W), dt),
        "lam": torch.full((n, W), 0.65, dtype=torch.float32, device=dev),
        "out": _he_stacked(gen, n, (W, D), dt),
    }


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with an fp32 result (JAX's preferred_element_type=float32).
    bf16 operands on the card without a gradient to take (serving) go
    to cuBLAS's bf16 product with fp32 output (``torch.mm(...,
    out_dtype=torch.float32)``, which has no derivative); otherwise fp32
    upcasts: bf16 operands multiply exactly and sum in fp32 either way
    (``chip_smoke.py`` times both)."""
    if (x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16
            and x.is_cuda and not (torch.is_grad_enabled()
                                   and (x.requires_grad or w.requires_grad))):
        out = torch.mm(x.reshape(-1, x.shape[-1]), w,
                       out_dtype=torch.float32)
        return out.view(*x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()


def _gates(p: dict, u: torch.Tensor):
    """u: (B,S,W) post-conv -> (input gate, log a), both (B,S,W) fp32."""
    i_g = torch.sigmoid(_mm_f32(u, p["w_input_gate"]))
    r_g = torch.sigmoid(_mm_f32(u, p["w_rec_gate"]))
    log_a = -_C * F.softplus(p["lam"]) * r_g
    return i_g, log_a


def rglru_scan(x: torch.Tensor, i_g: torch.Tensor,
               log_a: torch.Tensor) -> torch.Tensor:
    """x, i_g, log_a: (B,S,W) -> (B,S,W) hidden states, fp32.  A
    Hillis-Steele scan over S with JAX's combine ``(la1 + la2,
    exp(la2) b1 + b2)``: level d combines every position t >= d with
    t - d."""
    a2 = torch.exp(2.0 * log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a2, min=1e-9))
    h = beta * i_g * x.float()
    la = log_a
    S, d = h.shape[1], 1
    while d < S:
        h = torch.cat([h[:, :d], torch.exp(la[:, d:]) * h[:, :-d] + h[:, d:]],
                      dim=1)
        if 2 * d < S:       # the last level's la is not read
            la = torch.cat([la[:, :d], la[:, :-d] + la[:, d:]], dim=1)
        d *= 2
    return h


def rglru_block(p: dict, x: torch.Tensor, cfg: ModelConfig,
                return_state: bool = False):
    """x: (B,S,D) -> (B,S,D) (training / prefill); with ``return_state``
    also the decode state after the last position: (out, h (B,W) fp32,
    conv tail (B,K-1,W)), JAX's ``transformer._rglru_prefill_state``."""
    u = x @ p["in_x"]
    gate = _mm_f32(x, p["in_gate"])
    u, conv_tail = _causal_conv(u, p["conv_w"], p["conv_b"])
    i_g, log_a = _gates(p, u)
    hs = rglru_scan(u, i_g, log_a)
    y = (hs * F.gelu(gate, approximate="tanh")).to(x.dtype)
    out = y @ p["out"]
    return (out, hs[:, -1], conv_tail) if return_state else out


def init_rglru_state(cfg: ModelConfig, batch: int, n_layers: int,
                     device) -> dict:
    W, K = cfg.lru_width_, cfg.ssm_conv
    return {"h": torch.zeros((n_layers, batch, W), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((n_layers, batch, K - 1, W),
                                dtype=cfg.adtype, device=device)}


def rglru_decode(p: dict, x: torch.Tensor, h: torch.Tensor,
                 conv_state: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One-step recurrence.  x: (B,1,D); h: (B,W) and conv_state:
    (B,K-1,W) are updated IN PLACE (views into the layer-stacked state).
    Returns out (B,1,D)."""
    u = x @ p["in_x"]
    gate = _mm_f32(x, p["in_gate"])
    u, new_conv = _causal_conv(u, p["conv_w"], p["conv_b"], conv_state)
    conv_state.copy_(new_conv)
    i_g, log_a = _gates(p, u)
    a = torch.exp(log_a[:, 0])
    beta = torch.sqrt(torch.clamp(1.0 - torch.square(a), min=1e-9))
    h.mul_(a).add_(beta * i_g[:, 0] * u[:, 0].float())
    y = (h[:, None] * F.gelu(gate, approximate="tanh")).to(x.dtype)
    return y @ p["out"]
