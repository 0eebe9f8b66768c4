"""Model configuration (port of ``repro/models/config.py``).

The same dataclass, field for field, so a config built for the JAX package
reads the same here.  ``pdtype``/``adtype`` return torch dtypes.  Fields the
port does not use yet (MoE, SSM, hybrid, enc-dec, sharding hints) are kept
so configs round-trip; the model code raises on the ones it cannot serve.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; "
                         f"expected one of {sorted(_DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # --- attention options ---
    qk_norm: bool = False
    window: Optional[int] = None           # sliding-window size (SWA) or None
    rope_theta: float = 10000.0
    attn_logit_softcap: Optional[float] = None

    # --- MLP ---
    act: str = "swiglu"                    # swiglu | sq_relu | gelu | geglu

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # --- SSM (mamba-1) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0                       # 0 -> ceil(d_model / 16)

    # --- hybrid (recurrentgemma): block pattern, cycled over layers ---
    block_pattern: Tuple[str, ...] = ()
    lru_width: int = 0                     # 0 -> d_model

    # --- enc-dec (whisper) ---
    n_encoder_layers: int = 0

    # --- VLM ---
    n_vision_tokens: int = 0

    # --- numerics / implementation ---
    param_dtype: str = "bfloat16"
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    attn_chunk: int = 0     # moot here: the flash kernel never builds scores
    remat: bool = True
    remat_policy: str = ""
    moe_impl: str = "gspmd"
    loss_chunk: int = 0
    scan_layers: bool = True
    cache_update: str = "dus"
    act_sharding: tuple = ()
    mesh_axes: tuple = ()
    head_act_sharding: tuple = ()

    # ---- derived ----
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    @property
    def lru_width_(self) -> int:
        return self.lru_width or self.d_model

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def adtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind, resolving the hybrid pattern."""
        if self.family == "ssm":
            return ("ssm",) * self.num_layers
        if self.family == "hybrid":
            pat = self.block_pattern or ("rec", "rec", "attn")
            return tuple(pat[i % len(pat)] for i in range(self.num_layers))
        return ("attn",) * self.num_layers

    # ---- parameter counting (for 6*N*D roofline yardstick) ----
    def param_count(self, active_only: bool = False) -> int:
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        H, Hk, hd = self.n_heads, self.n_kv_heads, self.hd
        emb = V * D * (1 if self.tie_embeddings else 2)
        kinds = self.layer_kinds()

        def attn_p() -> int:
            return D * H * hd + 2 * D * Hk * hd + H * hd * D

        def mlp_p() -> int:
            mats = 3 if self.act in ("swiglu", "geglu") else 2
            if self.n_experts:
                e = self.top_k if active_only else self.n_experts
                return e * mats * D * F + D * self.n_experts  # + router
            return mats * D * F

        def ssm_p() -> int:
            di, ds, dr = self.d_inner, self.ssm_state, self.dt_rank_
            return (D * 2 * di + di * self.ssm_conv + di * (dr + 2 * ds)
                    + dr * di + di * ds + di + di * D)

        def rec_p() -> int:
            w = self.lru_width_
            return 2 * D * w + w * self.ssm_conv + 3 * w + w * D

        total = emb
        for k in kinds:
            total += 2 * D  # norms
            if k == "attn":
                total += attn_p() + mlp_p()
            elif k == "ssm":
                total += ssm_p()
            elif k == "rec":
                total += rec_p() + mlp_p()
        if self.family == "encdec":
            total += self.n_encoder_layers * (attn_p() + mlp_p() + 2 * D)
            total += self.num_layers * (attn_p() + D)
        return total

    def flops_per_token(self, seq_len: int, active_only: bool = True) -> float:
        """Model FLOPs per token (fwd): 2*N_active*1tok + attention term."""
        fl = 2.0 * self.param_count(active_only=active_only)
        for k in self.layer_kinds():
            if k == "attn":
                kv = min(seq_len, self.window) if self.window else seq_len
                fl += 2 * 2 * self.n_heads * self.hd * kv
        return fl
