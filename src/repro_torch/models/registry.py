"""Architecture registry (port of ``repro/models/registry.py``).

Every arch id of the JAX registry loads: the dense family
(``llama3-8b``, ``qwen3-14b``, ``nemotron-4-15b``, ``h2o-danube-3-4b``),
the MoE family (``mixtral-8x7b``, ``phi3.5-moe-42b-a6.6b``),
``falcon-mamba-7b``, the hybrid ``recurrentgemma-9b``, the VLM
``phi-3-vision-4.2b`` (the dense stack behind its image embeddings) and
the enc-dec ``whisper-tiny`` (``models/encdec.py``).

Unified batch dict keys, as in JAX:
  tokens        (B, S) int                     all archs
  frames        (B, S_enc, D) float            enc-dec audio stub frontend
  image_embeds  (B, N, D) float                VLM stub frontend (prepended)
  labels        (B, S) int, (B, N + S) VLM     training
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable

from repro_torch.models import encdec, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.utils.device import DeviceLike

ARCH_IDS = (
    "llama3-8b", "qwen3-14b", "nemotron-4-15b", "h2o-danube-3-4b",
    "falcon-mamba-7b", "phi-3-vision-4.2b", "mixtral-8x7b",
    "phi3.5-moe-42b-a6.6b", "recurrentgemma-9b", "whisper-tiny",
)


def check_last_logits(logits, batch: int, vocab: int,
                      where: str = "prefill"):
    """Serving contract: ``prefill`` and ``decode_step`` return
    LAST-position logits of shape (B, V), never the full-sequence (B, S, V)
    that ``forward`` returns (the sampler would argmax over vocab at every
    position and emit position 0's token)."""
    shape = tuple(getattr(logits, "shape", ()))
    if shape != (batch, vocab):
        raise ValueError(
            f"{where} logits must be last-position (batch, vocab) = "
            f"{(batch, vocab)}, got {shape} — full-sequence (B, S, V) "
            f"logits violate the registry serving contract")
    return logits


@dataclasses.dataclass(frozen=True)
class ArchBundle:
    cfg: ModelConfig
    init: Callable[..., Any]          # (cfg, seed=, device=) -> params
    forward: Callable[..., Any]       # (params, batch, cfg) -> (logits, aux)
    # serving contract (check_last_logits): both return (B, V) logits of
    # the LAST position only
    prefill: Callable[..., Any]       # (params, batch, cfg, max_len)
    decode_step: Callable[..., Any]   # (params, token, cache, cfg)

    def init_cache(self, batch: int, max_len: int,
                   device: DeviceLike = None):
        if self.cfg.family == "encdec":   # the cross K/V at s_enc = max_len
            return encdec.encdec_init_cache(self.cfg, batch, max_len,
                                            max_len, device)
        return transformer.init_cache(self.cfg, batch, max_len, device)

    @property
    def subquadratic(self) -> bool:
        """True if long_500k is runnable (SWA window / SSM / hybrid)."""
        c = self.cfg
        if c.family in ("ssm", "hybrid"):
            return True
        return c.window is not None


def _lm_forward(params, batch, cfg):
    return transformer.lm_forward(params, batch["tokens"], cfg,
                                  extra_embeds=batch.get("image_embeds"))


def _lm_prefill(params, batch, cfg, max_len):
    return transformer.lm_prefill(params, batch["tokens"], cfg, max_len,
                                  extra_embeds=batch.get("image_embeds"))


def _ed_forward(params, batch, cfg):
    return encdec.encdec_forward(params, batch["frames"], batch["tokens"],
                                 cfg)


def _ed_prefill(params, batch, cfg, max_len):
    return encdec.encdec_prefill(params, batch["frames"], batch["tokens"],
                                 cfg, max_len)


def bundle_for(cfg: ModelConfig) -> ArchBundle:
    if cfg.family == "encdec":
        encdec.check_encdec(cfg)
        return ArchBundle(cfg, encdec.init_encdec, _ed_forward, _ed_prefill,
                          encdec.encdec_decode_step)
    transformer.check_supported(cfg)
    return ArchBundle(cfg, transformer.init_lm, _lm_forward, _lm_prefill,
                      transformer.lm_decode_step)


def get_config(arch: str, smoke: bool = False, **overrides) -> ModelConfig:
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))
    cfg = mod.SMOKE if smoke else mod.CONFIG
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def get_bundle(arch: str, smoke: bool = False, **overrides) -> ArchBundle:
    return bundle_for(get_config(arch, smoke=smoke, **overrides))
