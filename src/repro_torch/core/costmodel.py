"""Per-layer/per-stage analytic cost model — the 'automatic profiling' input
to the distributed performance predictor (paper §3.2).

The port's copy of ``repro/core/costmodel.py``: the same arithmetic in the
same order, held exactly equal to it by ``tests/test_torch_planner.py``.

On the real system these weights come from profiling a small sample cluster;
here they are derived analytically from ModelConfig (and can be calibrated
from the dry-run's compiled cost_analysis via ``calibrate()``).

All times in seconds, sizes in bytes, rates given in Gb/s (networks) or
TFLOP/s (compute).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, Tuple, runtime_checkable

from repro_torch.models.config import ModelConfig

BYTES_ACT = 2  # bf16 activations


@dataclasses.dataclass(frozen=True)
class LayerCost:
    flops_fwd: float      # per token
    param_bytes: float
    act_bytes_per_token: float  # stored activations (1F1B in-flight memory)


def layer_cost(cfg: ModelConfig, seq_len: int) -> LayerCost:
    """Cost of ONE transformer layer (mean over kinds for hybrid)."""
    D, F = cfg.d_model, cfg.d_ff
    H, Hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    kinds = cfg.layer_kinds()

    def one(kind: str):
        if kind == "attn":
            proj = 2.0 * D * (H * hd + 2 * Hk * hd + H * hd)
            kv = min(seq_len, cfg.window) if cfg.window else seq_len
            attn = 2.0 * 2 * H * hd * kv
            mats = 3 if cfg.act in ("swiglu", "geglu") else 2
            act_e = cfg.top_k if cfg.n_experts else 1
            mlp = 2.0 * mats * D * F * act_e * (cfg.capacity_factor
                                                if cfg.n_experts else 1.0)
            params = (D * (H + 2 * Hk) * hd + H * hd * D
                      + mats * D * F * (cfg.n_experts or 1))
            acts = (D * 4 + F * act_e)
        elif kind == "ssm":
            di, ds, dr = cfg.d_inner, cfg.ssm_state, cfg.dt_rank_
            mm = 2.0 * (D * 2 * di + di * (dr + 2 * ds) + dr * di + di * D)
            scan = 10.0 * di * ds
            mlp = 0.0
            params = (D * 2 * di + di * (dr + 2 * ds) + dr * di + di * ds
                      + di * D)
            acts = di * 6
            return mm + scan, params, acts
        else:  # rec
            W = cfg.lru_width_
            mm = 2.0 * (2 * D * W + 2 * W * W + W * D)
            mats = 3 if cfg.act in ("swiglu", "geglu") else 2
            mlp = 2.0 * mats * D * F
            params = 2 * D * W + 2 * W * W + W * D + mats * D * F
            acts = W * 5 + D * 2
            return mm + mlp + 10.0 * W, params, acts
        return proj + attn + mlp, params, acts

    tot_f = tot_p = tot_a = 0.0
    for k in kinds:
        f, p, a = one(k)
        tot_f += f
        tot_p += p
        tot_a += a
    n = len(kinds)
    return LayerCost(flops_fwd=tot_f / n,
                     param_bytes=BYTES_ACT * tot_p / n,
                     act_bytes_per_token=BYTES_ACT * tot_a / n)


def embedding_flops(cfg: ModelConfig) -> float:
    """Unembedding matmul per token (embedding gather ~ free)."""
    return 2.0 * cfg.d_model * cfg.vocab_size


def attention_flops_fraction(cfg: ModelConfig, seq_len: int) -> float:
    """Fraction of ``layer_cost`` forward FLOPs that scales with the KV
    length (the score/value einsums) — the ``attn`` weight of the
    context-parallel chunk balancer ``segmentation.cp_split``; the
    remaining ``1 - fraction`` is per-token linear work.  Zero for
    SSM/recurrent layers (no KV-dependent term), so hybrid stacks get the
    attn-layer-weighted mean, consistent with ``layer_cost``'s averaging."""
    H, hd = cfg.n_heads, cfg.hd
    kv = min(seq_len, cfg.window) if cfg.window else seq_len
    attn_one = 2.0 * 2 * H * hd * kv
    kinds = cfg.layer_kinds()
    total = layer_cost(cfg, seq_len).flops_fwd * len(kinds)
    attn_total = attn_one * sum(k == "attn" for k in kinds)
    return attn_total / max(total, 1e-9)


def ring_hop_bytes(cfg: ModelConfig, micro_bs: int, chunk_len: int) -> float:
    """Bytes one context-parallel ring hop carries: the K and V blocks of
    ``chunk_len`` tokens (ragged rings pad every hop to the LARGEST chunk,
    so callers pass max(cp_chunks))."""
    return 2.0 * micro_bs * chunk_len * cfg.n_kv_heads * cfg.hd * BYTES_ACT


def kv_cache_bytes(cfg: ModelConfig, batch: int, max_len: int) -> float:
    """Decode-cache bytes for ``batch`` sequences of up to ``max_len``
    tokens — EXACTLY the registry's real cache allocation
    (``ArchBundle.init_cache(batch, max_len)`` summed over array leaves,
    minus the position index), per arch family:

      attn   2 * min(max_len, window) * n_kv_heads * hd       x adtype
      ssm    d_inner * ssm_state x fp32  +  (K-1) * d_inner   x adtype
      rec    lru_width x fp32            +  (K-1) * lru_width x adtype
      encdec per decoder layer: self-KV (max_len) + cross-KV (max_len)

    tests/test_serve.py locks the equality for every family, so the
    serving-mode ``peak_memory`` / ``require_fit`` stay honest."""
    a = cfg.adtype.itemsize
    if cfg.family == "encdec":
        per = 4.0 * max_len * cfg.n_kv_heads * cfg.hd * a  # self + cross
        return float(batch) * cfg.num_layers * per
    S = min(max_len, cfg.window) if cfg.window else max_len
    per_kind = {
        "attn": 2.0 * S * cfg.n_kv_heads * cfg.hd * a,
        "ssm": (cfg.d_inner * cfg.ssm_state * 4.0
                + (cfg.ssm_conv - 1) * cfg.d_inner * a),
        "rec": (cfg.lru_width_ * 4.0
                + (cfg.ssm_conv - 1) * cfg.lru_width_ * a),
    }
    return float(batch) * sum(per_kind[k] for k in cfg.layer_kinds())


@dataclasses.dataclass(frozen=True)
class CommVolume:
    """Per-microbatch communication volumes in bytes."""
    pp_p2p: float        # inter-stage activation send (paper Eq.3)
    tp_per_layer: float  # all-reduce volume per layer (2x fwd, 2x bwd)
    dp_grads: float      # gradient all-reduce bytes per step per replica


def comm_volume(cfg: ModelConfig, micro_bs: int, seq_len: int,
                layers_in_stage: int, dp: int) -> CommVolume:
    D = cfg.d_model
    pp = float(micro_bs * seq_len * D * 2)  # paper Eq.3: B*L*H*2 (bytes, bf16)
    tp = float(micro_bs * seq_len * D * 2)  # bf16 activation all-reduce volume
    lc = layer_cost(cfg, seq_len)
    grads = lc.param_bytes * layers_in_stage * 2 * (dp - 1) / max(dp, 1)
    return CommVolume(pp_p2p=pp, tp_per_layer=tp, dp_grads=grads)


def calibrate(cfg: ModelConfig, seq_len: int,
              hlo_flops_per_token: Optional[float] = None,
              *, allow_speedup: bool = False) -> float:
    """Measured-vs-analytic FLOPs ratio from the dry-run cost analysis
    (remat/redundancy factor); multiply stage compute times by this.

    ``allow_speedup=False`` clamps the ratio at 1.0 — appropriate when the
    measurement is an HLO FLOP *count*, which can only exceed the analytic
    one (remat, redundancy).  A measured wall-time profile can legitimately
    report ratio < 1 (fused kernels beating the analytic count); pass
    ``allow_speedup=True`` for those sources so the clamp does not silently
    bias the profiled cost model."""
    if not hlo_flops_per_token:
        return 1.0
    analytic = (layer_cost(cfg, seq_len).flops_fwd * cfg.num_layers
                + embedding_flops(cfg)) * 3.0  # fwd+bwd
    ratio = hlo_flops_per_token / analytic
    return ratio if allow_speedup else max(ratio, 1.0)


# ---------------------------------------------------------------------------
# CostSource: the seam between the performance predictor and where its
# numbers come from.  The analytic source below derives everything from
# ModelConfig + ClusterSpec constants;
# repro_torch.profile.model.ProfiledCostModel
# serves measured values from a ProfileStore with per-entry fallback here.
# ---------------------------------------------------------------------------
@runtime_checkable
class CostSource(Protocol):
    """What the distributed performance predictor needs to know."""

    def layer_cost(self, cfg: ModelConfig, seq_len: int) -> LayerCost:
        """Per-layer FLOPs/param/activation costs."""

    def embedding_flops(self, cfg: ModelConfig) -> float:
        """Unembedding matmul FLOPs per token."""

    def comm_volume(self, cfg: ModelConfig, micro_bs: int, seq_len: int,
                    layers_in_stage: int, dp: int) -> CommVolume:
        """Per-microbatch communication volumes in bytes."""

    def link_gbps(self, cluster, ga: int, gb: int,
                  transport: str = "gpu") -> float:
        """Effective Gb/s between node groups ga -> gb."""

    def ring_hop_gbps(self, cluster, group: int) -> float:
        """Effective Gb/s of one context-parallel ring hop (KV-block
        collective-permute) between the ring ranks inside ``group``."""

    def layer_time(self, device_kind: str, cfg: ModelConfig, seq_len: int,
                   micro_bs: int, tp: int) -> Optional[Tuple[float, float]]:
        """Measured (fwd_s, bwd_s) per layer per microbatch on
        ``device_kind``, or None when only derived costs are available
        (the predictor then divides FLOPs by effective TFLOP/s)."""

    def flops_calibrated(self, cfg: ModelConfig, seq_len: int) -> bool:
        """True when layer_cost's FLOPs already embed a measured
        remat/redundancy factor (e.g. HLO-derived): the predictor must then
        skip its scalar ``calibration`` knob or the factor applies twice."""


class MemoizedCostSource:
    """Caches every ``CostSource`` read of an inner source.

    ``planner.search`` scores thousands of leaves whose cost lookups repeat
    the same handful of keys — (device, micro_bs, tp, seq_len) for layer
    times, (arch, seq_len) for layer costs — and a ``ProfiledCostModel``
    read walks the profile store's entry list each time.  Wrapping the
    source once per search makes every leaf after the first O(1) in
    cost-source reads.  Keys use ``cfg.name`` (one search, one frozen
    ModelConfig) and ``id(cluster)`` (one search, one ClusterSpec).
    """

    def __init__(self, inner: CostSource):
        self.inner = inner
        self._cache: dict = {}

    def _memo(self, key, fn):
        try:
            return self._cache[key]
        except KeyError:
            v = self._cache[key] = fn()
            return v

    def layer_cost(self, cfg: ModelConfig, seq_len: int) -> LayerCost:
        return self._memo(("lc", cfg.name, seq_len),
                          lambda: self.inner.layer_cost(cfg, seq_len))

    def embedding_flops(self, cfg: ModelConfig) -> float:
        return self._memo(("emb", cfg.name),
                          lambda: self.inner.embedding_flops(cfg))

    def comm_volume(self, cfg: ModelConfig, micro_bs: int, seq_len: int,
                    layers_in_stage: int, dp: int) -> CommVolume:
        return self._memo(
            ("cv", cfg.name, micro_bs, seq_len, layers_in_stage, dp),
            lambda: self.inner.comm_volume(cfg, micro_bs, seq_len,
                                           layers_in_stage, dp))

    def link_gbps(self, cluster, ga: int, gb: int,
                  transport: str = "gpu") -> float:
        return self._memo(("lk", id(cluster), ga, gb, transport),
                          lambda: self.inner.link_gbps(cluster, ga, gb,
                                                       transport))

    def ring_hop_gbps(self, cluster, group: int) -> float:
        return self._memo(("rh", id(cluster), group),
                          lambda: self.inner.ring_hop_gbps(cluster, group))

    def layer_time(self, device_kind: str, cfg: ModelConfig, seq_len: int,
                   micro_bs: int, tp: int) -> Optional[Tuple[float, float]]:
        return self._memo(
            ("lt", device_kind, cfg.name, seq_len, micro_bs, tp),
            lambda: self.inner.layer_time(device_kind, cfg, seq_len,
                                          micro_bs, tp))

    def flops_calibrated(self, cfg: ModelConfig, seq_len: int) -> bool:
        return self._memo(("fc", cfg.name, seq_len),
                          lambda: self.inner.flops_calibrated(cfg, seq_len))


class AnalyticCostSource:
    """The hand-derived model: module-level functions behind the protocol."""

    def layer_cost(self, cfg: ModelConfig, seq_len: int) -> LayerCost:
        return layer_cost(cfg, seq_len)

    def embedding_flops(self, cfg: ModelConfig) -> float:
        return embedding_flops(cfg)

    def comm_volume(self, cfg: ModelConfig, micro_bs: int, seq_len: int,
                    layers_in_stage: int, dp: int) -> CommVolume:
        return comm_volume(cfg, micro_bs, seq_len, layers_in_stage, dp)

    def link_gbps(self, cluster, ga: int, gb: int,
                  transport: str = "gpu") -> float:
        return cluster.link_gbps(ga, gb, transport)

    def ring_hop_gbps(self, cluster, group: int) -> float:
        # ring ranks live inside one island: the intra-group link speed
        return cluster.link_gbps(group, group)

    def layer_time(self, device_kind: str, cfg: ModelConfig, seq_len: int,
                   micro_bs: int, tp: int) -> Optional[Tuple[float, float]]:
        return None

    def flops_calibrated(self, cfg: ModelConfig, seq_len: int) -> bool:
        return False
