"""ProfiledCostModel: measured costs behind the CostSource protocol.

The port's copy of ``repro/profile/model.py``: the same arithmetic in the
same order, held exactly equal to it by ``tests/test_torch_profile.py``.

Reads a ProfileStore and serves the distributed performance predictor
(paper §3.2's profile-driven path).  Every read falls back *per entry* to
the analytic model when the requested point is missing from the profile, so
a partial sweep still produces a usable cost source — the profile narrows
the gap measurement by measurement instead of gating on completeness.

Ops consumed (written by repro_torch.profile.runner here; the JAX package's
launch/dryrun and Trainer telemetry write the rest):
  layer_cost       {arch, seq_len} -> flops_fwd / param_bytes /
                   act_bytes_per_token    (HLO-derived; device_kind 'hlo')
  embedding_flops  {arch}          -> flops
  layer_step       {arch, seq_len, micro_bs, tp} -> fwd_s / bwd_s
                   (wall-time measured per layer on a real device)
  observed_stage_tick  {arch, seq_len, tp, schedule, stage, pp, vpp,
                   layers, padded_layers, micro_bs} -> tick_s
                   (online per-stage telemetry)
  observed_bubble  {arch, schedule, pp, vpp, m} -> bubble_frac
  link             {scope[, transport]} -> gbps  (measured collectives)
  ring_hop         {scope} -> gbps  (measured KV-block collective-permute:
                   the context-parallel ring hop)

``device_map`` translates ClusterSpec device names to profile device kinds
(profile a small sample of one device type, predict a cluster of them —
the paper's methodology).  ``time_scale`` multiplies profile-served
COMPUTE times for a queried device name (applied before the device_map
translation): the replan path uses it to project a target cluster's
degradation onto the observations — "that kind now runs ``factor``x
slower than the healthy reference" (``ClusterSpec.degrade``).  Telemetry
entries are first normalized back to reference health by their folded
``obs_scale`` (the slowdown they were observed under), so a degradation
the folds already contain is never counted twice.  The analytic fallback
is never scaled: it already reads the degraded spec's effective TFLOPs.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

from repro_torch.core import costmodel
from repro_torch.core.cluster import validate_transport
from repro_torch.models.config import ModelConfig
from repro_torch.profile.store import ProfileStore

# device_kind under which device-independent (HLO-derived) entries live
CALIB_DEVICE = "hlo"

# trust weight of ``provenance: bucketed`` telemetry folds (timer mode
# spreads a whole-step time evenly over ticks, so those entries carry no
# real per-stage skew) relative to exact callback-mode observations
BUCKETED_WEIGHT = 0.25


class ProfiledCostModel:
    def __init__(self, store: ProfileStore,
                 fallback: Optional[costmodel.CostSource] = None,
                 device_map: Optional[Dict[str, str]] = None,
                 time_scale: Optional[Dict[str, float]] = None):
        self.store = store
        self.fallback = fallback or costmodel.AnalyticCostSource()
        self.device_map = dict(device_map or {})
        self.time_scale = dict(time_scale or {})
        self.hits = 0       # profile-served reads (observability: how much
        self.misses = 0     # of a prediction actually rests on measurement)

    @classmethod
    def load(cls, path, fallback=None, device_map=None) -> "ProfiledCostModel":
        return cls(ProfileStore.load(Path(path)), fallback=fallback,
                   device_map=device_map)

    # ------------------------------------------------------------ helpers --
    def _dev(self, name: str) -> str:
        return self.device_map.get(name, name)

    def _scale(self, name: str) -> float:
        """Degradation scale for a queried device NAME (pre-device_map)."""
        return self.time_scale.get(name, 1.0)

    def _interp(self, device_kind: str, op: str, shape: dict,
                field: str) -> Optional[float]:
        v = self.store.interpolate(device_kind, op, shape, field)
        if v is None:
            self.misses += 1
        else:
            self.hits += 1
        return v

    # --------------------------------------------------------- CostSource --
    def layer_cost(self, cfg: ModelConfig, seq_len: int) -> costmodel.LayerCost:
        base = self.fallback.layer_cost(cfg, seq_len)
        shape = {"arch": cfg.name, "seq_len": seq_len}
        f = self._interp(CALIB_DEVICE, "layer_cost", shape, "flops_fwd")
        p = self._interp(CALIB_DEVICE, "layer_cost", shape, "param_bytes")
        a = self._interp(CALIB_DEVICE, "layer_cost", shape,
                         "act_bytes_per_token")
        return costmodel.LayerCost(
            flops_fwd=f if f is not None else base.flops_fwd,
            param_bytes=p if p is not None else base.param_bytes,
            act_bytes_per_token=(a if a is not None
                                 else base.act_bytes_per_token))

    def embedding_flops(self, cfg: ModelConfig) -> float:
        v = self._interp(CALIB_DEVICE, "embedding_flops",
                         {"arch": cfg.name}, "flops")
        return v if v is not None else self.fallback.embedding_flops(cfg)

    def comm_volume(self, cfg: ModelConfig, micro_bs: int, seq_len: int,
                    layers_in_stage: int, dp: int) -> costmodel.CommVolume:
        # Volumes are exact byte counts (paper Eq.3) — the measured quantity
        # is the *bandwidth* they move at, served by link_gbps below.
        return self.fallback.comm_volume(cfg, micro_bs, seq_len,
                                         layers_in_stage, dp)

    def link_gbps(self, cluster, ga: int, gb: int,
                  transport: str = "gpu") -> float:
        validate_transport(transport)
        dev = self._dev(cluster.groups[ga].device.name)
        if ga == gb:
            shape = {"scope": "intra"}
        else:
            shape = {"scope": "inter", "transport": transport}
        v = self._interp(dev, "link", shape, "gbps")
        return v if v is not None else self.fallback.link_gbps(
            cluster, ga, gb, transport)

    def ring_hop_gbps(self, cluster, group: int) -> float:
        """Measured context-parallel ring-hop bandwidth for ``group``'s
        device kind (the ``ring_hop`` entries the collective microbench
        writes from its ppermute case), analytic intra-island link speed
        when unmeasured."""
        dev = self._dev(cluster.groups[group].device.name)
        v = self._interp(dev, "ring_hop", {"scope": "intra"}, "gbps")
        return v if v is not None else self.fallback.ring_hop_gbps(
            cluster, group)

    def flops_calibrated(self, cfg: ModelConfig, seq_len: int) -> bool:
        return self.store.interpolate(
            CALIB_DEVICE, "layer_cost",
            {"arch": cfg.name, "seq_len": seq_len}, "flops_fwd") is not None

    def layer_time(self, device_kind: str, cfg: ModelConfig, seq_len: int,
                   micro_bs: int, tp: int) -> Optional[Tuple[float, float]]:
        dev = self._dev(device_kind)
        sc = self._scale(device_kind)
        shape = {"arch": cfg.name, "seq_len": seq_len,
                 "micro_bs": micro_bs, "tp": tp}
        fwd = self._interp(dev, "layer_step", shape, "fwd_s")
        bwd = self._interp(dev, "layer_step", shape, "bwd_s")
        if fwd is not None and bwd is not None:
            return sc * fwd, sc * bwd
        # online telemetry: per-stage tick observations normalized to
        # per-layer per-sequence FORWARD seconds (padded depth — that is
        # what the slot executes), fwd:bwd split 1:2 as everywhere else
        per_seq = self.stage_tick_per_layer(dev, cfg, seq_len, tp)
        if per_seq is not None:
            fwd_t = per_seq * micro_bs
            return sc * fwd_t, sc * 2.0 * fwd_t
        # online refinement fallback: the Trainer folds whole observed step
        # wall-times as per-layer per-sequence ``observed_layer_step``
        # entries (a step observation cannot separate microbatch sizes).
        # Scale linearly to the queried micro_bs and split fwd:bwd 1:2 —
        # the ratio the analytic model and the microbench runner both use —
        # so replan searches run on observed reality before a dedicated
        # sweep exists.
        shape_ls = {"arch": cfg.name, "seq_len": seq_len, "tp": tp}
        per_seq = self._interp(dev, "observed_layer_step", shape_ls,
                               "per_seq_s")
        if per_seq is not None:
            # normalize by the health the folds were observed under (see
            # stage_tick_per_layer) before applying the target scale
            osc = self.store.interpolate(dev, "observed_layer_step",
                                         shape_ls, "obs_scale")
            step = per_seq / max(osc or 1.0, 1e-12) * micro_bs
            return sc * step / 3.0, sc * 2.0 * step / 3.0
        return self.fallback.layer_time(device_kind, cfg, seq_len,
                                        micro_bs, tp)

    # ------------------------------------------------- telemetry entries --
    def stage_tick_per_layer(self, dev: str, cfg: ModelConfig, seq_len: int,
                             tp: int) -> Optional[float]:
        """n-weighted mean per-layer per-sequence forward seconds over all
        ``observed_stage_tick`` entries matching (device kind, arch,
        seq_len, tp) — any schedule/stage/pp/vpp: every observation is one
        more sample of how fast this device kind runs one (padded) layer.
        Entries folded by timer-mode telemetry (``provenance: bucketed``)
        are down-weighted by ``BUCKETED_WEIGHT``: they bucket whole steps
        and carry no per-stage skew, so an exact callback observation must
        dominate them.

        Serves the REFERENCE-HEALTHY time: each entry's tick mean is
        divided by its folded ``obs_scale`` (the slowdown — injected or
        real — the observations were taken under; the telemetry's
        ``fold_into``), so ``time_scale`` can project a target cluster's
        degradation onto it exactly once — never compounding with a
        slowdown already baked into the folds.  Returns None when no
        telemetry exists for the pair (the caller falls down the serving
        hierarchy)."""
        num = den = 0.0
        for e in self.store.entries(dev, "observed_stage_tick"):
            s = e.shape
            if (s.get("arch") != cfg.name or s.get("seq_len") != seq_len
                    or s.get("tp") != tp or "tick_s" not in e.value):
                continue
            depth = s.get("padded_layers") or s.get("layers") or 0
            mbs = s.get("micro_bs", 0)
            if depth <= 0 or mbs <= 0:
                continue
            n = e.value.get("n", 1.0)
            if e.meta.get("provenance") == "bucketed":
                n *= BUCKETED_WEIGHT
            healthy = e.value["tick_s"] / max(e.value.get("obs_scale", 1.0),
                                              1e-12)
            num += n * healthy / (depth * mbs)
            den += n
        if den <= 0.0:
            self.misses += 1
            return None
        self.hits += 1
        return num / den

    def observed_bubble(self, device_kind: str, cfg: ModelConfig,
                        schedule: str, pp: int, vpp: int,
                        m: int) -> Optional[float]:
        """Observed bubble fraction for a (device kind, schedule) pair,
        interpolated over the numeric (pp, vpp, m) axes.  None when the
        pair was never observed — the caller falls back to the predictor's
        simulated bubble (tests/test_profile.py)."""
        return self._interp(self._dev(device_kind), "observed_bubble",
                            {"arch": cfg.name, "schedule": schedule,
                             "pp": pp, "vpp": vpp, "m": m}, "bubble_frac")
