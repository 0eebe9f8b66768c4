"""Heterogeneous cluster description (paper §3.2 'sampling' inputs); a
copy of ``repro/core/cluster.py`` for the port.

A ClusterSpec is what the distributed performance predictor and the automatic
parallel planner consume: per-device-type compute/memory characteristics and
the link matrix between node groups.  The paper profiles these on a small
sample cluster; here they come from hardware constants, or from layer times
measured on the card (``repro_torch.profile``).

Paper hardware constants (§4) are provided as presets, including the
measured homogeneous-cluster MFUs used for the Fig.7/Fig.8 reproduction:
``NVIDIA``, ``GPU_A``-``GPU_C`` and ``AMD`` are the paper's numbers, not
the port's.  ``H100`` is the port's own card, its MFU measured by the port.
The JAX package's TPU preset and TPU multi-pod cluster are not carried:
they model the JAX runtime's TPU target, which the port does not run on.
``homogeneous_cluster(H100, n)`` is the card's cluster.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

# Transports a ParallelPlan may route the heterogeneous boundary over.
# THE single source of truth for transport names: ParallelPlan validates
# against this at construction and link_gbps() at lookup.
TRANSPORTS = ("gpu", "cpu")


def validate_transport(name: str) -> str:
    if name not in TRANSPORTS:
        raise ValueError(
            f"unknown transport {name!r}; valid transports: {TRANSPORTS} "
            "('gpu' = GPU-direct RDMA across the boundary, 'cpu' = "
            "CPU-staged PCIe+ethernet path)")
    return name


@dataclasses.dataclass(frozen=True)
class DeviceType:
    name: str
    peak_tflops: float          # fp16/bf16 peak per accelerator
    mfu: float                  # measured homogeneous-cluster MFU (0..1)
    hbm_gb: float = 64.0
    hbm_gbps: float = 1600.0
    # degradation provenance: the HEALTHY homogeneous MFU this device was
    # constructed with.  ``ClusterSpec.degrade`` stamps it on first
    # application so repeated degradations REPLACE (relative to health)
    # instead of composing on the already-degraded ``mfu`` — the factor^2
    # double-count class.  None = ``mfu`` IS the healthy baseline.
    base_mfu: Optional[float] = None

    @property
    def effective_tflops(self) -> float:
        """Achievable per-accelerator throughput = peak x homogeneous MFU
        (the paper's Eq.2 calibration)."""
        return self.peak_tflops * self.mfu

    @property
    def healthy_mfu(self) -> float:
        """The MFU before any ``degrade`` was applied."""
        return self.base_mfu if self.base_mfu is not None else self.mfu

    @property
    def slowdown(self) -> float:
        """Currently applied degradation factor vs health (1.0 = healthy)."""
        return self.healthy_mfu / self.mfu if self.mfu > 0 else 1.0

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "DeviceType":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class NodeGroup:
    """A homogeneous island: n_nodes nodes of one device type."""
    device: DeviceType
    n_nodes: int
    accel_per_node: int = 8
    intra_node_gbps: float = 300.0 * 8   # NVLink/PCIe-class, in Gb/s

    @property
    def n_accel(self) -> int:
        return self.n_nodes * self.accel_per_node

    @property
    def healthy(self) -> "NodeGroup":
        """The same island at its healthy (pre-degrade) rating — what a
        replacement node joining the cluster actually provides."""
        if self.device.base_mfu is None:
            return self
        return dataclasses.replace(
            self, device=dataclasses.replace(
                self.device, mfu=self.device.healthy_mfu, base_mfu=None))

    def to_dict(self) -> Dict[str, object]:
        """JSON-able form (the ``node-joined`` directive wire format)."""
        return {"device": self.device.to_dict(), "n_nodes": self.n_nodes,
                "accel_per_node": self.accel_per_node,
                "intra_node_gbps": self.intra_node_gbps}

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "NodeGroup":
        return cls(device=DeviceType.from_dict(dict(d["device"])),
                   n_nodes=int(d["n_nodes"]),
                   accel_per_node=int(d.get("accel_per_node", 8)),
                   intra_node_gbps=float(
                       d.get("intra_node_gbps", 300.0 * 8)))


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    groups: Tuple[NodeGroup, ...]
    # intra-group inter-node fabric (IB): theoretical / measured Gb/s
    ib_gbps: float = 200.0
    ib_eff: float = 0.85          # paper: 160-180 of 200 actual
    # inter-group (heterogeneous boundary) fabric (Ethernet): Gb/s
    eth_gbps: float = 25.0
    eth_eff: float = 0.76         # paper: 18-20 of 25 actual
    pcie_gbps: float = 64.0 * 8   # CPU-staged transport hop

    @property
    def n_accel(self) -> int:
        return sum(g.n_accel for g in self.groups)

    @property
    def peak_tflops_mean(self) -> float:
        """Paper Eq.2: heterogeneous peak = mean over accelerators."""
        return (sum(g.n_accel * g.device.peak_tflops for g in self.groups)
                / self.n_accel)

    @property
    def theoretical_mfu(self) -> float:
        """Upper-bound MFU: every accelerator at its homogeneous MFU
        (count- and peak-weighted; validated against Fig.7a/b/c)."""
        num = sum(g.n_accel * g.device.peak_tflops * g.device.mfu
                  for g in self.groups)
        den = sum(g.n_accel * g.device.peak_tflops for g in self.groups)
        return num / den

    def degrade(self, device_kind: str, factor: float) -> "ClusterSpec":
        """Straggler-injection hook: the same topology with ``device_kind``'s
        achievable throughput divided by ``factor`` (its homogeneous MFU is
        scaled down, so ``effective_tflops`` drops by exactly ``factor``).

        This is what drives the online-replan loop end-to-end: telemetry
        detects sustained degradation, the caller builds the degraded spec,
        and ``Trainer.replan`` re-searches against it — scaling any
        *observed* profile entries of that kind by the same factor
        (tests/test_replan.py).

        ``factor`` is ABSOLUTE — "this kind runs ``factor``x slower than
        healthy" — and repeated application REPLACES rather than
        composes: the device tracks its healthy baseline (``base_mfu``)
        and the applied slowdown is ``max(current, factor)``, matching
        the trainer's max-not-compose rule for observation scales.  A
        replayed or re-estimated directive therefore never double-counts
        into factor^2."""
        if factor <= 0:
            raise ValueError(f"degrade factor must be > 0, got {factor}")
        if all(g.device.name != device_kind for g in self.groups):
            known = sorted({g.device.name for g in self.groups})
            raise ValueError(f"unknown device kind {device_kind!r}; "
                             f"cluster has {known}")

        def deg(d: DeviceType) -> DeviceType:
            applied = max(d.slowdown, factor)
            return dataclasses.replace(d, mfu=d.healthy_mfu / applied,
                                       base_mfu=d.healthy_mfu)

        groups = tuple(
            dataclasses.replace(g, device=deg(g.device))
            if g.device.name == device_kind else g
            for g in self.groups)
        return dataclasses.replace(self, groups=groups)

    # --------------------------------------------- membership edits --------
    def remove_group(self, device_kind: str) -> "ClusterSpec":
        """Membership edit: the same cluster without ``device_kind``'s
        island (node loss).  Raises on an unknown kind and on removing
        the last island — an empty cluster is not a topology the planner
        can place anything on.  NOTE: group INDICES shift (``.groups`` is
        positional), so plans referencing the old cluster must be
        re-searched, never re-indexed (Trainer drops the incumbent as the
        search baseline across a membership change)."""
        if all(g.device.name != device_kind for g in self.groups):
            known = sorted({g.device.name for g in self.groups})
            raise ValueError(f"unknown device kind {device_kind!r}; "
                             f"cluster has {known}")
        groups = tuple(g for g in self.groups
                       if g.device.name != device_kind)
        if not groups:
            raise ValueError(
                f"removing {device_kind!r} would leave an empty cluster")
        return dataclasses.replace(self, groups=groups)

    def add_group(self, group: NodeGroup) -> "ClusterSpec":
        """Membership edit: append an island (node join).  Joining a kind
        already present is replace-not-compose, like ``degrade``: the
        existing island is swapped for the incoming one (a rejoining node
        arrives healthy; stacking a second island of the same kind would
        double its capacity on every rejoin of a flapping node)."""
        if any(g.device.name == group.device.name for g in self.groups):
            groups = tuple(group if g.device.name == group.device.name
                           else g for g in self.groups)
        else:
            groups = self.groups + (group,)
        return dataclasses.replace(self, groups=groups)

    def link_gbps(self, ga: int, gb: int, transport: str = "gpu") -> float:
        """Effective Gb/s between node groups (indices into .groups)."""
        validate_transport(transport)
        if ga == gb:
            return self.ib_gbps * self.ib_eff
        if transport == "cpu":
            # CPU-staged: PCIe copy out + ethernet + PCIe copy in (serial)
            eth = self.eth_gbps * self.eth_eff
            inv = 2.0 / self.pcie_gbps + 1.0 / eth
            return 1.0 / inv
        return self.eth_gbps * self.eth_eff


# ----------------------------------------------------------- paper presets --
# Peaks are equal across vendors in the paper's MFU algebra (Fig.7 checks out
# only under equal peaks); measured homogeneous MFUs from §4.4.2.
NVIDIA = DeviceType("nvidia", peak_tflops=989.0, mfu=0.564)
GPU_A = DeviceType("gpu-a", peak_tflops=989.0, mfu=0.453)
GPU_B = DeviceType("gpu-b", peak_tflops=989.0, mfu=0.288)
GPU_C = DeviceType("gpu-c", peak_tflops=989.0, mfu=0.353)
AMD = DeviceType("amd", peak_tflops=989.0, mfu=0.389)

# The port's card: H100 SXM data-sheet peaks (989 TFLOP/s bf16 dense, 3.35
# TB/s).  MFU: paper Eq.2 of the port's steady reference train step of
# llama3-8b at full width, 4 layers, seq 4096, batch 1, measured by
# chip_smoke.py phase 6b on an NVIDIA H100 80GB HBM3 at a 700 W power
# limit (steps 1-2: 0.2176 s): flops_per_token(4096) * 3 * 4096 /
# (step_s * 989e12).  The step includes AdamW and the trainer's host work.
H100 = DeviceType("h100", peak_tflops=989.0, mfu=0.2349, hbm_gb=80.0,
                  hbm_gbps=3350.0)


def paper_hetero_cluster(n_amd_nodes: int = 16, n_a_nodes: int = 80,
                         amd: DeviceType = AMD,
                         other: DeviceType = GPU_A) -> ClusterSpec:
    """The paper's 1:5 AMD:GPU-A heterogeneous cluster (96N768D default)."""
    return ClusterSpec(groups=(NodeGroup(amd, n_amd_nodes),
                               NodeGroup(other, n_a_nodes)))


def paper_cluster_of_size(n_nodes: int) -> ClusterSpec:
    """12N96D / 24N192D / 48N384D / 96N768D from §4.1 (ratio 1:5)."""
    assert n_nodes % 6 == 0, "paper clusters keep AMD:A = 1:5"
    return paper_hetero_cluster(n_nodes // 6, n_nodes - n_nodes // 6)


def homogeneous_cluster(dev: DeviceType, n_nodes: int) -> ClusterSpec:
    return ClusterSpec(groups=(NodeGroup(dev, n_nodes),))
