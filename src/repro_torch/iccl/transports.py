"""ICCL transport registry (paper §3.1; a copy of
``repro/iccl/transports.py``, held ``==`` to it by
``tests/test_torch_pipeline.py``).

A transport is a physical path data can take between accelerators, with a
cost model that the performance predictor uses.  Three kinds mirror the
paper:

  * ``ici``        fast homogeneous interconnect (NVLink / InfiniBand
                   within an island)
  * ``rdma``       GPU-direct RDMA across the heterogeneous boundary
                   (the paper's GPU-based communicator)
  * ``cpu_staged`` device -> PCIe -> CPU -> Ethernet -> CPU -> PCIe ->
                   device (the paper's CPU-based communicator; universal
                   but pays the copies)

``ib`` is InfiniBand between homogeneous nodes.  On one card no transfer
is made: the registry is a cost model and the planner's transport option.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict


@dataclasses.dataclass(frozen=True)
class Transport:
    name: str
    gbps: float                 # effective bandwidth, Gb/s
    latency_s: float = 5e-6
    hop_gbps: float = 0.0       # per-end staging hop (PCIe) for cpu_staged

    @property
    def bytes_per_s(self) -> float:
        return self.gbps * 1e9 / 8.0

    def p2p_time(self, nbytes: float) -> float:
        t = self.latency_s + nbytes / self.bytes_per_s
        if self.hop_gbps:
            t += 2.0 * nbytes / (self.hop_gbps * 1e9 / 8.0)
        return t

    def allreduce_time(self, nbytes: float, n: int) -> float:
        """Ring all-reduce: 2(n-1)/n of the volume per participant."""
        if n <= 1:
            return 0.0
        return self.latency_s * 2 * (n - 1) + \
            2.0 * (n - 1) / n * nbytes / self.bytes_per_s

    def allgather_time(self, nbytes_shard: float, n: int) -> float:
        if n <= 1:
            return 0.0
        return self.latency_s * (n - 1) + \
            (n - 1) * nbytes_shard / self.bytes_per_s

    def alltoall_time(self, nbytes: float, n: int) -> float:
        if n <= 1:
            return 0.0
        return self.latency_s * (n - 1) + \
            (n - 1) / n * nbytes / self.bytes_per_s


def default_registry(ib_gbps: float = 170.0, eth_gbps: float = 19.0,
                     pcie_gbps: float = 512.0, ici_gbps: float = 400.0
                     ) -> Dict[str, Transport]:
    return {
        "ici": Transport("ici", ici_gbps, latency_s=1e-6),
        "ib": Transport("ib", ib_gbps),
        "rdma": Transport("rdma", eth_gbps),
        "cpu_staged": Transport("cpu_staged", eth_gbps, latency_s=5e-5,
                                hop_gbps=pcie_gbps),
    }
