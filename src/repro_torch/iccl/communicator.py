"""ICCL's collective tap (paper §3.1; port of the tap of
``repro/iccl/communicator.py``).

Every collective the training programs issue is reported to one
module-level sink as ``(op, transport, payload_bytes)``, with the bytes
from ``numel * element_size``.  The JAX package calls its sink while jax
traces a program, so there the sink fires once per compiled program.  The
port runs eagerly: its sink fires once per executed call, each time the
loss runs the collective's place in the program (a pipeline tick's stage
hop, a cp ring hop).  JAX unrolls the pipeline's ticks, so one call of the
port's pipeline loss notes what one trace of the JAX loss notes, in the
same order; JAX scans the cp ring's layers and traces their body once, so
one call of the port's cp loss notes that body's hops once a layer.  With
no sink installed (the default) a note costs one comparison.

Not ported yet: the axis-routed ``Communicator`` class (iallreduce,
iallgather, ireducescatter, ialltoall, isend_irecv, shift), which the JAX
package uses inside ``shard_map``.  On one card no program calls it; it
comes with the multi-rank runtime over ``torch.distributed`` (ROADMAP.md
queue A, item A5b).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

Sink = Callable[[str, str, int], None]
_SINK: Optional[Sink] = None


def set_collective_sink(sink: Optional[Sink]) -> None:
    """Install (or clear, with None) the collective sink."""
    global _SINK
    _SINK = sink


def _note(op: str, transport: str, x: torch.Tensor) -> None:
    """Report collective ``op`` over ``transport`` carrying ``x`` (a
    ``meta`` tensor will do where only its shape and dtype exist)."""
    if _SINK is not None:
        _SINK(op, transport, x.numel() * x.element_size())
