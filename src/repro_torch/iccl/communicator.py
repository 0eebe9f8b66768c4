"""ICCL, HETHUB's unified communicator (paper §3.1; port of
``repro/iccl/communicator.py``): the collective tap and the axis-routed
``Communicator``.

The tap.  Every collective the training programs issue is reported to one
module-level sink as ``(op, transport, payload_bytes)``, with the bytes
from ``numel * element_size``.  The JAX package calls its sink while jax
traces a program, so there the sink fires once per compiled program.  The
port runs eagerly: its sink fires once per executed call, each time the
loss runs the collective's place in the program (a pipeline tick's stage
hop, a cp ring hop, a ``Communicator`` call).  JAX unrolls the pipeline's
ticks, so one call of the port's one-card pipeline loss notes what one
trace of the JAX loss notes, in the same order; JAX scans the cp ring's
layers and traces their body once, so one call of the port's cp loss
notes that body's hops once a layer.  With no sink installed (the
default) a note costs one comparison.

The ``Communicator``.  The same frozen dataclass ``(axis, transport,
compress)`` with the JAX methods, names and results: ``iallreduce`` (sum),
``iallgather``, ``ireducescatter``, ``ialltoall``, ``isend_irecv``,
``shift``, ``index``, ``size``.  JAX's methods run at trace time inside
``shard_map``: each lowers to one XLA collective over a mesh axis, which
every device of the axis executes as part of one program.  The port's run
when called, on this rank, over the ``torch.distributed`` group bound to
the axis name (``bind_axis``; ``parallel/groups.make_rank_grid`` binds
``model``, ``pod`` and ``data``), and return when this rank's result is in hand.
Collectives need every rank of the axis to call them in the same order.
A point-to-point call acts only on the pairs of ``perm`` this rank is in,
so ranks may pass different pairs: each posts its receive, then its send,
in one ``dist.batch_isend_irecv``; a rank that receives nothing gets
zeros, as ``ppermute`` gives.  Collectives note every rank's call; a
point-to-point call is noted by the rank that sends, once a hop.

The transport is the caller's choice and nothing else picks it, least of
all a failure:

  * a CPU tensor goes over the group's gloo backend, whatever the
    transport;
  * ``"cpu"``: a CUDA tensor is copied to pinned host memory (the
    producing stream synchronized first, since gloo reads the buffer at
    once), moved over gloo and copied back to the card on the current
    stream: device -> PCIe -> CPU -> network -> CPU -> PCIe -> device,
    HETHUB's CPU-based communicator (``cpu_staged`` in ``transports``);
  * ``"gpu"`` and the JAX names ``"ici"`` / ``"rdma"``: CUDA tensors go
    over NCCL.  A group without an NCCL backend, or two of whose ranks
    drive one card (NCCL cannot put two ranks on one device), raises a
    ``ValueError`` that names ``transport="cpu"``.

``compress`` casts fp32 payloads to bf16 before a reduction or a hop and
back after, as JAX's ``_pack``/``_unpack`` do.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

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


# ------------------------------------------------------------ the axes ----
TRANSPORTS = ("cpu", "gpu", "ici", "rdma")


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """The process group behind a mesh axis name: its global ranks in axis
    order, each rank's device (``host/device``), and whether the group
    has an NCCL backend."""
    group: Any
    ranks: Tuple[int, ...]
    devices: Tuple[str, ...]
    nccl: bool

    def check_gpu(self, axis: str, transport: str) -> None:
        """Raise unless CUDA tensors can go over NCCL on this axis."""
        shared = sorted({d for d in self.devices
                         if self.devices.count(d) > 1})
        if shared:
            raise ValueError(
                f"axis {axis!r}: transport {transport!r} goes over NCCL, "
                f"which cannot put two ranks on one device ({shared[0]} "
                "drives several); use transport='cpu' (host-staged)")
        if not self.nccl:
            raise ValueError(
                f"axis {axis!r}: transport {transport!r} needs an NCCL "
                "process group (backend 'cpu:gloo,cuda:nccl'); use "
                "transport='cpu' over gloo")


_AXES: Dict[str, AxisGroup] = {}


def bind_axis(axis: str, group: Any, ranks: Sequence[int],
              devices: Sequence[str], nccl: bool) -> None:
    """Name ``group`` (global ``ranks`` in axis order) as mesh axis
    ``axis`` for this process's ``Communicator``s."""
    _AXES[axis] = AxisGroup(group, tuple(ranks), tuple(devices), nccl)


def axis_group(axis: str) -> AxisGroup:
    if axis not in _AXES:
        raise ValueError(f"no process group is bound to axis {axis!r} "
                         "(parallel/groups.make_rank_grid binds 'model', "
                         "'pod' and 'data')")
    return _AXES[axis]


# ------------------------------------------------------ the communicator --
@dataclasses.dataclass(frozen=True)
class Communicator:
    """Axis-routed collectives over ``torch.distributed`` (see the module
    docstring for the transports and the per-call semantics)."""
    axis: str
    transport: str = "ici"          # which path this axis's payloads take
    compress: bool = False          # bf16-compress fp32 payloads

    def __post_init__(self):
        if self.transport not in TRANSPORTS:
            raise ValueError(f"unknown transport {self.transport!r}; "
                             f"choose from {TRANSPORTS}")

    # -- helpers --------------------------------------------------------
    def _pack(self, x):
        if self.compress and x.dtype == torch.float32:
            return x.to(torch.bfloat16), torch.float32
        return x, None

    def _unpack(self, x, orig):
        return x.to(orig) if orig is not None else x

    def _staged(self, x: torch.Tensor) -> bool:
        """True when ``x`` hops through host memory; checks the NCCL path."""
        if x.device.type == "cpu":
            return False
        if x.device.type != "cuda":
            raise ValueError(f"no transport for tensors on {x.device}")
        if self.transport == "cpu":
            return True
        axis_group(self.axis).check_gpu(self.axis, self.transport)
        return False

    def _empty(self, shape, x: torch.Tensor, staged: bool) -> torch.Tensor:
        """A buffer the group's backend writes: pinned host memory on the
        staged path, else on ``x``'s device."""
        if staged:
            return torch.empty(shape, dtype=x.dtype, pin_memory=True)
        return torch.empty(shape, dtype=x.dtype, device=x.device)

    def _to_wire(self, x: torch.Tensor, staged: bool) -> torch.Tensor:
        """A contiguous copy of ``x`` for the backend to read; on the staged
        path the copy to the host is complete when this returns."""
        out = self._empty(x.shape, x, staged)
        out.copy_(x, non_blocking=staged)
        if staged:
            torch.cuda.current_stream(x.device).synchronize()
        return out

    @staticmethod
    def _from_wire(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return t.to(x.device, non_blocking=True) if t.device != x.device else t

    def _me(self, ax: AxisGroup) -> int:
        return ax.ranks.index(dist.get_rank())

    # -- collectives ----------------------------------------------------
    def iallreduce(self, x: torch.Tensor) -> torch.Tensor:
        _note("iallreduce", self.transport, x)
        ax = axis_group(self.axis)
        y, orig = self._pack(x)
        staged = self._staged(y)
        w = self._to_wire(y, staged)
        if len(ax.ranks) > 1:
            dist.all_reduce(w, group=ax.group)
        return self._unpack(self._from_wire(w, y), orig)

    def iallgather(self, x: torch.Tensor, axis: int = 0,
                   tiled: bool = True) -> torch.Tensor:
        _note("iallgather", self.transport, x)
        ax = axis_group(self.axis)
        staged = self._staged(x)
        parts = [self._empty(x.shape, x, staged) for _ in ax.ranks]
        if len(parts) > 1:
            dist.all_gather(parts, self._to_wire(x, staged), group=ax.group)
        else:
            parts[0].copy_(x)
        parts = [self._from_wire(p, x) for p in parts]
        return torch.cat(parts, axis) if tiled else torch.stack(parts, axis)

    def ireducescatter(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """The sum over the axis, split along ``axis``: this rank's block
        (the whole sum is reduced, then sliced)."""
        _note("ireducescatter", self.transport, x)
        ax = axis_group(self.axis)
        n = len(ax.ranks)
        if x.shape[axis] % n:
            raise ValueError(f"dim {axis} of {tuple(x.shape)} does not split "
                             f"over {n} ranks")
        y, orig = self._pack(x)
        staged = self._staged(y)
        w = self._to_wire(y, staged)
        if n > 1:
            dist.all_reduce(w, group=ax.group)
        block = w.chunk(n, axis)[self._me(ax)].contiguous()
        return self._unpack(self._from_wire(block, y), orig)

    def ialltoall(self, x: torch.Tensor, split_axis: int,
                  concat_axis: int) -> torch.Tensor:
        """Block i of ``x`` along ``split_axis`` goes to rank i; the blocks
        received are concatenated along ``concat_axis`` in rank order."""
        _note("ialltoall", self.transport, x)
        ax = axis_group(self.axis)
        n = len(ax.ranks)
        if x.shape[split_axis] % n:
            raise ValueError(f"dim {split_axis} of {tuple(x.shape)} does not "
                             f"split over {n} ranks")
        staged = self._staged(x)
        blocks = self._to_wire(torch.stack(x.chunk(n, split_axis)), staged)
        out = self._empty(blocks.shape, x, staged)
        if n > 1:
            dist.all_to_all_single(out, blocks, group=ax.group)
        else:
            out.copy_(blocks)
        return torch.cat(self._from_wire(out, x).unbind(0), concat_axis)

    def _isend_irecv_batch(self, ops: Sequence[Tuple[str, int, torch.Tensor]],
                           later: Optional[List[Any]] = None
                           ) -> List[torch.Tensor]:
        """Point-to-point ops of this rank posted in one
        ``dist.batch_isend_irecv``, in their order: ``("send", dst, x)``
        and ``("recv", src, like)`` (axis indices, never this rank's).
        Returns the received tensors in order once they have arrived; two
        messages between one pair of ranks match in posting order.  The
        sends are waited for too, unless ``later`` is given: their (work,
        buffer) pairs go there, for the caller to wait on (NCCL gives one
        work a batch, whose wait only orders the stream: it is waited on
        here).  Each send is noted as one ``isend_irecv`` hop."""
        ax = axis_group(self.axis)
        posted, recvs = [], []
        for op, peer, x in ops:
            y, orig = self._pack(x)
            staged = self._staged(y)
            if op == "send":
                _note("isend_irecv", self.transport, x)
                buf = self._to_wire(y, staged)
            else:
                buf = self._empty(y.shape, y, staged)
                recvs.append((buf, y, orig))
            posted.append(dist.P2POp(dist.isend if op == "send"
                                     else dist.irecv, buf, ax.ranks[peer],
                                     ax.group))
        works = dist.batch_isend_irecv(posted) if posted else []
        if later is not None and len(works) == len(ops):
            # gloo gives one work an op, each waited on once (a second wait
            # would block): a send's here or, with its buffer, by the caller
            for w, p in zip(works, posted):
                if p.op is dist.isend:
                    later.append((w, p.tensor))
                else:
                    w.wait()
        else:
            for w in works:
                w.wait()
        return [self._unpack(self._from_wire(b, y), orig)
                for b, y, orig in recvs]

    def isend_irecv(self, x: torch.Tensor,
                    perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """P2P ring/pipeline transfer (paper's iSend/iReceive primitive):
        ``ppermute`` of ``x`` over ``perm`` (axis indices ``(src, dst)``).
        This rank posts the pairs it is in, at most one receive and one
        send of ``x``, and gets zeros when it receives nothing."""
        me = self.index()
        dsts = [d for s, d in perm if s == me]
        srcs = [s for s, d in perm if d == me]
        if len(dsts) > 1 or len(srcs) > 1:
            raise ValueError(f"perm {list(perm)} sends or receives twice at "
                             f"index {me}")
        if dsts == [me]:        # a pair (i, i) keeps x: noted as its hop
            _note("isend_irecv", self.transport, x)
        got = self._isend_irecv_batch(
            [("recv", s, x) for s in srcs if s != me]
            + [("send", d, x) for d in dsts if d != me])
        if got:
            return got[0]
        return self._unpack(*self._pack(x.clone() if srcs
                                        else torch.zeros_like(x)))

    def shift(self, x: torch.Tensor, offset: int = 1,
              wrap: bool = False) -> torch.Tensor:
        """Neighbour exchange along the axis (pipeline stage boundary)."""
        n = self.size()
        perm = [(i, i + offset) for i in range(n)
                if wrap or 0 <= i + offset < n]
        if wrap:
            perm = [(i, (i + offset) % n) for i in range(n)]
        return self.isend_irecv(x, perm)

    def index(self) -> int:
        return self._me(axis_group(self.axis))

    def size(self) -> int:
        return len(axis_group(self.axis).ranks)


def hetero_boundary_comm(axis: str = "pod",
                         compress: bool = True) -> Communicator:
    """The communicator for HETHUB's heterogeneous boundary: the `pod` mesh
    axis (slow DCN/ethernet-class links) with gradient compression on."""
    return Communicator(axis=axis, transport="rdma", compress=compress)


def homogeneous_comm(axis: str) -> Communicator:
    return Communicator(axis=axis, transport="ici")
