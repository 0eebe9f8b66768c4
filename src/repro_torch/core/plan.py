"""Distributed training and serving plans (port of ``repro/core/plan.py``):
the output of the port's automatic parallel planner (``core/planner.py``).

``StagePlacement`` and ``ParallelPlan`` field for field, with the same
validation, tick algebra and ``to_dict``/``from_dict``/``describe``, and
the serving classes ``ServingSLO``, ``TrafficProfile`` and ``ServingPlan``,
so a plan searched by either package reads the same in the other.  The
port's trainer executes pp = 1 plans (the reference route and the cp
ring) and pp > 1 plans (the pipeline, ``parallel/pipeline.py``) on one
device; stages on separate ranks are ROADMAP.md queue A, item A5b.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

from repro_torch.core.cluster import validate_transport


@dataclasses.dataclass(frozen=True)
class StagePlacement:
    group: int         # index into ClusterSpec.groups
    n_layers: int
    dp: int            # data-parallel replicas of this stage
    tp: int            # tensor-parallel width inside a node
    is_last: bool = False

    @property
    def n_accel(self) -> int:
        return self.dp * self.tp


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """``micro_bs`` is the per-replica microbatch size at stage 0.  Stages may
    have different DP degrees (heterogeneous groups); each stage's microbatch
    size is scaled so every stage consumes the same sequences per pipeline
    tick: mbs_i = tokens_per_tick / dp_i.

    ``vpp`` (virtual stages per physical stage, schedule
    "interleaved-1f1b") makes each stage hold vpp model chunks; chunk c of
    stage i is virtual stage c*pp + i.  ``chunk_layers`` optionally pins
    the per-virtual-stage layer counts (virtual order, summing to each
    stage's n_layers per stage) — the planner's chunk-granular dp_split
    writes it; None splits every stage's layers evenly across its
    chunks.

    ``cp`` (context parallelism) splits each stage's dp replicas into
    ``dp/cp`` data groups of cp ring ranks; rank r holds sequence tokens
    ``[sum(cp_chunks[:r]), sum(cp_chunks[:r+1]))`` and attention streams
    KV blocks around the ring (ring attention over the pod axis).
    ``cp_chunks`` optionally pins unequal per-rank chunk sizes (the
    planner's ``cp_split`` writes them: the causal triangle makes
    decreasing chunks optimal, and slower rings get shorter chunks);
    None splits the sequence evenly (earlier ranks take the
    remainder)."""
    stages: Tuple[StagePlacement, ...]
    micro_bs: int
    global_batch: int
    seq_len: int
    transport: str = "gpu"   # iccl transport across the hetero boundary
    # pipeline schedule this plan runs (and is scored) under; the planner
    # selects these per plan (ROADMAP: per-stage schedule selection)
    schedule: str = "1f1b"
    eager_slack: int = 2     # only meaningful for schedule="1f1b-eager"
    vpp: int = 1             # virtual stages per physical stage
    chunk_layers: Optional[Tuple[int, ...]] = None
    cp: int = 1              # ring-attention context-parallel degree
    cp_chunks: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        validate_transport(self.transport)
        if self.vpp < 1:
            raise ValueError(f"vpp must be >= 1, got {self.vpp}")
        if self.cp < 1:
            raise ValueError(f"cp must be >= 1, got {self.cp}")
        if self.cp > 1:
            for i, st in enumerate(self.stages):
                if st.dp % self.cp != 0:
                    raise ValueError(
                        f"cp={self.cp} must divide every stage dp; "
                        f"stage {i} has dp={st.dp}")
            if self.seq_len < self.cp:
                raise ValueError(
                    f"cp={self.cp} needs seq_len >= cp, "
                    f"got seq_len={self.seq_len}")
        if self.cp_chunks is not None:
            if len(self.cp_chunks) != self.cp:
                raise ValueError(
                    f"cp_chunks needs cp={self.cp} entries, "
                    f"got {len(self.cp_chunks)}")
            if any(c < 1 for c in self.cp_chunks):
                raise ValueError("cp_chunks entries must be >= 1")
            if sum(self.cp_chunks) != self.seq_len:
                raise ValueError(
                    f"cp_chunks sum to {sum(self.cp_chunks)}, "
                    f"seq_len is {self.seq_len}")
        if self.vpp > 1 and self.schedule != "interleaved-1f1b":
            raise ValueError(
                f"vpp={self.vpp} requires schedule='interleaved-1f1b', "
                f"got {self.schedule!r}")
        if self.chunk_layers is not None:
            pp = len(self.stages)
            if len(self.chunk_layers) != pp * self.vpp:
                raise ValueError(
                    f"chunk_layers needs pp*vpp={pp * self.vpp} entries, "
                    f"got {len(self.chunk_layers)}")
            for i, st in enumerate(self.stages):
                got = sum(self.chunk_layers[c * pp + i]
                          for c in range(self.vpp))
                if got != st.n_layers:
                    raise ValueError(
                        f"chunk_layers of stage {i} sum to {got}, "
                        f"stage has {st.n_layers} layers")

    @property
    def pp(self) -> int:
        return len(self.stages)

    @property
    def dp(self) -> int:
        """Widest data-parallel degree across stages (stages may differ on
        a heterogeneous cluster — never assume stage 0 speaks for the
        plan).  ``dp > 1`` iff ANY stage replicates gradients, which is
        what the predictor's all-reduce gate needs."""
        return max(s.dp for s in self.stages)

    @property
    def dps(self) -> Tuple[int, ...]:
        return tuple(s.dp for s in self.stages)

    @property
    def tps(self) -> Tuple[int, ...]:
        return tuple(s.tp for s in self.stages)

    @property
    def tokens_per_tick(self) -> int:
        """Sequences entering the pipeline per tick.  lcm over stage DATA-
        GROUP widths (dp/cp: a cp ring of ranks collectively consumes one
        microbatch, splitting it on the sequence axis) so every stage's
        microbatch size is a whole number even when heterogeneous groups
        carry different DP."""
        l = 1
        for s in self.stages:
            l = math.lcm(l, s.dp // self.cp)
        return self.micro_bs * l

    def stage_micro_bs(self, i: int) -> int:
        return max(1, self.tokens_per_tick // (self.stages[i].dp // self.cp))

    @property
    def micro_batches(self) -> int:
        return max(1, self.global_batch // self.tokens_per_tick)

    @property
    def n_accel(self) -> int:
        return sum(s.n_accel for s in self.stages)

    @property
    def layers(self) -> Tuple[int, ...]:
        return tuple(s.n_layers for s in self.stages)

    @property
    def virtual_layers(self) -> Tuple[int, ...]:
        """Per-virtual-stage layer counts (virtual order: chunk c of stage
        i at index c*pp + i).  ``chunk_layers`` when the planner pinned
        them; otherwise each stage's layers split evenly across its chunks
        (earlier chunks take the remainder)."""
        if self.chunk_layers is not None:
            return self.chunk_layers
        if self.vpp == 1:
            return self.layers
        pp = self.pp
        out = [0] * (pp * self.vpp)
        for i, st in enumerate(self.stages):
            base, rem = divmod(st.n_layers, self.vpp)
            for c in range(self.vpp):
                out[c * pp + i] = base + (1 if c < rem else 0)
        return tuple(out)

    @property
    def cp_chunk_sizes(self) -> Tuple[int, ...]:
        """Resolved per-ring-rank sequence chunk sizes (length cp, summing
        to seq_len).  ``cp_chunks`` when the planner pinned them; otherwise
        an even split with earlier ranks taking the remainder."""
        if self.cp_chunks is not None:
            return self.cp_chunks
        base, rem = divmod(self.seq_len, self.cp)
        return tuple(base + (1 if r < rem else 0) for r in range(self.cp))

    def to_dict(self) -> dict:
        """JSON-serializable form (the adaptation controller broadcasts
        the searched plan to every process before a collective adoption).
        ``from_dict`` round-trips it to an ``==``-equal plan."""
        return {"stages": [dataclasses.asdict(s) for s in self.stages],
                "micro_bs": self.micro_bs,
                "global_batch": self.global_batch,
                "seq_len": self.seq_len, "transport": self.transport,
                "schedule": self.schedule, "eager_slack": self.eager_slack,
                "vpp": self.vpp,
                "chunk_layers": (list(self.chunk_layers)
                                 if self.chunk_layers is not None else None),
                "cp": self.cp,
                "cp_chunks": (list(self.cp_chunks)
                              if self.cp_chunks is not None else None)}

    @classmethod
    def from_dict(cls, d: dict) -> "ParallelPlan":
        return cls(stages=tuple(StagePlacement(**s) for s in d["stages"]),
                   micro_bs=d["micro_bs"],
                   global_batch=d["global_batch"], seq_len=d["seq_len"],
                   transport=d.get("transport", "gpu"),
                   schedule=d.get("schedule", "1f1b"),
                   eager_slack=d.get("eager_slack", 2),
                   vpp=d.get("vpp", 1),
                   chunk_layers=(tuple(d["chunk_layers"])
                                 if d.get("chunk_layers") is not None
                                 else None),
                   cp=d.get("cp", 1),
                   cp_chunks=(tuple(d["cp_chunks"])
                              if d.get("cp_chunks") is not None else None))

    def describe(self) -> str:
        seg = "".join(str(s.n_layers) for s in self.stages) \
            if max(self.layers) < 10 else "-".join(map(str, self.layers))
        sched = self.schedule
        if sched == "1f1b-eager":
            sched += f"+{self.eager_slack}"
        elif sched == "interleaved-1f1b":
            sched += f"x{self.vpp}"

        def per_stage(vals: Tuple[int, ...]) -> str:
            # honest rendering: one number only when the stages agree,
            # else the full per-stage sequence
            return (str(vals[0]) if len(set(vals)) == 1
                    else ",".join(map(str, vals)))

        cp = ""
        if self.cp > 1:
            chunks = self.cp_chunk_sizes
            cp = (f" cp={self.cp}"
                  + (f" chunks={'/'.join(map(str, chunks))}"
                     if len(set(chunks)) > 1 else ""))
        return (f"pp={self.pp} tp={per_stage(self.tps)} "
                f"dp={per_stage(self.dps)} "
                f"mbs={self.micro_bs} m={self.micro_batches} "
                f"sched={sched} seg={seg}{cp}")


# ------------------------------------------------------------- serving -----
@dataclasses.dataclass(frozen=True)
class ServingSLO:
    """Latency service-level objective the serving planner optimizes
    against: time-to-first-token and time-per-output-token budgets, both
    in seconds."""
    ttft_s: float
    tpot_s: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class TrafficProfile:
    """The request mix a serving placement is sized for: mean prompt /
    generation lengths (tokens) and the offered request rate (req/s).
    The engine re-derives an OBSERVED profile from its admission stream;
    drift between the two is the serving replan signal."""
    prompt_len: int
    gen_len: int
    request_rate: float

    @property
    def prefill_decode_ratio(self) -> float:
        """Prefill-heaviness: prompt tokens per generated token — the
        scalar the drift detector thresholds on."""
        return self.prompt_len / max(self.gen_len, 1)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class ServingPlan:
    """The serving planner's output: where prefill and decode run.

    ``prefill_group``/``decode_group`` index ``ClusterSpec.groups``; when
    they differ the placement is DISAGGREGATED (prompt KV migrates over
    the boundary link after prefill, HexiScale-style asymmetric
    islands); when equal the island time-shares both roles and decode
    pays a prefill-interference duty cycle."""
    prefill_group: int
    prefill_tp: int
    decode_group: int
    decode_tp: int
    decode_batch: int          # continuous-batching slot count per replica
    max_len: int               # per-sequence cache budget (prompt + gen)
    transport: str = "gpu"

    def __post_init__(self):
        validate_transport(self.transport)

    @property
    def disaggregated(self) -> bool:
        return self.prefill_group != self.decode_group

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ServingPlan":
        return cls(**d)

    def describe(self) -> str:
        mode = "disagg" if self.disaggregated else "coloc"
        return (f"prefill=g{self.prefill_group}xtp{self.prefill_tp} "
                f"decode=g{self.decode_group}xtp{self.decode_tp}"
                f"xb{self.decode_batch} max_len={self.max_len} {mode}")
