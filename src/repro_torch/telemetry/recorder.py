"""Per-stage / per-tick pipeline telemetry recorder (port of
``repro/telemetry/recorder.py``).

The one-process pipeline loss (``parallel/pipeline.make_pp_loss_fn``)
runs m + pp*vpp - 1 ticks a step; virtual slot ``vs`` does useful work
at tick ``t`` iff 0 <= t - vs < m.  Two recording modes, as in JAX:

  * ``callback`` — a mark at the end of every tick, in the forward pass
    only, plus one after the last tick.  On the CPU a mark reads the host
    clock (the CPU runs the tick's operations before the mark returns).
    On the card a mark is a CUDA event recorded on the current stream
    (``mark``): a host clock read at launch would time the host, which
    runs ahead of the card.  After the step's own final synchronize,
    ``resolve`` turns the events into the same mark sequence (device
    seconds from the step's first mark) and feeds it to ``on_tick``.  No
    synchronize is added to the step.  Per-stage attribution is JAX's
    single-process one: each tick's time is shared equally across the
    virtual slots.
  * ``timer`` — no marks on the hot path.  Whole-step times are folded in
    buckets of ``bucket_steps`` and spread over the ticks under the
    repo's fwd:bwd 1:2 split.

The JAX trainer's ``"auto"`` picks ``timer`` off the CPU because its host
callbacks sync the step; CUDA events do not, so the port's trainer picks
``callback`` on the CPU and on the card.

``RankTelemetry`` is the rank route's recorder: "each process records its
own pod".  Every rank brackets its F and B ops (``OpClock``: CUDA events
on the card, the host clock on the CPU) and reports its stage's forward
seconds per microbatch (each chunk's) and its busy share ``busy / span``
of the step; the trainer gathers every rank's report once a step and
``observe`` records the per-stage view, so every rank folds the same
observations.  Its bubble is the simulator's ``1 - mean over stages of
busy / span`` (``core/simulator.py``).

Both emit the same observations, distinguished by provenance:
``meta["telemetry"]`` records the mode and ``meta["provenance"]`` its
trust class — ``exact`` for callback-mode folds and ``bucketed`` for
timer-mode folds, which carry no per-stage skew.  ``fold_into`` writes
them into a ``profile.ProfileStore`` under two entry kinds:

  observed_stage_tick  {arch, seq_len, tp, schedule, stage, pp, vpp,
                        layers, padded_layers, micro_bs} -> tick_s
      forward seconds one PHYSICAL stage spends per tick (its vpp chunks
      summed), folded as a running mean under the device kind hosting the
      stage, with ``obs_scale``: the n-weighted mean slowdown the folds
      were observed under (1.0 = healthy);
  observed_bubble      {arch, schedule, pp, vpp, m} -> bubble_frac

Invariants (as in JAX): callback mode keeps only complete ordered mark
sequences 0..n_ticks; the first kept step after construction is dropped
(``drop_first``: it pays warm-up, not steady-state time); per-layer
normalization divides by ``padded_layers``.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

MODES = ("callback", "timer")

# floor for recorded times: a zero would poison per-layer divisions
_EPS_S = 1e-12


class StageTelemetry:
    def __init__(self, pp: int, vpp: int, m: int, mode: str = "callback",
                 drop_first: bool = True, bucket_steps: int = 1):
        if mode not in MODES:
            raise ValueError(f"unknown telemetry mode {mode!r}; "
                             f"valid modes: {MODES}")
        if pp < 1 or vpp < 1 or m < 1:
            raise ValueError(f"need pp, vpp, m >= 1; got {pp}, {vpp}, {m}")
        self.pp = pp
        self.vpp = vpp
        self.m = m
        self.mode = mode
        self.drop_first = drop_first
        self.bucket_steps = max(1, bucket_steps)
        self.V = pp * vpp
        self.n_ticks = m + self.V - 1
        self.steps = 0                  # completed (kept) step observations
        self._dropped = False
        self._marks: List[float] = []   # current step's tick timestamps
        self._fresh: List[Any] = []     # per-step observations, not yet
        #                                 folded into a store
        self._bucket: List[float] = []  # timer mode: step times in bucket
        self._last_ticks: Optional[List[float]] = None
        self._last_bubble: Optional[float] = None
        self._folds = 0
        # optional tap, called as sink(step, start_abs, durs) for every
        # kept observation (JAX's observability hook)
        self.sink = None
        self._events: List[Tuple[int, Any]] = []    # the card's marks

    # ------------------------------------------------- callback endpoint --
    def on_tick(self, t, _probe=None, now: Optional[float] = None) -> None:
        """Called in order at the end of every pipeline tick with the tick
        index, plus once with ``t == n_ticks`` after the last tick.
        ``now``: the mark's time in seconds (default: the host clock);
        ``resolve`` passes the card's event times.  Ignored outside
        callback mode."""
        if self.mode != "callback":
            return
        t = int(t)
        if now is None:
            now = time.perf_counter()
        if t == 0:
            self._marks = [now]       # discards any torn previous sequence
            return
        if t != len(self._marks):     # torn sequence (retrace, skipped tick)
            self._marks = []
            return
        self._marks.append(now)
        if t == self.n_ticks:
            first = self._marks[0]
            diffs = [b - a for a, b in zip(self._marks, self._marks[1:])]
            self._marks = []
            # marks fire at end-of-tick: diffs are ticks 1..n_ticks-1 plus
            # the (near-zero) post-loop closing gap.  Tick 0's duration is
            # unobservable (no mark precedes the step) and inherits the
            # mean of the observed ticks.
            ticks = diffs[:-1]
            mean = (sum(ticks) / len(ticks) if ticks
                    else max(_EPS_S, diffs[-1]))
            self._record([mean] + ticks, start_abs=first - mean)

    def mark(self, t: int, like: torch.Tensor) -> None:
        """The pipeline loss's tick mark: on the CPU ``on_tick`` at once;
        on the card a CUDA event on ``like``'s device's current stream,
        held for ``resolve`` (a mark of tick 0 drops unresolved ones)."""
        if like.device.type != "cuda":
            self.on_tick(t)
            return
        if t == 0:
            self._events = []
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(like.device))
        self._events.append((t, ev))

    def resolve(self) -> None:
        """Feed the card's marks to ``on_tick`` in order, as seconds from
        the first; call once the events completed (after the step's own
        synchronize)."""
        events, self._events = self._events, []
        if events:
            first = events[0][1]
            for t, ev in events:
                self.on_tick(t, now=first.elapsed_time(ev) / 1e3)

    # ----------------------------------------------------- timer endpoint --
    def observe_step(self, dt: float) -> None:
        """Cheap step-bucketed path: fold one whole-step wall time.  Only
        the mean over each ``bucket_steps`` window is recorded; the
        forward pipeline section is taken as dt/3 (fwd:bwd 1:2) and spread
        evenly over the ticks."""
        if self.mode != "timer":
            return
        self._bucket.append(float(dt))
        if len(self._bucket) < self.bucket_steps:
            return
        mean = sum(self._bucket) / len(self._bucket)
        self._bucket = []
        per_tick = max(_EPS_S, mean / 3.0 / self.n_ticks)
        self._record([per_tick] * self.n_ticks)

    # ----------------------------------------------------------- analysis --
    # un-folded observations kept at most this many steps: a trainer
    # running without a profile store must not grow memory without bound
    MAX_FRESH = 256

    def _record(self, durs, start_abs: Optional[float] = None) -> None:
        if self.drop_first and not self._dropped:
            self._dropped = True      # first step pays warm-up
            return
        self.steps += 1
        self._fresh.append(durs)
        if len(self._fresh) > self.MAX_FRESH:
            del self._fresh[:-self.MAX_FRESH]
        self._last_ticks = self._stage_ticks(durs)
        self._last_bubble = self._bubble_of(durs)
        if self.sink is not None:
            self.sink(self.steps, start_abs, durs)

    def _active(self, t: int) -> int:
        """Virtual slots doing useful (unmasked) work at tick t."""
        return min(t, self.V - 1) - max(0, t - self.m + 1) + 1

    def _stage_ticks(self, durs: List[float]) -> List[float]:
        """Per-VIRTUAL-slot forward seconds per tick: the mean tick time
        shared equally (JAX's single-process attribution)."""
        mean = sum(durs) / len(durs)
        return [max(_EPS_S, mean / self.V)] * self.V

    def _bubble_of(self, durs: List[float]) -> float:
        """Observed bubble: 1 - activity-weighted busy share of the
        measured tick times."""
        span = sum(durs)
        if span <= 0.0:
            return 0.0
        busy = sum(d * self._active(t) for t, d in enumerate(durs)) / self.V
        return max(0.0, 1.0 - busy / span)

    def stage_ticks(self) -> Optional[List[float]]:
        """Most recent per-VIRTUAL-slot forward tick seconds (virtual
        order), or None before the first kept observation."""
        return list(self._last_ticks) if self._last_ticks else None

    def bubble(self) -> Optional[float]:
        return self._last_bubble

    # --------------------------------------------------------------- fold --
    def fold_into(self, store, device_kinds: Sequence[str], *, arch: str,
                  seq_len: int, tp: int, schedule: str,
                  layers_per_vstage: Sequence[int],
                  padded_per_stage: Sequence[int],
                  micro_bs_per_stage: Sequence[int],
                  stage_scale: Optional[Sequence[float]] = None,
                  stage_obs_scale: Optional[Sequence[float]] = None,
                  stages: Optional[Sequence[int]] = None,
                  bubble: bool = True) -> int:
        """Fold every not-yet-folded step observation into ``store`` as
        ``observed_stage_tick`` / ``observed_bubble`` running means.
        ``device_kinds`` names the device kind hosting each PHYSICAL
        stage; ``padded_per_stage`` its executed layer depth per tick.
        ``stage_scale`` multiplies each physical stage's tick time before
        folding (the straggler injection hook, ``Trainer.inject_degrade``);
        ``stage_obs_scale`` is the total slowdown each stage's fold was
        observed under (default: ``stage_scale``, else 1.0), folded as
        ``obs_scale``.  ``stages`` (default: every stage) and ``bubble``
        pick what this process folds, where each process of a run folds
        its own part of a shared observation.  Returns the number of
        steps folded."""
        folded = 0
        meta_extra = {"telemetry": self.mode,
                      "provenance": ("bucketed" if self.mode == "timer"
                                     else "exact")}
        for durs in self._fresh:
            ticks = self._stage_ticks(durs)
            bub = self._bubble_of(durs)
            for i in (range(self.pp) if stages is None else stages):
                tick_s = sum(ticks[ch * self.pp + i]
                             for ch in range(self.vpp))
                if stage_scale is not None:
                    tick_s *= stage_scale[i]
                obs_sc = (stage_obs_scale[i]
                          if stage_obs_scale is not None
                          else (stage_scale[i] if stage_scale is not None
                                else 1.0))
                layers = sum(layers_per_vstage[ch * self.pp + i]
                             for ch in range(self.vpp))
                e = store.fold(
                    device_kinds[i], "observed_stage_tick",
                    {"arch": arch, "seq_len": seq_len, "tp": tp,
                     "schedule": schedule, "stage": i, "pp": self.pp,
                     "vpp": self.vpp, "layers": layers,
                     "padded_layers": padded_per_stage[i],
                     "micro_bs": micro_bs_per_stage[i]},
                    "tick_s", tick_s, also={"obs_scale": float(obs_sc)})
                e.meta.update(meta_extra)
            for dev in dict.fromkeys(device_kinds if bubble else ()):
                e = store.fold(
                    dev, "observed_bubble",
                    {"arch": arch, "schedule": schedule, "pp": self.pp,
                     "vpp": self.vpp, "m": self.m},
                    "bubble_frac", bub)
                e.meta.update(meta_extra)
            folded += 1
        self._fresh = []
        self._folds += folded
        return folded

    # ----------------------------------------------------------- artifact --
    def to_dict(self) -> Dict:
        return {"pp": self.pp, "vpp": self.vpp, "m": self.m,
                "mode": self.mode, "steps": self.steps,
                "folds": self._folds,
                "stage_ticks": self.stage_ticks(),
                "bubble": self._last_bubble}

    def dump(self, path) -> Path:
        """Write the telemetry snapshot as a JSON artifact."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_dict(), indent=1))
        return path


# ------------------------------------------------------------ the ranks ----
class OpClock:
    """Start and end marks of a rank's schedule ops in one step: CUDA
    events on the card's current stream (read by ``resolve`` after the
    step's own synchronize), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = torch.device(device).type == "cuda"
        self.ops: List[Tuple[Any, Any, Any]] = []   # (label, start, end)
        self.begin = self.end = None

    def now(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def start_step(self) -> None:
        self.ops = []
        self.begin, self.end = self.now(), None

    def op(self, label, start) -> None:
        """Close op ``label`` begun at ``start`` (a ``now()``)."""
        self.ops.append((label, start, self.now()))

    def end_step(self) -> None:
        self.end = self.now()

    def _s(self, a, b) -> float:
        return (a.elapsed_time(b) / 1e3 if self.cuda else b - a)

    def resolve(self) -> Optional[Tuple[List[Tuple[Any, float]], float]]:
        """([(label, seconds)] of every op, the step's span in seconds),
        or None when no step was marked since the last call."""
        if self.begin is None or self.end is None:
            return None
        out = ([(label, self._s(a, b)) for label, a, b in self.ops],
               self._s(self.begin, self.end))
        self.ops, self.begin, self.end = [], None, None
        return out


class RankTelemetry(StageTelemetry):
    """The rank route's recorder (callback mode, ``exact``): a step's
    observation is every stage's forward seconds per microbatch, chunk by
    chunk, and its busy share of the step, as ``observe`` takes them from
    the gathered ``report``s of every rank."""

    def __init__(self, pp: int, vpp: int, m: int, drop_first: bool = True):
        super().__init__(pp, vpp, m, mode="callback", drop_first=drop_first)

    def report(self, stage: int, resolved) -> Dict[str, Any]:
        """This rank's part of a step (``OpClock.resolve``'s result, whose
        labels are ``("F" | "B", chunk, j)``): its stage, each chunk's
        forward seconds per microbatch, and busy and span seconds."""
        ops, span = resolved
        fwd = [0.0] * self.vpp
        for (kind, c, _), s in ops:
            if kind == "F":
                fwd[c] += s / self.m
        return {"stage": stage, "fwd": fwd,
                "busy": sum(s for _, s in ops), "span": span}

    def observe(self, reports: Sequence[Dict[str, Any]]) -> None:
        """Record one step from every rank's ``report`` (each stage's
        ranks averaged): per virtual slot ``c * pp + s`` chunk c's forward
        seconds on stage s, and the bubble ``1 - mean over stages of
        busy / span``."""
        ticks = [0.0] * self.V
        share = [0.0] * self.pp
        count = [0] * self.pp
        for r in reports:
            if r is None:       # a process outside the plan's ranks
                continue
            s = r["stage"]
            count[s] += 1
            share[s] += r["busy"] / max(r["span"], _EPS_S)
            for c, f in enumerate(r["fwd"]):
                ticks[c * self.pp + s] += f
        if min(count) == 0:
            raise ValueError(f"no report of stages "
                             f"{[s for s in range(self.pp) if not count[s]]}")
        ticks = [max(_EPS_S, t / count[vs % self.pp])
                 for vs, t in enumerate(ticks)]
        bubble = 1.0 - sum(b / n for b, n in zip(share, count)) / self.pp
        self._record((ticks, max(0.0, bubble)))

    def _stage_ticks(self, rec) -> List[float]:
        return list(rec[0])

    def _bubble_of(self, rec) -> float:
        return rec[1]
