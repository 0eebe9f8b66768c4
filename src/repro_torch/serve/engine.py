"""Continuous-batching serving engine (port of ``repro/serve/engine.py``).

One decode batch of ``max_batch`` slots runs until the queue drains; every
engine step (1) admits queued requests into free slots, each admission a
batch-1 prefill whose cache row is copied into the running batch's cache
at its slot, (2) advances ALL active slots one token in a single batched
``decode_step`` with per-slot positions, and (3) evicts finished
sequences, freeing their slots for the next admission.

Correctness contract (tests/test_torch_serve.py): a request's token stream
equals decoding it ALONE at batch 1 (``decode_sequential``), greedy and
sampled, and greedy fp32 streams equal the JAX engine's on the same trace
and weights.

Sampling: one ``torch.Generator`` per request, seeded from (seed, rid), so
a request's stream does not depend on what else shares the batch.  Samples
are drawn on the host from the logits row; they differ from JAX's
(another generator), greedy streams do not.

Timing accounting as in the JAX engine: TTFT is wall-clock from a request
becoming visible to its first token (queue wait + prefill + sample); TPOT
divides each request's summed decode-step time by its DECODED token count
(the prefill token is never a decoded token); host sampling time is kept
apart in ``ServeReport.sample_time_s``.  Device work is synchronized at the
end of every timed section.

``metrics`` (``repro_torch.obs.metrics.MetricsLog``, or any sink with its
``gauge``/``count``/``observe``/``flush``) receives queue-depth and
occupancy gauges and TTFT/TPOT observations, flushed once per engine
step.  ``replanner`` (``DriftReplanner``) is consulted after every
``replan_check_every``-th completion with the observed traffic profile,
as in the JAX engine.

The enc-dec and VLM families are refused, with JAX's reason: they are
served through their bundle's ``prefill`` and ``decode_step`` over a
batch, as the JAX package serves them.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.plan import TrafficProfile
from repro_torch.models import registry
from repro_torch.utils.device import DeviceLike, resolve_device, synchronize

SERVABLE_FAMILIES = ("dense", "moe", "ssm", "hybrid")


@dataclasses.dataclass(frozen=True)
class Request:
    rid: int
    prompt: Tuple[int, ...]
    max_new_tokens: int
    arrival: int = 0      # earliest engine step at which admission may occur

    def __post_init__(self):
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid}: max_new_tokens >= 1 "
                             f"required, got {self.max_new_tokens}")
        if not self.prompt:
            raise ValueError(f"request {self.rid}: empty prompt")


@dataclasses.dataclass
class Completion:
    rid: int
    prompt_len: int
    tokens: List[int]          # generated tokens, first one from prefill
    ttft_s: float              # queue wait + prefill + first sample
    decode_time_s: float       # summed decode-step time while active
    admitted_step: int
    finished_step: int

    @property
    def n_decoded(self) -> int:
        """Tokens produced by decode steps (excludes the prefill token)."""
        return len(self.tokens) - 1

    @property
    def tpot_s(self) -> float:
        """Per-output-token decode latency (no sampling time)."""
        return self.decode_time_s / max(self.n_decoded, 1)


@dataclasses.dataclass
class ServeReport:
    completions: List[Completion]
    steps: int
    occupancy: float             # mean active/max_batch over decode steps
    fixed_batch_occupancy: float  # fixed batches on the same trace
    decode_steps: int
    decode_time_s: float
    prefill_time_s: float
    sample_time_s: float
    tokens_prefill: int          # first tokens (one per request)
    tokens_decoded: int
    replans: int = 0

    @property
    def decode_tok_per_s(self) -> float:
        return self.tokens_decoded / max(self.decode_time_s, 1e-9)

    @property
    def ttft_s(self) -> List[float]:
        return [c.ttft_s for c in self.completions]

    @property
    def tpot_s(self) -> List[float]:
        return [c.tpot_s for c in self.completions]

    def to_dict(self) -> Dict[str, Any]:
        ttft, tpot = self.ttft_s, self.tpot_s
        return {
            "requests": len(self.completions),
            "steps": self.steps,
            "occupancy": self.occupancy,
            "fixed_batch_occupancy": self.fixed_batch_occupancy,
            "ttft_s": _stats(ttft),
            "tpot_s": _stats(tpot),
            "decode_tok_per_s": self.decode_tok_per_s,
            "decode_steps": self.decode_steps,
            # the first token of every request comes from prefill, never
            # from a decode step: the two counts are disjoint
            "tokens": {"first_from_prefill": self.tokens_prefill,
                       "decoded": self.tokens_decoded,
                       "generated": self.tokens_prefill
                       + self.tokens_decoded},
            "prefill_time_s": self.prefill_time_s,
            "decode_time_s": self.decode_time_s,
            "sample_time_s": self.sample_time_s,
            "replans": self.replans,
        }


def _stats(xs: List[float]) -> Dict[str, float]:
    """Mean, median and max over requests, unrounded."""
    if not xs:
        return {}
    return {"mean": float(np.mean(xs)), "median": float(np.median(xs)),
            "max": float(np.max(xs))}


@dataclasses.dataclass
class _Active:
    """One occupied slot."""
    rid: int
    prompt_len: int
    remaining: int
    tokens: List[int]
    gen: torch.Generator
    next_token: int
    decode_time_s: float
    ttft_s: float
    admitted_step: int


def fixed_batch_occupancy(requests: Sequence[Request],
                          max_batch: int) -> float:
    """Decode-slot occupancy that fixed batching achieves on the same
    trace: requests grouped in submission order into batches of
    ``max_batch``; every group decodes until its LONGEST member finishes
    (no mid-group refill).  The denominator uses each group's actual
    width (no penalty for a ragged final group)."""
    busy = idle_capacity = 0
    reqs = list(requests)
    for i in range(0, len(reqs), max_batch):
        group = reqs[i:i + max_batch]
        steps = max(r.max_new_tokens - 1 for r in group)
        busy += sum(r.max_new_tokens - 1 for r in group)
        idle_capacity += steps * len(group)
    return busy / idle_capacity if idle_capacity else 1.0


def request_generator(seed: int, rid: int) -> torch.Generator:
    """The host generator of one request, a function of (seed, rid)."""
    digest = hashlib.sha256(f"{seed}:{rid}".encode()).digest()
    gen = torch.Generator()
    gen.manual_seed(int.from_bytes(digest[:8], "little") >> 1)
    return gen


def sample(logits_row: torch.Tensor, gen: torch.Generator,
           temperature: float) -> int:
    """Greedy argmax (first maximum, as jnp.argmax) at temperature <= 0,
    else a categorical draw from softmax(logits / temperature)."""
    if temperature <= 0:
        return int(torch.argmax(logits_row))
    probs = torch.softmax(logits_row.float().cpu() / temperature, dim=-1)
    return int(torch.multinomial(probs, 1, generator=gen))


def _check_params_device(params: dict, device: torch.device) -> None:
    if params["embed"].device != device:
        raise ValueError(f"params live on {params['embed'].device}, the "
                         f"engine runs on {device}")


class ServeEngine:
    """See module docstring."""

    def __init__(self, bundle: registry.ArchBundle, params: dict, *,
                 max_batch: int, max_len: int, temperature: float = 0.0,
                 seed: int = 0, eos_id: Optional[int] = None,
                 metrics=None, replanner: Optional["DriftReplanner"] = None,
                 replan_check_every: int = 4, device: DeviceLike = None):
        cfg = bundle.cfg
        if cfg.family not in SERVABLE_FAMILIES:
            raise ValueError(
                f"ServeEngine serves token-in/token-out families "
                f"{SERVABLE_FAMILIES}; {cfg.name} is {cfg.family!r} "
                "(enc-dec needs a cross-attention cache and the VLM stub "
                "an image-embed prompt — neither fits per-slot admission)")
        self.device = resolve_device(device)
        if max_batch < 1:
            raise ValueError(f"max_batch >= 1 required, got {max_batch}")
        _check_params_device(params, self.device)
        self.bundle = bundle
        self.cfg = bundle.cfg
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.temperature = temperature
        self.seed = seed
        self.eos_id = eos_id
        self.metrics = metrics
        self.replanner = replanner
        self.replan_check_every = replan_check_every
        self.replan_events: List[Dict[str, Any]] = []

        cache = bundle.init_cache(max_batch, max_len, self.device)
        # per-slot positions: every row of the decode batch advances alone
        cache["pos"] = torch.zeros((max_batch,), dtype=torch.int64,
                                   device=self.device)
        self._cache = cache
        self._checked = {"prefill": False, "decode": False}

        self._queue: deque = deque()
        self._visible_at: Dict[int, float] = {}   # rid -> wall time seen
        self._slots: List[Optional[_Active]] = [None] * max_batch
        self.steps = 0
        self.completions: List[Completion] = []
        # accounting
        self._occ_busy = 0
        self._occ_steps = 0
        self._prefill_time = 0.0
        self._decode_time = 0.0
        self._sample_time = 0.0
        self._tokens_decoded = 0
        self._prompt_tokens = 0
        self._gen_tokens = 0
        self._t_start = time.perf_counter()

    # ------------------------------------------------------------ public --
    def submit(self, request: Request) -> None:
        if len(request.prompt) + request.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {request.rid}: prompt ({len(request.prompt)}) + "
                f"max_new_tokens ({request.max_new_tokens}) exceeds the "
                f"engine max_len={self.max_len}")
        self._queue.append(request)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def active(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def done(self) -> bool:
        return not self._queue and self.active == 0

    def observed_traffic(self) -> TrafficProfile:
        """The traffic mix actually served so far: what the drift
        detector compares against the planned profile."""
        n = max(len(self.completions), 1)
        elapsed = max(time.perf_counter() - self._t_start, 1e-9)
        return TrafficProfile(
            prompt_len=max(1, round(self._prompt_tokens / n)),
            gen_len=max(1, round(self._gen_tokens / n)),
            request_rate=len(self.completions) / elapsed)

    def step(self) -> List[Completion]:
        """One scheduler iteration: admit, batched decode, evict.
        Returns the requests that finished this step."""
        now = time.perf_counter()
        for r in self._queue:
            if r.arrival <= self.steps and r.rid not in self._visible_at:
                self._visible_at[r.rid] = now
        self._admit_all()
        finished = self._decode_active()
        self.steps += 1
        if self.metrics is not None:
            self.metrics.gauge("serve_queue_depth", self.queue_depth)
            self.metrics.gauge("serve_active", self.active)
            self.metrics.gauge("serve_occupancy",
                               self.active / self.max_batch)
            self.metrics.flush(self.steps)
        if finished and self.replanner is not None and \
                len(self.completions) % self.replan_check_every == 0:
            ev = self.replanner.check(self.observed_traffic())
            if ev is not None:
                self.replan_events.append(ev)
                if self.metrics is not None:
                    self.metrics.count("serve_replans")
        return finished

    def run(self, requests: Sequence[Request] = (),
            max_steps: int = 100_000) -> ServeReport:
        """Serve ``requests`` (plus anything already queued) to
        completion and report."""
        all_reqs = list(requests)
        for r in all_reqs:
            self.submit(r)
        while not self.done:
            if self.steps >= max_steps:
                raise RuntimeError(f"engine exceeded max_steps={max_steps} "
                                   f"with {self.queue_depth} queued / "
                                   f"{self.active} active")
            self.step()
        if self.metrics is not None:
            self.metrics.flush(self.steps)
        occ = (self._occ_busy / (self._occ_steps * self.max_batch)
               if self._occ_steps else 0.0)
        return ServeReport(
            completions=list(self.completions), steps=self.steps,
            occupancy=occ,
            fixed_batch_occupancy=fixed_batch_occupancy(
                all_reqs, self.max_batch) if all_reqs else 0.0,
            decode_steps=self._occ_steps, decode_time_s=self._decode_time,
            prefill_time_s=self._prefill_time,
            sample_time_s=self._sample_time,
            tokens_prefill=len(self.completions),
            tokens_decoded=self._tokens_decoded,
            replans=len(self.replan_events))

    # --------------------------------------------------------- internals --
    def _insert_row(self, part: dict, slot: int) -> None:
        """Copy a batch-1 prefill cache into row ``slot`` of the batched
        cache, in place.  Every non-``pos`` leaf carries batch on axis 1
        (layer-stacked); ``pos`` is the per-slot position vector."""
        def copy(full, one):
            if isinstance(full, dict):
                for key in full:
                    copy(full[key], one[key])
            else:
                full[:, slot].copy_(one[:, 0])

        for key, val in self._cache.items():
            if key == "pos":
                val[slot] = part["pos"]
            else:
                copy(val, part[key])

    def _admit_all(self) -> None:
        while True:
            slot = next((i for i, s in enumerate(self._slots)
                         if s is None), None)
            if slot is None:
                return
            req = next((r for r in self._queue
                        if r.arrival <= self.steps), None)
            if req is None:
                return
            self._queue.remove(req)
            self._admit(req, slot)

    def _admit(self, req: Request, slot: int) -> None:
        t0 = time.perf_counter()
        toks = torch.tensor([req.prompt], dtype=torch.int64,
                            device=self.device)
        logits, cache1 = self.bundle.prefill(
            self.params, {"tokens": toks}, self.cfg, self.max_len)
        synchronize(self.device)
        t_prefill = time.perf_counter() - t0
        self._prefill_time += t_prefill
        if not self._checked["prefill"]:
            registry.check_last_logits(logits, 1, self.cfg.vocab_size,
                                       "prefill")
            self._checked["prefill"] = True
        gen = request_generator(self.seed, req.rid)
        ts0 = time.perf_counter()
        first = sample(logits[0], gen, self.temperature)
        self._sample_time += time.perf_counter() - ts0
        self._insert_row(cache1, slot)
        ttft = time.perf_counter() - self._visible_at.get(req.rid, t0)
        self._slots[slot] = _Active(
            rid=req.rid, prompt_len=len(req.prompt),
            remaining=req.max_new_tokens - 1, tokens=[first], gen=gen,
            next_token=first, decode_time_s=0.0, ttft_s=ttft,
            admitted_step=self.steps)
        self._prompt_tokens += len(req.prompt)
        if self.metrics is not None:
            self.metrics.observe("serve_ttft_s", ttft)
            self.metrics.count("serve_requests_admitted")
            self.metrics.count("serve_tokens_prefill", len(req.prompt))
        if self.eos_id is not None and first == self.eos_id:
            self._slots[slot].remaining = 0
        if self._slots[slot].remaining == 0:
            self._finish(slot)

    def _decode_active(self) -> List[Completion]:
        rows = [i for i, s in enumerate(self._slots) if s is not None]
        if not rows:
            return []
        toks = np.zeros((self.max_batch, 1), np.int64)
        for i in rows:
            toks[i, 0] = self._slots[i].next_token
        t0 = time.perf_counter()
        logits, self._cache = self.bundle.decode_step(
            self.params, torch.from_numpy(toks).to(self.device),
            self._cache, self.cfg)
        synchronize(self.device)
        dt = time.perf_counter() - t0
        if not self._checked["decode"]:
            registry.check_last_logits(logits, self.max_batch,
                                       self.cfg.vocab_size, "decode_step")
            self._checked["decode"] = True
        self._decode_time += dt
        self._occ_steps += 1
        self._occ_busy += len(rows)
        self._tokens_decoded += len(rows)
        finished = []
        ts0 = time.perf_counter()
        for i in rows:
            s = self._slots[i]
            tok = sample(logits[i], s.gen, self.temperature)
            s.tokens.append(tok)
            s.next_token = tok
            s.decode_time_s += dt
            s.remaining -= 1
            if s.remaining == 0 or (self.eos_id is not None
                                    and tok == self.eos_id):
                finished.append(self._finish(i))
        self._sample_time += time.perf_counter() - ts0
        return finished

    def _finish(self, slot: int) -> Completion:
        s = self._slots[slot]
        self._slots[slot] = None
        comp = Completion(
            rid=s.rid, prompt_len=s.prompt_len, tokens=s.tokens,
            ttft_s=s.ttft_s, decode_time_s=s.decode_time_s,
            admitted_step=s.admitted_step, finished_step=self.steps)
        self.completions.append(comp)
        self._gen_tokens += len(s.tokens)
        if self.metrics is not None:
            if comp.n_decoded:
                self.metrics.observe("serve_tpot_s", comp.tpot_s)
            self.metrics.count("serve_requests_completed")
            self.metrics.count("serve_tokens_decoded", comp.n_decoded)
        return comp


def decode_sequential(bundle: registry.ArchBundle, params: dict,
                      requests: Sequence[Request], *, max_len: int,
                      temperature: float = 0.0, seed: int = 0,
                      eos_id: Optional[int] = None,
                      device: DeviceLike = None) -> Dict[int, List[int]]:
    """Reference decoder: each request ALONE at batch 1, with the same
    per-request generators as the engine; the oracle its streams must
    match."""
    dev = resolve_device(device)
    _check_params_device(params, dev)
    cfg = bundle.cfg
    out: Dict[int, List[int]] = {}
    for req in requests:
        toks = torch.tensor([req.prompt], dtype=torch.int64, device=dev)
        logits, cache = bundle.prefill(params, {"tokens": toks}, cfg,
                                       max_len)
        gen = request_generator(seed, req.rid)
        tokens = [sample(logits[0], gen, temperature)]
        while len(tokens) < req.max_new_tokens and \
                (eos_id is None or tokens[-1] != eos_id):
            step_tok = torch.tensor([[tokens[-1]]], dtype=torch.int64,
                                    device=dev)
            logits, cache = bundle.decode_step(params, step_tok, cache, cfg)
            tokens.append(sample(logits[0], gen, temperature))
        out[req.rid] = tokens
    return out


class DriftReplanner:
    """Traffic-mix drift -> serving replan (a copy of the JAX package's).

    Thresholds the observed prefill/decode ratio against the planned
    profile's: when the served mix is ``threshold``x more prefill-heavy
    (or decode-heavy) than planned, call ``replan_fn(observed)``
    (typically a ``core.planner.plan_serving`` closure) and surface the
    event.  Re-arms only after the plan is refreshed, so a sustained
    drift fires once, not every check."""

    def __init__(self, planned: TrafficProfile,
                 replan_fn: Callable[[TrafficProfile], Any],
                 threshold: float = 1.5):
        if threshold <= 1.0:
            raise ValueError(f"threshold > 1 required, got {threshold}")
        self.planned = planned
        self.replan_fn = replan_fn
        self.threshold = threshold
        self.fired: List[Dict[str, Any]] = []

    def check(self, observed: TrafficProfile) -> Optional[Dict[str, Any]]:
        ratio = (observed.prefill_decode_ratio
                 / max(self.planned.prefill_decode_ratio, 1e-9))
        if 1.0 / self.threshold < ratio < self.threshold:
            return None
        result = self.replan_fn(observed)
        event = {
            "kind": "serve_replan",
            "drift_ratio": ratio,
            "direction": ("prefill-heavy" if ratio >= self.threshold
                          else "decode-heavy"),
            "planned": self.planned.to_dict(),
            "observed": observed.to_dict(),
            "plan": (result.plan.to_dict()
                     if hasattr(result, "plan") else None),
        }
        # re-arm against the new baseline: the observed mix becomes the
        # planned one the next drift is measured from
        self.planned = observed
        self.fired.append(event)
        return event
