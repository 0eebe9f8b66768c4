"""Pipeline stage segmentation: uniform vs non-uniform (paper's rule 1).

The port's copy of ``repro/core/segmentation.py``: the same arithmetic in the
same order, held exactly equal to it by ``tests/test_torch_planner.py``.

Non-uniform segmentation assigns layers proportionally to each stage's
*compute speed* (accelerators-per-stage x per-accelerator effective TFLOPs),
so faster stages hold more layers — e.g. the paper's `766667777777` split of
80 layers over PP=12 on the AMD+C cluster.

``dp_split`` is the exact optimizer over the same space: it minimizes the
bottleneck per-stage time (per-layer compute time x layers + constant
offsets such as the boundary P2P send and the last stage's unembedding),
fed with per-stage per-layer times from whatever ``CostSource`` the planner
is running — so with a measured profile the split reacts to real kernel
behaviour rather than nameplate TFLOPs.
"""
from __future__ import annotations

import heapq
from typing import List, Optional, Sequence

import numpy as np


def uniform_split(n_layers: int, pp: int) -> List[int]:
    base, rem = divmod(n_layers, pp)
    return [base + (1 if i < rem else 0) for i in range(pp)]


def nonuniform_split(n_layers: int, speeds: Sequence[float]) -> List[int]:
    """Largest-remainder apportionment of layers ∝ stage speed, min 1."""
    pp = len(speeds)
    assert n_layers >= pp
    tot = float(sum(speeds))
    quota = [n_layers * s / tot for s in speeds]
    base = [max(1, int(q)) for q in quota]
    # fix overflow caused by the min-1 floor: shrink the most over-quota
    # stage that still has layers to give
    while sum(base) > n_layers:
        cands = [j for j in range(pp) if base[j] > 1]
        if not cands:  # pragma: no cover - pp > n_layers, guarded above
            break
        i = max(cands, key=lambda j: base[j] - quota[j])
        base[i] -= 1
    rem = n_layers - sum(base)
    order = sorted(range(pp), key=lambda i: quota[i] - base[i], reverse=True)
    for i in range(rem):
        base[order[i % pp]] += 1
    return base


def dp_split(n_layers: int, per_layer: Sequence[float],
             offsets: Optional[Sequence[float]] = None,
             max_layers: Optional[Sequence[int]] = None) -> List[int]:
    """Exact min-bottleneck layer assignment over pp pipeline stages.

    Minimizes ``max_i(split[i] * per_layer[i] + offsets[i])`` subject to
    ``sum(split) == n_layers``, ``1 <= split[i] <= max_layers[i]``.  The
    optimal bottleneck is always some stage's cost at an integer layer
    count, so binary-search the sorted candidate set
    ``{l * t_i + o_i : 1 <= l <= L}`` with a greedy feasibility check
    (capacity fill): T is feasible iff every stage can hold >= 1 layer
    under T and the capacities sum to >= n_layers.

    Within the optimal bottleneck, remaining layers go greedily to the
    stage whose next-layer cost is lowest, so secondary stages stay
    balanced too (the pipeline's non-bottleneck bubble shrinks).
    """
    pp = len(per_layer)
    assert n_layers >= pp, "need at least one layer per stage"
    t = np.asarray(per_layer, dtype=float)
    o = (np.zeros(pp) if offsets is None
         else np.asarray(offsets, dtype=float))
    assert np.all(t > 0), "per-layer times must be positive"
    hi = (np.full(pp, n_layers) if max_layers is None
          else np.minimum(np.asarray(max_layers), n_layers))
    assert np.all(hi >= 1) and hi.sum() >= n_layers, \
        "max_layers admits no feasible split"

    def caps(T: float) -> np.ndarray:
        # 1e-12 relative slop: T is itself a candidate l*t+o and must
        # admit that very l despite float roundoff
        c = np.floor((T - o) / t * (1 + 1e-12) + 1e-12).astype(int)
        return np.minimum(np.maximum(c, 0), hi)

    cand = np.unique((np.arange(1, n_layers + 1)[:, None] * t + o).ravel())
    lo_i, hi_i = 0, len(cand) - 1
    while lo_i < hi_i:                      # smallest feasible bottleneck
        mid = (lo_i + hi_i) // 2
        c = caps(cand[mid])
        if c.min() >= 1 and c.sum() >= n_layers:
            hi_i = mid
        else:
            lo_i = mid + 1
    cap = caps(cand[lo_i])
    split = [1] * pp
    heap = [(2 * t[i] + o[i], i) for i in range(pp) if cap[i] > 1]
    heapq.heapify(heap)
    for _ in range(n_layers - pp):
        cost, i = heapq.heappop(heap)
        split[i] += 1
        if split[i] < cap[i]:
            heapq.heappush(heap, ((split[i] + 1) * t[i] + o[i], i))
    return split


def cp_split(seq_len: int, cp: int, attn: float, lin: float = 0.0,
             rates: Optional[Sequence[float]] = None,
             causal: bool = True) -> List[int]:
    """Exact min-bottleneck sequence-chunk assignment over cp ring ranks —
    ``dp_split`` applied to the context axis (HexiSeq).

    Ring rank r holds the contiguous token chunk ``[b_{r-1}, b_r)`` where
    ``b_r = sum(split[:r+1])``.  Under causal ring attention, rank r's
    queries attend to every token up to its own chunk end, so its cost is

        ``cost_r = rates[r] * split[r] * (lin + attn * b_r)``   (causal)
        ``cost_r = rates[r] * split[r] * (lin + attn * seq_len)``  (full)

    with ``lin`` the per-token linear/MLP weight, ``attn`` the
    per-query-token-per-kv-token attention weight, and ``rates`` optional
    per-rank slowdown factors (a heterogeneous ring: slower device kinds
    get shorter chunks).  Minimizes ``max_r cost_r`` subject to
    ``sum(split) == seq_len``, ``split[r] >= 1``.

    The causal objective is order-dependent (later ranks see longer
    prefixes), so unlike ``dp_split`` the optimum is found by parametric
    search: binary-search the bottleneck T with a greedy-maximal-prefix
    feasibility check (taking the largest feasible chunk at each rank is
    optimal because a unit of extra prefix costs downstream ranks strictly
    less than one token of capacity).  With equal rates and causal=True
    the optimal chunks DECREASE along the ring — the causal triangle makes
    even a homogeneous ring want unequal chunks.
    """
    assert seq_len >= cp, "need at least one token per ring rank"
    assert attn >= 0.0 and lin >= 0.0 and (attn > 0.0 or lin > 0.0)
    r_ = ([1.0] * cp if rates is None else [float(x) for x in rates])
    assert len(r_) == cp and all(x > 0 for x in r_)
    if not causal:
        # every rank sees the full kv context: constant per-token cost,
        # so this is plain rate-proportional balancing
        attn_eff = [attn * seq_len] * cp
    else:
        attn_eff = None

    def caps(T: float) -> Optional[List[int]]:
        """Greedy maximal chunks under bottleneck T (None = infeasible)."""
        out, b = [], 0
        for rank in range(cp):
            if attn_eff is not None:
                per_tok = r_[rank] * (lin + attn_eff[rank])
                c = int((T / per_tok) * (1 + 1e-12)) if per_tok > 0 \
                    else seq_len
            elif attn == 0.0:
                c = int((T / (r_[rank] * lin)) * (1 + 1e-12))
            else:
                # rate * c * (lin + attn*(b + c)) <= T, largest integer c
                p = lin + attn * b
                disc = p * p + 4.0 * attn * T / r_[rank]
                c = int(((-p + disc ** 0.5) / (2.0 * attn)) * (1 + 1e-12))
            # clamp so every later rank keeps room for >= 1 token; the
            # clamp only shrinks prefixes, so downstream caps only grow
            c = min(c, seq_len - b - (cp - rank - 1))
            if c < 1:
                return None
            out.append(c)
            b += c
        if b < seq_len:
            return None
        return out

    lo, hi = 0.0, max(r_) * seq_len * (lin + attn * seq_len)
    assert caps(hi) is not None
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if mid <= lo or mid >= hi:
            break
        if caps(mid) is None:
            lo = mid
        else:
            hi = mid
    split = caps(hi)
    assert sum(split) == seq_len and all(c >= 1 for c in split)
    return split


def rebalance(split: List[int], stage_times: Sequence[float],
              max_moves: int = 64) -> List[int]:
    """Greedy load-balance refinement (rule 1): move one layer at a time from
    the slowest-per-layer-normalized max stage to the min stage while the
    bottleneck improves.  ``stage_times`` are per-layer-proportional times."""
    split = list(split)
    per_layer = [t / max(l, 1) for t, l in zip(stage_times, split)]
    for _ in range(max_moves):
        times = [p * l for p, l in zip(per_layer, split)]
        hi = max(range(len(split)), key=lambda i: times[i])
        lo = min(range(len(split)), key=lambda i: times[i])
        if split[hi] <= 1:
            break
        new_hi = per_layer[hi] * (split[hi] - 1)
        new_lo = per_layer[lo] * (split[lo] + 1)
        if max(new_hi, new_lo, *(times[i] for i in range(len(split))
                                 if i not in (hi, lo))) >= times[hi]:
            break
        split[hi] -= 1
        split[lo] += 1
    return split
