"""Scripted request traces for the serving engine (copy of
``repro/serve/trace.py``).

Python's ``random`` only, so one seed gives the same trace here as in the
JAX package: the cross-framework serving tests rely on it.
"""
from __future__ import annotations

import random
from typing import Sequence, Tuple

from repro_torch.serve.engine import Request


def scripted_trace(n: int, *, vocab_size: int, seed: int = 0,
                   prompt_lens: Sequence[int] = (8, 12, 16),
                   gen_lens: Sequence[int] = (4, 8, 12, 16),
                   arrival_every: int = 1) -> Tuple[Request, ...]:
    """``n`` requests with prompt/generation lengths drawn from the given
    sets and one request becoming visible every ``arrival_every`` engine
    steps (arrival_every=0: all at step 0).  Token ids, lengths and
    arrivals are all functions of ``seed`` only."""
    rng = random.Random(seed)
    out = []
    for rid in range(n):
        plen = rng.choice(list(prompt_lens))
        out.append(Request(
            rid=rid,
            prompt=tuple(rng.randrange(vocab_size) for _ in range(plen)),
            max_new_tokens=rng.choice(list(gen_lens)),
            arrival=rid * arrival_every))
    return tuple(out)
