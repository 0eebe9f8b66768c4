"""Deterministic synthetic token pipeline (port of
``repro/data/pipeline.py``).

numpy only, as in the JAX package, so the port's batches equal JAX's for
the same ``(seed, step)``: batch content is a pure function of (seed,
step, dp rank), the state is just {seed, step}, and a DP replica slices
its rows without coordination.  Tokens follow a zipf-ish unigram over the
vocab, so losses move like text rather than uniform noise.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class DataState:
    seed: int
    step: int

    def to_dict(self) -> Dict[str, int]:
        return {"seed": self.seed, "step": self.step}

    @staticmethod
    def from_dict(d) -> "DataState":
        return DataState(int(d["seed"]), int(d["step"]))


class SyntheticTokens:
    def __init__(self, *, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, family: str = "dense",
                 d_model: int = 0, n_vision_tokens: int = 0):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = global_batch
        self.family = family
        self.d_model = d_model
        self.n_vision = n_vision_tokens
        self.state = DataState(seed, 0)
        # zipf-ish unigram over the vocab (stable across workers)
        r = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = 1.0 / r
        self._p = (p / p.sum()).astype(np.float64)

    def _tokens(self, rng: np.random.Generator, rows: int, cols: int):
        return rng.choice(self.vocab, size=(rows, cols),
                          p=self._p).astype(np.int32)

    def batch_at(self, step: int, *, dp_rank: int = 0, dp_size: int = 1
                 ) -> Dict[str, np.ndarray]:
        """The (deterministic) global batch for ``step``, sliced for this DP
        replica.  rows [rank*B/dp, (rank+1)*B/dp)."""
        assert self.batch % dp_size == 0
        rows = self.batch // dp_size
        rng = np.random.default_rng(
            np.random.SeedSequence([self.state.seed, step, dp_rank]))
        out: Dict[str, np.ndarray] = {}
        s_text = self.seq - (self.n_vision if self.family == "vlm" else 0)
        toks = self._tokens(rng, rows, s_text + 1)
        out["tokens"] = toks[:, :-1]
        if self.family == "vlm":
            out["image_embeds"] = rng.standard_normal(
                (rows, self.n_vision, self.d_model)).astype(np.float32)
            lab = self._tokens(rng, rows, self.seq)
            out["labels"] = lab
        elif self.family == "encdec":
            out["frames"] = rng.standard_normal(
                (rows, self.seq, self.d_model)).astype(np.float32)
            out["tokens"] = self._tokens(rng, rows, self.seq)
            out["labels"] = np.roll(out["tokens"], -1, axis=1)
        else:
            out["labels"] = toks[:, 1:]
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch_at(self.state.step)
            self.state.step += 1

    # ---- elasticity: recompute slicing under a new DP topology ----
    def reshard(self, new_dp_size: int) -> "SyntheticTokens":
        assert self.batch % new_dp_size == 0
        return self  # slicing is an argument of batch_at; nothing stored
