"""The port's continuous-batching engine on the CPU (fp32 SMOKE model).

  * scheduler invariants and determinism (as tests/test_serve.py:135-180);
  * within the port, engine token streams equal ``decode_sequential``'s,
    greedy and sampled;
  * across frameworks, greedy fp32 token streams equal the JAX engine's on
    the same trace and the same weights (converted by ``from_jax``);
  * disjoint token accounting and the last-position logits contract.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.models import registry as jreg  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve import fixed_batch_occupancy as jax_fixed_occ  # noqa: E402
from repro.serve import scripted_trace as jax_trace  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.serve import (Request, ServeEngine,  # noqa: E402
                               decode_sequential, fixed_batch_occupancy,
                               scripted_trace)
from repro_torch.serve.engine import request_generator, sample  # noqa: E402


def _bundle(seed=0):
    b = registry.get_bundle("llama3-8b", smoke=True)
    return b, b.init(b.cfg, seed=seed, device="cpu")


def _engine(b, params, **kw):
    return ServeEngine(b, params, device="cpu", **kw)


# --------------------------------------------------- scheduler invariants --
def test_scheduler_invariants_seeded_trace():
    b, params = _bundle()
    reqs = scripted_trace(12, vocab_size=b.cfg.vocab_size, seed=3,
                          prompt_lens=(6, 10, 14),
                          gen_lens=(4, 8, 12, 16), arrival_every=1)
    eng = _engine(b, params, max_batch=4, max_len=32)
    for r in reqs:
        eng.submit(r)
    admitted = []
    while not eng.done:
        assert eng.active <= 4
        before = {s.rid for s in eng._slots if s is not None}
        eng.step()
        after = {s.rid for s in eng._slots if s is not None}
        admitted += sorted(after - before)
    rep = eng.run(())
    by_rid = {c.rid: c for c in rep.completions}
    assert sorted(by_rid) == [r.rid for r in reqs]
    for r in reqs:
        assert len(by_rid[r.rid].tokens) == r.max_new_tokens
        assert by_rid[r.rid].admitted_step >= r.arrival
    assert admitted == sorted(admitted)       # FIFO among visible requests
    occ = eng._occ_busy / (eng._occ_steps * 4)
    assert 0.0 < occ <= 1.0
    assert occ > fixed_batch_occupancy(reqs, 4)


def test_scheduler_deterministic():
    b, params = _bundle()
    reqs = scripted_trace(6, vocab_size=b.cfg.vocab_size, seed=1,
                          prompt_lens=(6, 9), gen_lens=(3, 6, 9),
                          arrival_every=1)

    def streams():
        rep = _engine(b, params, max_batch=3, max_len=24, temperature=0.7,
                      seed=11).run(reqs)
        return {c.rid: c.tokens for c in rep.completions}

    assert streams() == streams()


def test_engine_rejects_oversized_and_unported():
    b, params = _bundle()
    eng = _engine(b, params, max_batch=2, max_len=16)
    with pytest.raises(ValueError, match="exceeds the engine max_len"):
        eng.submit(Request(rid=0, prompt=(1,) * 10, max_new_tokens=10))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        registry.get_bundle("whisper-tiny", smoke=True)
    with pytest.raises(ValueError, match="max_batch"):
        _engine(b, params, max_batch=0, max_len=16)


# -------------------------------------------------- engine == sequential --
@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_continuous_batching_matches_sequential(temp):
    """Mixed-length requests staggered into a shared decode batch emit the
    same token streams as decoding each alone at batch 1."""
    b, params = _bundle()
    reqs = scripted_trace(8, vocab_size=b.cfg.vocab_size, seed=5,
                          prompt_lens=(6, 12, 24), gen_lens=(4, 8, 16),
                          arrival_every=1)
    rep = _engine(b, params, max_batch=3, max_len=40, temperature=temp,
                  seed=7).run(reqs)
    want = decode_sequential(b, params, reqs, max_len=40, temperature=temp,
                             seed=7, device="cpu")
    for c in rep.completions:
        assert c.tokens == want[c.rid], f"rid {c.rid} diverged"


def test_sampled_stream_replays_request_generator():
    """Every sample, the prefill token included, draws from the request's
    own generator seeded from (seed, rid)."""
    b, params = _bundle()
    req = Request(rid=42, prompt=(5, 9, 2, 7), max_new_tokens=6)
    got = _engine(b, params, max_batch=1, max_len=16, temperature=0.9,
                  seed=123).run([req]).completions[0].tokens
    cfg = b.cfg
    logits, cache = b.prefill(params, {"tokens": torch.tensor([req.prompt])},
                              cfg, 16)
    gen = request_generator(123, 42)
    expect = []
    for _ in range(6):
        tok = sample(logits[0], gen, 0.9)
        expect.append(tok)
        logits, cache = b.decode_step(params, torch.tensor([[tok]]), cache,
                                      cfg)
    assert got == expect
    a, b2 = request_generator(1, 2), request_generator(1, 3)
    assert torch.rand(4, generator=a).tolist() != \
        torch.rand(4, generator=b2).tolist()


# --------------------------------------------------------- across frameworks
def test_greedy_streams_equal_jax_engine():
    jb = jreg.get_bundle("llama3-8b", smoke=True)
    jp = jb.init(jax.random.PRNGKey(0), jb.cfg)
    b = registry.get_bundle("llama3-8b", smoke=True)
    params = convert.from_jax(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    reqs = scripted_trace(8, vocab_size=256, seed=3)
    jreqs = jax_trace(8, vocab_size=256, seed=3)
    assert [(r.rid, r.prompt, r.max_new_tokens, r.arrival) for r in reqs] \
        == [(r.rid, r.prompt, r.max_new_tokens, r.arrival) for r in jreqs]
    want = JaxServeEngine(jb, jp, max_batch=3, max_len=40).run(jreqs)
    got = _engine(b, params, max_batch=3, max_len=40).run(reqs)
    want_streams = {c.rid: c.tokens for c in want.completions}
    assert {c.rid: c.tokens for c in got.completions} == want_streams
    assert got.decode_steps == want.decode_steps
    assert fixed_batch_occupancy(reqs, 3) == jax_fixed_occ(jreqs, 3)


# ------------------------------------------------ accounting and contract --
def test_report_token_accounting_disjoint():
    b, params = _bundle()
    reqs = scripted_trace(5, vocab_size=b.cfg.vocab_size, seed=0,
                          prompt_lens=(6,), gen_lens=(1, 4, 7),
                          arrival_every=0)
    rep = _engine(b, params, max_batch=2, max_len=16).run(reqs)
    assert rep.tokens_prefill == len(reqs)
    assert rep.tokens_decoded == sum(r.max_new_tokens - 1 for r in reqs)
    d = rep.to_dict()["tokens"]
    assert d["generated"] == d["first_from_prefill"] + d["decoded"]
    for c in rep.completions:
        assert c.n_decoded == len(c.tokens) - 1


def test_last_logits_contract():
    b, params = _bundle()
    cfg = b.cfg
    tokens = torch.randint(0, cfg.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(0))
    logits, _ = b.prefill(params, {"tokens": tokens}, cfg, 16)
    registry.check_last_logits(logits, 2, cfg.vocab_size)
    full, _ = b.forward(params, {"tokens": tokens}, cfg)
    with pytest.raises(ValueError, match="full-sequence"):
        registry.check_last_logits(full, 2, cfg.vocab_size)


def test_fixed_batch_occupancy_oracle():
    reqs = [Request(rid=i, prompt=(1,), max_new_tokens=g, arrival=0)
            for i, g in enumerate((17, 5, 9, 13))]
    assert fixed_batch_occupancy(reqs, 4) == pytest.approx(40 / 64)
    assert fixed_batch_occupancy(reqs, 2) == pytest.approx(40 / 56)
