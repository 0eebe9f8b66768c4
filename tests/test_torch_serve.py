"""The port's continuous-batching engine on the CPU (fp32 SMOKE model).

  * scheduler invariants and determinism (as tests/test_serve.py:135-180);
  * within the port, engine token streams equal ``decode_sequential``'s,
    greedy and sampled;
  * across frameworks, greedy fp32 token streams equal the JAX engine's on
    the same trace and the same weights (converted by ``from_jax``);
  * disjoint token accounting and the last-position logits contract;
  * the serving planner's drift loop: ``DriftReplanner``'s events equal
    JAX's on one sequence of profiles (plans from either package's
    ``plan_serving``), the engine's replan loop, its ``observed_traffic``
    equal to the JAX engine's on the same trace;
  * the CLI's ``--plan --metrics-out --prom-out``: its metrics stream has
    the JAX CLI's records on the same arguments (timestamps and values
    masked) and passes ``tools/validate_serve.py``.
"""
import collections
import json
import subprocess
import sys
from pathlib import Path

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

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's in-process port code (SMOKE
    sizes gain nothing from more), so that test workers running side by
    side do not oversubscribe the host's cores; restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


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
    wb = registry.get_bundle("whisper-tiny", smoke=True)
    with pytest.raises(ValueError, match="enc-dec"):
        ServeEngine(wb, None, max_batch=2, max_len=16, device="cpu")
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


# ------------------------------------------------------------ drift loop ---
def _planners():
    """Each package's plan_serving on the demo cluster for llama3-8b's
    FULL config, as the serve CLIs run it."""
    from repro.core import planner as jplanner
    from repro.core.plan import ServingSLO as JSLO
    from repro.launch.serve import demo_asymmetric_cluster as jcluster
    from repro_torch.core import planner
    from repro_torch.core.plan import ServingSLO
    from repro_torch.launch.serve import demo_asymmetric_cluster

    jcfg, cfg = jreg.get_config("llama3-8b"), registry.get_config(
        "llama3-8b")
    jcl, cl = jcluster(), demo_asymmetric_cluster()

    def jax_replan(obs):
        return jplanner.plan_serving(jcl, jcfg, slo=JSLO(0.5, 0.05),
                                     traffic=obs)

    def port_replan(obs):
        return planner.plan_serving(cl, cfg, slo=ServingSLO(0.5, 0.05),
                                    traffic=obs)

    return jax_replan, port_replan


def test_drift_replanner_events_equal_jax():
    """One sequence of observed mixes through both replanners: the same
    checks fire, in the same direction, re-arm on the same baselines, and
    carry equal plans (each from its own package's plan_serving)."""
    from repro.core.plan import TrafficProfile as JTraffic
    from repro.serve import DriftReplanner as JaxDrift
    from repro_torch.core.plan import TrafficProfile
    from repro_torch.serve import DriftReplanner

    jax_replan, port_replan = _planners()
    mixes = [(128, 128, 1.0), (160, 128, 1.0), (512, 128, 2.0),
             (512, 128, 2.0), (128, 256, 4.0), (130, 250, 4.0),
             (2048, 16, 8.0), (64, 512, 0.5), (64, 512, 0.5)]
    jrp = JaxDrift(JTraffic(*mixes[0]), jax_replan, threshold=1.5)
    rp = DriftReplanner(TrafficProfile(*mixes[0]), port_replan,
                        threshold=1.5)
    fired = 0
    for m in mixes[1:]:
        want = jrp.check(JTraffic(*m))
        got = rp.check(TrafficProfile(*m))
        assert got == want, m
        fired += got is not None
        assert rp.planned.to_dict() == jrp.planned.to_dict()
    assert fired == 4 and rp.fired == jrp.fired
    assert {e["direction"] for e in rp.fired} == {"prefill-heavy",
                                                  "decode-heavy"}
    assert all(e["plan"] is not None for e in rp.fired)
    with pytest.raises(ValueError, match="threshold"):
        DriftReplanner(TrafficProfile(*mixes[0]), port_replan, threshold=1.0)


def _without_rate(ev):
    """A replan event without what the wall clock decides: the observed
    request rate and the plan searched for it."""
    return {k: ({kk: vv for kk, vv in v.items() if kk != "request_rate"}
                if k in ("planned", "observed") else v)
            for k, v in ev.items() if k != "plan"}


def test_engine_replan_loop_matches_jax_engine():
    """tests/test_serve.py's end-to-end loop on both engines: plan for a
    decode-heavy mix, serve a prefill-heavy trace; the port's engine
    fires the same events (rates masked), each with a plan, and its
    observed prompt and generation lengths equal the JAX engine's."""
    from repro.core.plan import TrafficProfile as JTraffic
    from repro.serve import DriftReplanner as JaxDrift
    from repro_torch.core.plan import TrafficProfile
    from repro_torch.serve import DriftReplanner

    jax_replan, port_replan = _planners()
    jb = jreg.get_bundle("llama3-8b", smoke=True)
    jp = jb.init(jax.random.PRNGKey(0), jb.cfg)
    b = registry.get_bundle("llama3-8b", smoke=True)
    params = convert.from_jax(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    kw = dict(prompt_lens=(24,), gen_lens=(3,), arrival_every=1)
    jeng = JaxServeEngine(jb, jp, max_batch=3, max_len=32,
                          replanner=JaxDrift(JTraffic(4, 16, 1.0),
                                             jax_replan, threshold=1.5),
                          replan_check_every=2)
    jrep = jeng.run(jax_trace(6, vocab_size=256, seed=0, **kw))
    eng = _engine(b, params, max_batch=3, max_len=32,
                  replanner=DriftReplanner(TrafficProfile(4, 16, 1.0),
                                           port_replan, threshold=1.5),
                  replan_check_every=2)
    rep = eng.run(scripted_trace(6, vocab_size=256, seed=0, **kw))
    assert rep.replans == jrep.replans >= 1
    assert rep.to_dict()["replans"] == rep.replans
    ev = eng.replan_events[0]
    assert ev["kind"] == "serve_replan" and ev["direction"] == "prefill-heavy"
    assert ev["plan"] is not None
    assert [_without_rate(e) for e in eng.replan_events] == \
        [_without_rate(e) for e in jeng.replan_events]
    got, want = eng.observed_traffic(), jeng.observed_traffic()
    assert (got.prompt_len, got.gen_len) == (want.prompt_len, want.gen_len)
    assert got.request_rate > 0


def _records_by_kind_and_name(path):
    """(kind, name) -> count over a metrics stream: what the run recorded,
    timestamps and values masked."""
    recs = [json.loads(x) for x in Path(path).read_text().splitlines()
            if x.strip()]
    return collections.Counter((r["kind"], r.get("name")) for r in recs)


def test_cli_plan_and_metrics_match_jax_cli(tmp_path, monkeypatch, capsys):
    """Both serve CLIs with --smoke --plan --metrics-out --prom-out at the
    default 12 requests: the same (kind, name) record counts, the same
    plan, a summary with run_id, plan and replans, and the port's
    artifacts pass tools/validate_serve.py."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve

    def flags(tag):
        return ["--smoke", "--plan", "--metrics-out",
                str(tmp_path / f"{tag}.jsonl"), "--prom-out",
                str(tmp_path / f"{tag}.prom")]

    monkeypatch.setattr(sys, "argv", ["serve", *flags("jax")])
    jserve.main()
    jout = capsys.readouterr().out.strip().splitlines()
    serve.main(["--device", "cpu", *flags("port")])
    out = capsys.readouterr().out.strip().splitlines()
    (tmp_path / "port.log").write_text("\n".join(out) + "\n")

    assert out[0].startswith("serving plan: ")
    assert out[0] == jout[0]
    summary, jsummary = json.loads(out[-1]), json.loads(jout[-1])
    assert summary["plan"] == jsummary["plan"]
    assert summary["replans"] == jsummary["replans"]
    assert summary["run_id"] and summary["run_id"] != jsummary["run_id"]
    assert summary["tokens"] == jsummary["tokens"]
    assert len(summary.get("replan_events", [])) == summary["replans"]
    assert _records_by_kind_and_name(tmp_path / "port.jsonl") == \
        _records_by_kind_and_name(tmp_path / "jax.jsonl")
    prom = (tmp_path / "port.prom").read_text()
    assert "serve_ttft_s_count" in prom and "serve_occupancy" in prom
    res = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "validate_serve.py"),
         "--metrics", str(tmp_path / "port.jsonl"), "--run-log",
         str(tmp_path / "port.log")], capture_output=True, text=True,
        timeout=60)
    assert res.returncode == 0, res.stdout + res.stderr
