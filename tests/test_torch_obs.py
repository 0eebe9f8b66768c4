"""The port's observability (``repro_torch.obs`` and the ``Trainer``'s
hooks) against the JAX package's ``repro.obs``, on the CPU.

  * the writers on the same inputs: ``plan_digest`` and ``RunMeta``; the
    metrics records (timestamps masked), their Prometheus text; the
    predicted lane (the simulator's events under the predictor's
    timings) and the observed lane; ``build_report`` and its text on the
    same artifacts; the flight recorder's ring and dump, and the SIGTERM
    chain;
  * ``obs=None`` (the default) installs nothing: no collective sink, no
    telemetry sink;
  * the e2e scenario of ``tests/test_obs.py:392-430`` on the port's pp
    ``Trainer``: the trace has both lanes and the replan's instants, the
    metrics validate and carry the loop, the report's bubble equals
    ``schedule_health`` exactly, the events equal the ``adapt_log``.
    The port's collective tap fires once per executed call, where JAX's
    fires once per compiled program (``iccl/communicator.py``): the
    ``iccl_calls`` counter is one step's notes times the steps;
  * the train CLI's artifacts passing ``tools/validate_obs.py
    --expect-replan``, in one process and on 2 ranks under torchrun
    (each rank's files valid alone, one run id), and ``python -m
    repro_torch.obs.report`` on them.
"""
import importlib.util
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import cluster as JC  # noqa: E402
from repro.core.plan import ParallelPlan as JPlan  # noqa: E402
from repro.core.plan import StagePlacement as JStage  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.obs import flight as jflight  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs import report as jreport  # noqa: E402
from repro.obs import runmeta as jrunmeta  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro_torch.adapt import AdaptConfig, ReplanPolicy  # noqa: E402
from repro_torch.core import cluster as C  # noqa: E402
from repro_torch.core.plan import ParallelPlan, StagePlacement  # noqa: E402
from repro_torch.iccl import communicator  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.obs import (FlightRecorder, Observability,  # noqa: E402
                             RunMeta, install_sigterm, read_jsonl,
                             uninstall_sigterm)
from repro_torch.obs import flight, metrics, report, runmeta  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.profile.store import ProfileStore  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's in-process trainers (SMOKE
    sizes gain nothing from more), so that test workers running side by
    side do not oversubscribe the host's cores; restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _load_validator():
    spec = importlib.util.spec_from_file_location(
        "validate_obs", ROOT / "tools" / "validate_obs.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


VAL = _load_validator()
STAGES = ((0, 3, 1, 1, False), (1, 3, 1, 1, True))
META = dict(run_id="20260101-000000-abcdef01", plan_digest="0123456789ab",
            arch="llama3-8b-smoke", created_unix=1.5)


def _plans():
    kw = dict(micro_bs=2, global_batch=8, seq_len=32)
    return (ParallelPlan(stages=tuple(StagePlacement(*s) for s in STAGES),
                         **kw),
            JPlan(stages=tuple(JStage(*s) for s in STAGES), **kw))


def _clusters():
    return (C.ClusterSpec(groups=(C.NodeGroup(C.AMD, 1, accel_per_node=1),
                                  C.NodeGroup(C.GPU_A, 1, accel_per_node=1))),
            JC.ClusterSpec(groups=(JC.NodeGroup(JC.AMD, 1, accel_per_node=1),
                                   JC.NodeGroup(JC.GPU_A, 1,
                                                accel_per_node=1))))


def _masked(records):
    return [{k: ("ts" if k == "ts" else v) for k, v in r.items()}
            for r in records]


# ------------------------------------------------------- the writers ----
def test_run_identity_equals_jaxs():
    plan, jplan = _plans()
    assert runmeta.plan_digest(plan) == jrunmeta.plan_digest(jplan)
    ours, theirs = RunMeta(**META), jrunmeta.RunMeta(**META)
    assert ours.to_dict() == theirs.to_dict()
    assert RunMeta.from_dict(theirs.to_dict()) == ours
    assert runmeta.SCHEMA_VERSION == jrunmeta.SCHEMA_VERSION
    a, b = RunMeta.new(plan=plan), RunMeta.new(plan=plan)
    assert a.run_id != b.run_id and a.plan_digest == b.plan_digest


def _feed(log, plan_doc):
    log.count("replans")
    log.count("iccl_calls", 3.0, op="isend_irecv", transport="ici")
    log.gauge("step_time_s", 0.5)
    log.observe("migration_wall_s", 2.0, ok="true")
    log.flush(1)
    log.count("iccl_calls", 2.0, op="isend_irecv", transport="ici")
    log.gauge("tick_s", 0.01, stage=1, device="gpu-a")
    log.observe("migration_wall_s", 4.0, ok="true")
    log.plan(2, "digest", plan_doc, {"iter_time": 0.25})
    log.flush(2)
    log.close()


def test_metrics_records_and_prometheus_equal_jaxs(tmp_path):
    """The same updates into both logs: every record equal but its
    timestamp, and the Prometheus text byte for byte."""
    plan, _ = _plans()
    ours = metrics.MetricsLog(tmp_path / "a.jsonl", RunMeta(**META),
                              tmp_path / "a.prom", epoch=0.0)
    theirs = jmetrics.MetricsLog(tmp_path / "b.jsonl",
                                 jrunmeta.RunMeta(**META), tmp_path / "b.prom",
                                 epoch=0.0)
    _feed(ours, plan.to_dict())
    _feed(theirs, plan.to_dict())
    a, b = read_jsonl(tmp_path / "a.jsonl"), jmetrics.read_jsonl(
        tmp_path / "b.jsonl")
    assert len(a) == len(b) > 5
    assert _masked(a) == _masked(b)
    assert (tmp_path / "a.prom").read_text() == \
        (tmp_path / "b.prom").read_text()
    assert VAL.validate_metrics(tmp_path / "a.jsonl")[0] == []


def test_predicted_and_observed_lanes_equal_jaxs():
    plan, jplan = _plans()
    cl, jcl = _clusters()
    cfg = treg.get_config("llama3-8b", smoke=True, num_layers=6)
    jcfg = jreg.get_bundle("llama3-8b", smoke=True, num_layers=6).cfg
    ev, rep, pred = trace.predicted_sim_events(plan, cl, cfg)
    jev, jrep, jpred = jtrace.predicted_sim_events(jplan, jcl, jcfg)
    assert [tuple(vars(e).values()) for e in ev] == \
        [tuple(vars(e).values()) for e in jev]
    assert rep.iter_time == jrep.iter_time
    assert pred.iter_time == jpred.iter_time
    ours = trace.TraceBuilder(RunMeta(**META), epoch=0.0)
    theirs = jtrace.TraceBuilder(jrunmeta.RunMeta(**META), epoch=0.0)
    for tb, events, p in ((ours, ev, plan), (theirs, jev, jplan)):
        tb.predicted_lane(p, events, anchor_us=0.0, kinds=["amd", "gpu-a"],
                          digest="d")
        tb.observed_step(3, 10.0, [0.1, 0.2, 0.3, 0.2, 0.1], 2, 1, 4,
                         "callback", ["amd", "gpu-a"])
        tb.instant("adapt:migrate", ts_us=5.0, args={"step": 3})
    assert ours.to_dict() == theirs.to_dict()


def _artifacts(tmp):
    """A run's metrics and events through the port's Observability."""
    obs = Observability(metrics_out=tmp / "m.jsonl",
                        events_out=tmp / "e.jsonl", run=RunMeta(**META))
    plan, _ = _plans()
    cl, _ = _clusters()
    cfg = treg.get_config("llama3-8b", smoke=True, num_layers=6)
    obs.on_plan_adopted(0, plan, cl, cfg, ["amd", "gpu-a"])
    sink = obs.make_telemetry_sink(plan, ["amd", "gpu-a"], "callback",
                                   scales_fn=lambda: [1.0, 8.0])
    obs.install_iccl()
    for step in range(1, 4):
        sink(step, 1.0 * step, [0.01, 0.02, 0.02, 0.02, 0.01])
        communicator._note("isend_irecv", "ici", torch.zeros(4, 8))
        obs.on_step(step, 0.1 * step, {"observed_bubble": 0.2,
                                       "predicted_bubble": 0.25,
                                       "ratio": 0.8})
    from repro_torch.adapt import AdaptEvent
    evs = [AdaptEvent(3, "migrate", "adopted", {"plan": "p"})]
    for e in evs:
        obs.on_adapt_event(e)
    obs.write_events(evs)
    obs.close()
    return read_jsonl(tmp / "m.jsonl"), read_jsonl(tmp / "e.jsonl")


def test_build_report_equals_jaxs(tmp_path):
    m, e = _artifacts(tmp_path)
    ours = report.build_report(m, events=e)
    theirs = jreport.build_report(m, events=e)
    assert ours == theirs
    assert report._fmt(ours) == jreport._fmt(theirs)
    assert ours["schedule_health"]["ratio"] == 0.2 / 0.25
    assert ours["collectives"]
    with pytest.raises(report.RunMismatch):
        report.build_report(m, events=[dict(e[0], run_id="other")])


def test_flight_recorder_equals_jaxs(tmp_path):
    ours = FlightRecorder(capacity=4, run=RunMeta(**META))
    theirs = jflight.FlightRecorder(capacity=4,
                                    run=jrunmeta.RunMeta(**META))
    for fr in (ours, theirs):
        for i in range(10):
            fr.note("step", step=i, dt=0.1)
    assert [dict(e, ts=0) for e in ours.ring] == \
        [dict(e, ts=0) for e in theirs.ring]
    p1 = ours.dump(tmp_path / "flight.json", reason="schedule-error")
    doc = json.loads(p1.read_text())
    assert doc["kind"] == "flight" and doc["reason"] == "schedule-error"
    assert [x["step"] for x in doc["events"]] == [6, 7, 8, 9]
    p2 = ours.dump(tmp_path / "flight.json", reason="sigterm")
    assert p2.name == "flight.1.json" and p1.exists()
    jdoc = theirs.to_dict("schedule-error")
    assert doc.keys() == jdoc.keys()


def test_sigterm_dumps_then_chains_and_stays_one_deep(tmp_path):
    chained = []
    prev = signal.getsignal(signal.SIGTERM)
    signal.signal(signal.SIGTERM, lambda s, f: chained.append(s))
    try:
        fr = FlightRecorder(capacity=8)
        fr.note("step", step=1)
        install_sigterm(fr, tmp_path / "a.json")
        h1 = signal.getsignal(signal.SIGTERM)
        install_sigterm(fr, tmp_path / "a.json")    # same pair: no-op
        assert signal.getsignal(signal.SIGTERM) is h1
        fr2 = FlightRecorder(capacity=8)
        install_sigterm(fr2, tmp_path / "b.json")   # replaces, keeps prev
        signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
        assert not (tmp_path / "a.json").exists()
        assert json.loads((tmp_path / "b.json").read_text())["reason"] \
            == "sigterm"
        assert chained == [signal.SIGTERM]
    finally:
        signal.signal(signal.SIGTERM, prev)
        uninstall_sigterm()
    assert flight.install_sigterm.__doc__ == \
        jflight.install_sigterm.__doc__


# -------------------------------------------------------- the trainer ----
def _trainer(tmp, obs=None, policy=None):
    plan, _ = _plans()
    cl, _ = _clusters()
    return Trainer(treg.get_bundle("llama3-8b", smoke=True, num_layers=6),
                   TrainerConfig(global_batch=8, seq_len=32,
                                 ckpt_dir=str(tmp / "ckpt"), ckpt_every=100,
                                 replan_profile_min_obs=4),
                   plan=plan, cluster=cl, profile_store=ProfileStore(),
                   device="cpu", policy=policy, obs=obs,
                   adapt_search_kw=dict(pp_options=[2], tp_options=[1],
                                        micro_bs_options=[2],
                                        require_fit=False,
                                        include_tp_comm=False,
                                        schedule="1f1b",
                                        explore_orders=False))


def test_obs_none_installs_nothing(tmp_path):
    t = _trainer(tmp_path)
    t.run(2)
    assert communicator._SINK is None
    assert t.telemetry.sink is None and t.obs is None
    obs = Observability()                           # no output paths
    assert not obs.enabled and obs.flight is None
    obs.install_iccl()
    assert communicator._SINK is None
    obs.close()


@pytest.fixture(scope="module")
def obs_e2e(tmp_path_factory):
    """JAX's acceptance scenario with every pillar on."""
    tmp = tmp_path_factory.mktemp("obs")
    plan, _ = _plans()
    obs = Observability(
        trace_out=tmp / "trace.json", metrics_out=tmp / "metrics.jsonl",
        events_out=tmp / "events.jsonl", prom_out=tmp / "prom.txt",
        flight_out=tmp / "flight.json",
        run=RunMeta.new(plan=plan, arch="llama3-8b-smoke"))
    policy = ReplanPolicy(AdaptConfig(patience=2, cooldown=4,
                                      baseline_steps=2, ewma=1.0,
                                      min_gain=0.0))
    t = _trainer(tmp, obs=obs, policy=policy)
    notes = []
    communicator._SINK, real = (lambda *n: (notes.append(n), real(*n))), \
        communicator._SINK
    t.run(1)
    one_step = len(notes)
    communicator._SINK = real
    t.run(3)
    t.inject_degrade("gpu-a", 8.0)
    t.run(6)
    health = t.schedule_health()
    obs.write_events(t.adapt_log)
    obs.close()
    return dict(t=t, tmp=tmp, health=health, run=obs.run,
                one_step=one_step)


def test_e2e_trace_has_both_lanes_and_replan_instant(obs_e2e):
    t = obs_e2e["t"]
    assert t.replans == 1
    errors, run_id = VAL.validate_trace(obs_e2e["tmp"] / "trace.json",
                                        expect_replan=True)
    assert errors == [] and run_id == obs_e2e["run"].run_id
    evs = json.loads((obs_e2e["tmp"] / "trace.json").read_text())[
        "traceEvents"]
    instants = [e["name"] for e in evs if e["ph"] == "i"]
    assert instants.count("plan-adopted") == 2
    for name in ("adapt:trigger", "adapt:replan", "adapt:migrate"):
        assert name in instants
    for pid in (1, 2):
        assert any(e["ph"] == "X" and e["pid"] == pid for e in evs)
    assert len([e for e in evs if e["ph"] == "X"
                and e["name"].startswith("step ")]) >= 6


def test_e2e_metrics_validate_and_count_executed_calls(obs_e2e):
    """The metrics carry the loop; ``iccl_calls`` counts every executed
    call (the port's tap), so after 10 steps it is 10 times one step's
    notes — JAX's would hold one compiled program's."""
    path = obs_e2e["tmp"] / "metrics.jsonl"
    errors, run_id = VAL.validate_metrics(path)
    assert errors == [] and run_id == obs_e2e["run"].run_id
    recs = read_jsonl(path)
    names = {r.get("name") for r in recs}
    for name in ("step_time_s", "tick_s", "observed_bubble",
                 "predicted_bubble", "iccl_calls", "iccl_bytes",
                 "adapt_events", "replans", "store_folds"):
        assert name in names, name
    plans = [r for r in recs if r["kind"] == "plan"]
    assert len(plans) == 2
    assert plans[0]["digest"] == obs_e2e["run"].plan_digest
    last = {}                   # counters are cumulative: the last each
    for r in recs:
        if r.get("name") == "iccl_calls":
            last[json.dumps(r["labels"], sort_keys=True)] = r["value"]
    total = sum(last.values())
    assert obs_e2e["one_step"] > 0
    assert total == 10 * obs_e2e["one_step"]
    prom = (obs_e2e["tmp"] / "prom.txt").read_text()
    assert f'run_id="{obs_e2e["run"].run_id}"' in prom


def test_e2e_report_bit_exact_vs_schedule_health(obs_e2e):
    health = obs_e2e["health"]
    m = read_jsonl(obs_e2e["tmp"] / "metrics.jsonl")
    e = read_jsonl(obs_e2e["tmp"] / "events.jsonl")
    rep = report.build_report(m, events=e)
    assert rep == jreport.build_report(m, events=e)
    sh = rep["schedule_health"]
    assert sh["observed_bubble"] == health["observed_bubble"]
    assert sh["predicted_bubble"] == health["predicted_bubble"]
    assert sh["ratio"] == health["ratio"]
    assert {s["stage"] for s in rep["stages"]} == {0, 1}
    assert rep["adapt_events"].get("migrate") == 1.0
    assert rep["replans"] == 1.0


def test_e2e_events_match_the_adapt_log_and_sinks_close(obs_e2e):
    t = obs_e2e["t"]
    path = obs_e2e["tmp"] / "events.jsonl"
    errors, run_id = VAL.validate_events(path)
    assert errors == [] and run_id == obs_e2e["run"].run_id
    recs = [r for r in read_jsonl(path) if r["kind"] == "adapt_event"]
    assert recs == [{"kind": "adapt_event", **e.to_dict()}
                    for e in t.adapt_log]
    assert communicator._SINK is None
    assert t.telemetry.sink is not None


def test_schedule_error_dumps_the_flight_recorder(tmp_path):
    from repro_torch.core.simulator import ScheduleError
    obs = Observability(metrics_out=tmp_path / "m.jsonl",
                        flight_out=tmp_path / "flight.json")
    t = _trainer(tmp_path, obs=obs)

    def wedged(state, batch):
        raise ScheduleError(1, 0, "F", "1f1b")

    t.train_step = wedged
    with pytest.raises(ScheduleError):
        t.run(1)
    doc = json.loads((tmp_path / "flight.json").read_text())
    assert doc["reason"] == "schedule-error"
    obs.close()


# ---------------------------------------------------------- the CLI ----
def _cli(args, tmp, nproc=1):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), TMPDIR=str(tmp),
               OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    head = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc-per-node={nproc}"] if nproc > 1
            else [sys.executable])
    out = subprocess.run(
        head + ["-m", "repro_torch.launch.train", "--smoke", "--device",
                "cpu", "--pp", "2", "--layers", "4", "--global-batch", "4",
                "--seq", "16", "--ckpt-dir", ""] + args,
        env=env, capture_output=True, text=True, timeout=300, cwd=str(tmp))
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


@pytest.mark.parametrize("nproc", [1, 2])
def test_cli_artifacts_pass_validate_obs(nproc, tmp_path):
    """``--adapt --degrade gpu-a:4@4`` with every obs flag: the controller
    migrates on its own, and every rank's artifacts validate alone with
    ``--expect-replan`` and carry rank 0's run id; the report CLI reads
    rank 0's."""
    files = dict(trace="t.json", metrics="m.jsonl", events="e.jsonl")
    args = ["--steps", "12", "--adapt", "--degrade", "gpu-a:4@4",
            "--trace-out", str(tmp_path / files["trace"]),
            "--metrics-out", str(tmp_path / files["metrics"]),
            "--events-out", str(tmp_path / files["events"]),
            "--prom-out", str(tmp_path / "p.prom")]
    stdout = _cli(args, tmp_path, nproc)
    assert "[adapt]" in stdout and "migrate" in stdout
    ids = set()
    for r in range(nproc):
        suffix = "" if r == 0 else f".rank{r}"
        paths = {k: tmp_path / v.replace(".", suffix + ".", 1)
                 for k, v in files.items()}
        got = subprocess.run(
            [sys.executable, str(ROOT / "tools" / "validate_obs.py"),
             "--trace", str(paths["trace"]), "--metrics",
             str(paths["metrics"]), "--events", str(paths["events"]),
             "--expect-replan"], capture_output=True, text=True)
        assert got.returncode == 0, got.stdout
        ids.add(read_jsonl(paths["metrics"])[0]["run_id"])
    assert len(ids) == 1
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    rep = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.report", "--metrics",
         str(tmp_path / files["metrics"]), "--events",
         str(tmp_path / files["events"]), "--json"],
        env=env, capture_output=True, text=True)
    assert rep.returncode == 0, rep.stderr
    assert json.loads(rep.stdout)["replans"] == 1.0
    summary = json.loads(stdout.strip().splitlines()[-1])
    assert summary["migrations"]["memory"] == 1
    assert [e["action"] for e in summary["adapt_events"]].count(
        "migrate") == 1
