"""The port's profile subsystem against the JAX package's, on the CPU.

  * a ProfileStore written by either package loads in the other, with
    equal ``interpolate`` results (schema v1, the same JSON);
  * ``ProfiledCostModel`` (layer times, telemetry folds, bubbles, links)
    and the predictor and planner fed by it agree exactly with the JAX
    package's on synthetic profiles, as ``tests/test_profile.py`` builds
    them;
  * the port's runner (``repro_torch.profile.runner``) times on the CPU
    through the plain kernels, with the JAX runner's trimmed mean, and
    writes ``layer_step`` entries that both packages' cost models serve.

The runner's card path (CUDA events, the kernels' launch counts) is in
``tests/test_torch_cuda.py``.
"""
import dataclasses
import json
import types

import pytest

torch = pytest.importorskip("torch")

from repro.configs.llama2_paper import LLAMA2_70B as J_70B  # noqa: E402
from repro.core import cluster as j_cluster  # noqa: E402
from repro.core import plan as j_plan  # noqa: E402
from repro.core import planner as j_planner  # noqa: E402
from repro.core import predictor as j_predictor  # noqa: E402
from repro.core import segmentation as j_segmentation  # noqa: E402
from repro.models import registry as j_registry  # noqa: E402
from repro.profile import model as j_model  # noqa: E402
from repro.profile import runner as j_runner  # noqa: E402
from repro.profile import store as j_store  # noqa: E402
from repro_torch.configs.llama2_paper import LLAMA2_70B as T_70B  # noqa: E402
from repro_torch.core import cluster as t_cluster  # noqa: E402
from repro_torch.core import plan as t_plan  # noqa: E402
from repro_torch.core import planner as t_planner  # noqa: E402
from repro_torch.core import predictor as t_predictor  # noqa: E402
from repro_torch.core import segmentation as t_segmentation  # noqa: E402
from repro_torch.models import registry as t_registry  # noqa: E402
from repro_torch.profile import model as t_model  # noqa: E402
from repro_torch.profile import runner as t_runner  # noqa: E402
from repro_torch.profile import store as t_store  # noqa: E402

from test_torch_planner import plain  # noqa: E402

JAX = types.SimpleNamespace(
    cfg70=J_70B, cluster=j_cluster, plan=j_plan, planner=j_planner,
    predictor=j_predictor, segmentation=j_segmentation, model=j_model,
    store=j_store, registry=j_registry)
PORT = types.SimpleNamespace(
    cfg70=T_70B, cluster=t_cluster, plan=t_plan, planner=t_planner,
    predictor=t_predictor, segmentation=t_segmentation, model=t_model,
    store=t_store, registry=t_registry)


def same(build):
    want, got = build(JAX), build(PORT)
    assert plain(got) == plain(want)
    return got


def _fill(st):
    """A store with every kind of entry the cost model reads."""
    for seq in (64, 128, 256):
        for mbs in (1, 2, 4):
            st.put("cpu", "layer_step",
                   {"arch": "m", "seq_len": seq, "micro_bs": mbs, "tp": 1},
                   {"fwd_s": 1e-6 * seq * mbs, "bwd_s": 2.5e-6 * seq * mbs})
    st.put("cpu", "link", {"scope": "intra"}, {"gbps": 123.0})
    st.put("cpu", "link", {"scope": "inter", "transport": "cpu"},
           {"gbps": 7.5})
    for m in (4, 8):
        st.fold("cpu", "observed_bubble", {"arch": "m", "schedule": "1f1b",
                                           "pp": 2, "vpp": 1, "m": m},
                "bubble_frac", 0.1 * m)
    st.fold("cpu", "observed_stage_tick",
            {"arch": "m", "seq_len": 32, "tp": 1, "schedule": "1f1b",
             "stage": 0, "pp": 2, "vpp": 1, "layers": 2,
             "padded_layers": 2, "micro_bs": 2}, "tick_s", 4e-3,
            also={"obs_scale": 2.0})
    return st


POINTS = [{"arch": "m", "seq_len": s, "micro_bs": b, "tp": 1}
          for s in (16, 64, 96, 128, 200, 256, 999)
          for b in (1, 1.5, 2, 3, 4, 8)]


@pytest.mark.parametrize("writer,reader", [(j_store, t_store),
                                           (t_store, j_store)])
def test_store_written_by_one_package_loads_in_the_other(tmp_path, writer,
                                                         reader):
    src = _fill(writer.ProfileStore())
    path = src.save(tmp_path / "p.json")
    got = reader.ProfileStore.load(path)
    assert len(got) == len(src)
    for pt in POINTS:
        for field in ("fwd_s", "bwd_s"):
            assert got.interpolate("cpu", "layer_step", pt, field) == \
                src.interpolate("cpu", "layer_step", pt, field)
    assert plain([e.to_dict() for e in got.entries()]) == \
        plain([e.to_dict() for e in src.entries()])
    # a fold after the round trip keeps the running means of both sides
    for st in (src, got):
        st.fold("cpu", "observed_bubble", {"arch": "m", "schedule": "1f1b",
                                           "pp": 2, "vpp": 1, "m": 4},
                "bubble_frac", 0.9)
    key = {"arch": "m", "schedule": "1f1b", "pp": 2, "vpp": 1, "m": 4}
    assert got.get("cpu", "observed_bubble", key).value == \
        src.get("cpu", "observed_bubble", key).value


def test_store_merge_and_staleness():
    def build(ns):
        a, b = _fill(ns.store.ProfileStore()), _fill(ns.store.ProfileStore())
        b.fold("cpu", "observed_stage_tick",
               {"arch": "m", "seq_len": 32, "tp": 1, "schedule": "1f1b",
                "stage": 0, "pp": 2, "vpp": 1, "layers": 2,
                "padded_layers": 2, "micro_bs": 2}, "tick_s", 9e-3)
        n = a.merge(b)
        a.mark_departed("cpu", 10)
        a.mark_departed("cpu", 12)
        stale = a.stale_kinds(20, 5)
        return (n, [(e.op, e.shape, e.value) for e in a.entries()],
                a.departed_since("cpu"), stale, a.drop_device("cpu"),
                len(a))
    same(build)


def test_store_inspector_cli(tmp_path, capsys):
    path = _fill(t_store.ProfileStore()).save(tmp_path / "p.json")
    assert t_store.main([str(path), "--kind", "layer_step"]) == 0
    out = capsys.readouterr().out
    assert "9/14 entries" in out and "layer_step" in out


def test_store_lands_in_a_gitignored_directory():
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    assert t_store.PROFILE_DIR == root / "chiprun_out" / "profiles"
    assert "chiprun_out/" in (root / ".gitignore").read_text().split()


# ------------------------------------------------------------ cost model --
def _plan(ns, cl, pp=4, tp=8):
    groups = ns.planner._stage_groups(cl, pp)
    split = ns.segmentation.uniform_split(ns.cfg70.num_layers, pp)
    dpg = [cl.groups[g].n_accel // (tp * groups.count(g))
           for g in range(len(cl.groups))]
    P = ns.plan
    return P.ParallelPlan(stages=tuple(
        P.StagePlacement(group=groups[i], n_layers=split[i],
                         dp=dpg[groups[i]], tp=tp, is_last=(i == pp - 1))
        for i in range(pp)), micro_bs=1, global_batch=96, seq_len=4096)


def test_profiled_layer_time_and_prediction():
    """test_profile.py's measured-layer-time case: a per-device sweep,
    served through device_map and time_scale, drives the predictor."""
    def build(ns):
        cl, cfg = ns.cluster.paper_cluster_of_size(12), ns.cfg70
        st = ns.store.ProfileStore()
        for mbs in (1, 2, 4, 8, 16):
            for dev, k in (("cpu", 1.0), ("cpu-fast", 0.5)):
                st.put(dev, "layer_step",
                       {"arch": cfg.name, "seq_len": 4096, "micro_bs": mbs,
                        "tp": 8}, {"fwd_s": k * 2e-3 * mbs,
                                   "bwd_s": k * 4e-3 * mbs})
        src = ns.model.ProfiledCostModel(
            st, device_map={"amd": "cpu-fast", "gpu-a": "cpu"},
            time_scale={"gpu-a": 1.5})
        times = [src.layer_time(d, cfg, 4096, m, 8)
                 for d in ("amd", "gpu-a", "other") for m in (1, 3, 16)]
        plan = _plan(ns, cl)
        pred = ns.predictor.PerformancePredictor(cl, cfg, cost_source=src)
        return (times, pred.predict(plan), pred.peak_memory(plan),
                src.hits, src.misses)
    same(build)


def test_profiled_telemetry_hierarchy():
    """Stage ticks (obs_scale, bucketed down-weighting), whole-step
    observations and observed bubbles, as test_profile.py folds them."""
    def build(ns):
        cfg = dataclasses.replace(ns.registry.get_config("llama3-8b",
                                                         smoke=True),
                                  name="m")
        st = _fill(ns.store.ProfileStore())
        tick = {"arch": "m", "seq_len": 32, "tp": 1, "schedule": "1f1b",
                "stage": 1, "pp": 2, "vpp": 1, "layers": 3,
                "padded_layers": 4, "micro_bs": 1}
        e = st.fold("cpu", "observed_stage_tick", tick, "tick_s", 7e-3)
        e.meta["provenance"] = "bucketed"
        st.fold("cpu", "observed_layer_step",
                {"arch": "m", "seq_len": 48, "tp": 1}, "per_seq_s", 0.3,
                also={"obs_scale": 3.0})
        src = ns.model.ProfiledCostModel(st, time_scale={"cpu": 2.0})
        cl = ns.cluster.paper_cluster_of_size(12)
        return ([src.layer_time("cpu", cfg, s, b, 1)
                 for s in (32, 48, 128) for b in (1, 2)],
                src.stage_tick_per_layer("cpu", cfg, 32, 1),
                [src.observed_bubble("cpu", cfg, sch, 2, 1, m)
                 for sch in ("1f1b", "gpipe") for m in (2, 4, 6, 16)],
                src.link_gbps(cl, 0, 0), src.link_gbps(cl, 0, 1, "cpu"),
                src.ring_hop_gbps(cl, 1), src.embedding_flops(cfg),
                src.layer_cost(cfg, 32), src.flops_calibrated(cfg, 32),
                src.hits, src.misses)
    same(build)


def test_planner_with_profiled_source():
    """test_profile.py's planner case: the sample device 'cpu' and a
    twice-as-fast 'cpu-fast' priced through a device_map."""
    def build(ns):
        cl, cfg = ns.cluster.paper_cluster_of_size(12), ns.cfg70
        st = ns.store.ProfileStore()
        for mbs in (1, 2, 4, 8, 16, 32):
            for dev, k in (("cpu", 1.0), ("cpu-fast", 0.5)):
                st.put(dev, "layer_step",
                       {"arch": cfg.name, "seq_len": 4096, "micro_bs": mbs,
                        "tp": 8}, {"fwd_s": k * 1e-3 * mbs,
                                   "bwd_s": k * 2e-3 * mbs})
        src = ns.model.ProfiledCostModel(
            st, device_map={"amd": "cpu-fast", "gpu-a": "cpu"})
        res = ns.planner.search(cl, cfg, global_batch=96, seq_len=4096,
                                pp_options=[6], tp_options=[8],
                                micro_bs_options=[1], require_fit=False,
                                cost_source=src)
        return (res.plan.to_dict(), res.prediction, res.evaluated, res.log,
                src.hits)
    same(build)


# ---------------------------------------------------------------- runner --
def test_timeit_is_the_jax_runners_trimmed_mean(monkeypatch):
    ticks = iter([0.0, 0.3, 1.0, 1.1, 2.0, 2.5, 3.0, 3.2, 4.0, 4.9] * 2)
    monkeypatch.setattr("time.perf_counter", lambda: next(ticks))
    want = j_runner.timeit(lambda: None, warmup=1, reps=5, trim=0.2)
    got = t_runner.timeit(lambda: None, warmup=1, reps=5, trim=0.2,
                          device="cpu")
    assert got == want
    assert got[0] == pytest.approx((0.2 + 0.3 + 0.5) / 3)


def test_device_kind_and_collectives_on_cpu(capsys):
    """One process, one device: both runners skip the collectives (the
    port's run over ranks in tests/test_torch_ranks.py)."""
    assert t_runner.device_kind("cpu") == j_runner.device_kind() == "cpu"
    store = t_store.ProfileStore()
    t_runner.bench_collectives(store, "cpu", (1 << 20,), device="cpu")
    assert "single device — skipped" in capsys.readouterr().out
    assert len(store) == 0


def test_runner_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_runner.run(quick=True, verbose=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_runner.device_kind()


def test_runner_refuses_tensor_parallel_layers():
    """tp > 1 probes run the dense stack's tensor-parallel loss
    (tests/test_torch_tp.py); the ssm stack's wait for its training
    kernels, and the runner says so before it starts any rank."""
    with pytest.raises(NotImplementedError, match="queue A, item 9"):
        t_runner.bench_layers(t_store.ProfileStore(), "cpu",
                              "falcon-mamba-7b", (32,), (1,), tp=2,
                              device="cpu")


def test_runner_quick_writes_a_profile_both_cost_models_serve(tmp_path):
    """test_profile.py's runner case on the port: the quick sweep lands
    in the store and the port's ProfiledCostModel (and the JAX package's,
    reading the same file) serve its layer times."""
    out = tmp_path / "cpu.json"
    store = t_runner.run(quick=True, out=str(out), verbose=False,
                         device="cpu")
    assert out.exists()
    ops = sorted({e.op for e in store.entries("cpu")})
    assert ops == ["kernel_flash_attention", "kernel_rmsnorm",
                   "kernel_swiglu", "layer_step", "loss_probe"]
    probes = store.entries("cpu", "loss_probe")
    assert sorted(e.shape["n_layers"] for e in probes) == [1] * 4 + [2] * 4
    assert all(e.value["fwd_s"] > 0 and e.value["step_s"] > 0
               for e in probes)
    kernels = store.entries("cpu", "kernel_rmsnorm")
    assert sorted((e.shape["seq_len"], e.shape["micro_bs"])
                  for e in kernels) == [(64, 1), (64, 2), (128, 1), (128, 2)]
    assert all(e.shape["d_model"] == 256 and e.value["fwd_s"] > 0
               and e.value["fwdbwd_s"] > 0 for e in kernels)
    assert len(store.entries("cpu", "layer_step")) == 4
    t_cfg = t_registry.get_config("llama3-8b")
    lt = t_model.ProfiledCostModel(store).layer_time("cpu", t_cfg, 64, 1, 1)
    assert lt is not None and lt[0] > 0 and lt[1] >= 0
    step = store.get("cpu", "layer_step",
                     {"arch": "llama3-8b", "seq_len": 64, "micro_bs": 1,
                      "tp": 1}).value
    assert lt == (step["fwd_s"], step["bwd_s"])
    j_src = j_model.ProfiledCostModel(j_store.ProfileStore.load(out))
    assert j_src.layer_time("cpu", j_registry.get_config("llama3-8b"),
                            64, 1, 1) == lt
    assert json.loads(out.read_text())["version"] == 1


def test_runner_cli(tmp_path, capsys):
    out = tmp_path / "p.json"
    assert t_runner.main(["--quick", "--device", "cpu", "--out",
                          str(out)]) == 0
    text = capsys.readouterr().out
    assert "layer  llama3-8b" in text and "collectives" in text
    assert len(t_store.ProfileStore.load(out)) == 24
    with pytest.raises(SystemExit):
        t_runner.main(["--arch", "whisper-tiny", "--device", "cpu"])
