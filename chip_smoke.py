#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--report PATH]

Phases, each raising on failure so the script exits non-zero:
  1. card     nvidia-smi name and power limit, torch's device name
  2. build    the four Hopper kernels from ``src/repro_torch/kernels/csrc``
  3. kernels  each kernel against its plain PyTorch version on the card at
              the serving paths' shapes (bf16 tol 2e-2, fp32 tol 2e-5, the
              selective scan 2e-4 in y and its last state), timed beside
              the plain version and one library call where there is one
  4. model    llama3-8b and falcon-mamba-7b SMOKE in fp32: the kernels on
              the card against the plain versions on the CPU through
              forward/prefill/the cache/decode
  5. serve    llama3-8b, then falcon-mamba-7b, at full width and depth
              (bf16, seeded random weights) through ServeEngine(max_batch=8,
              max_len=2048) on the same 16-request trace; every kernel's
              launch count equals its expected count for that path, first
              tokens equal decode_sequential's, logits are finite; each path
              reports its own peak memory
Then one JSON line with every kernel (launches summed over both serve
runs), the card line, and the last line
``{"ok": true, "device": {...}}``.  ``--report PATH`` also writes every
check and timing there as JSON.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# published dense peaks (NVIDIA data sheets) keyed by a device-name marker
PEAKS = {  # marker: (bytes/s, bf16 tensor FLOP/s, fp32 FLOP/s)
    "H100 PCIe": (2.0e12, 756e12, 51e12),
    "H100 NVL": (3.9e12, 835e12, 60e12),
    "H100": (3.35e12, 989e12, 67e12),        # SXM
}
# An SM issues 16 special-function results (exp2, rcp, ...) per clock
# against 128 fp32 FMAs (256 FLOP), so their peak is fp32 FLOP/s / 16.
SFU_PER_FP32_FLOP = 1 / 16
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
FP32_TOL = dict(rtol=2e-5, atol=2e-5)
# the selective scan: an fp32 sum over up to S decayed terms, added in
# another order than the plain loop's (tests/test_kernels.py:102-103)
SCAN_TOL = dict(rtol=2e-4, atol=2e-4)
SERVE_ARCHS = ("llama3-8b", "falcon-mamba-7b")
# model-level fp32 tolerance: two layers of matmuls summed in other orders
# on the CPU and the card, then a 256-way unembed
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def log(msg: str) -> None:
    print(msg, flush=True)


def peaks(name: str):
    for marker, vals in PEAKS.items():
        if marker in name:
            return vals
    raise RuntimeError(f"no published peaks for {name!r}")


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around ``iters``
    back-to-back calls (inputs stay in L2, as the main path's do)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------- phase 1 ---
def phase_card(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"[card] nvidia-smi: {smi} | torch: {name} | "
        f"devices: {torch.cuda.device_count()} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    return smi, name


# ------------------------------------------------------------- phase 2 ---
def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    secs = time.perf_counter() - t0
    log(f"[build] {secs:.2f} s (nvcc {build.find_nvcc()})")
    for line in build.ptxas_log.splitlines():
        if "Used" in line or "spill" in line:
            log(f"[build]   {line.strip()}")
    return secs


# ------------------------------------------------------------- phase 3 ---
def phase_kernels(torch, dev, name):
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.kernels import swiglu as sg

    bw, bf16_peak, fp32_peak = peaks(name)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    checks = []

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def compare(kernel, label, got, want, tol):
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), **tol)
        checks.append({"kernel": kernel, "case": label, "max_abs_err": err})
        log(f"[kernels] {kernel:15s} {label:42s} max_abs_err {err:.3e} ok")
        return err

    bf, f32 = torch.bfloat16, torch.float32
    tol = {bf: BF16_TOL, f32: FP32_TOL}

    # rmsnorm: decode (8 rows) and prefill (1000 rows) at D=4096; D=128 is
    # the one-warp-per-row path (qk_norm width)
    for rows, D in ((8, 4096), (1000, 4096), (256, 128)):
        for dt in (bf, f32):
            x, s = randn(rows, D, dtype=dt), randn(D, dtype=dt)
            compare("rmsnorm", f"{rows}x{D} {dt}", rn.rmsnorm(x, s, 1e-5),
                    ref.rmsnorm(x, s, 1e-5), tol[dt])
    for rows, F_ in ((8, 14336), (1000, 14336)):
        for dti, dto in ((bf, bf), (f32, f32), (f32, bf)):
            g, u = randn(rows, F_, dtype=dti), randn(rows, F_, dtype=dti)
            compare("swiglu", f"{rows}x{F_} {dti}->{dto}",
                    sg.swiglu(g, u, dto), ref.swiglu(g, u, dto), tol[dto])
    # flash: the prefill shape, then window / softcap / Sq<Sk / ragged /
    # fully-masked-row / hd=64 cases
    fl_cases = [
        ("S1000 causal", 1, 1000, 1000, 32, 8, 128, {}, (bf, f32)),
        ("S1000 window256", 1, 1000, 1000, 32, 8, 128, {"window": 256},
         (bf,)),
        ("S1000 softcap50", 1, 1000, 1000, 32, 8, 128, {"softcap": 50.0},
         (bf,)),
        ("Sq100<Sk1000", 1, 100, 1000, 32, 8, 128, {}, (bf,)),
        ("S257 ragged", 2, 257, 257, 32, 8, 128, {}, (bf, f32)),
        ("Sq300>Sk200 masked rows", 1, 300, 200, 8, 2, 128, {}, (bf, f32)),
        ("S200 hd64 MQA", 2, 200, 200, 8, 1, 64, {}, (bf, f32)),
    ]
    for label, B, Sq, Sk, H, Hk, hd, kw, dts in fl_cases:
        for dt in dts:
            q = randn(B, Sq, H, hd, dtype=dt)
            k, v = randn(B, Sk, Hk, hd, dtype=dt), randn(B, Sk, Hk, hd,
                                                         dtype=dt)
            got = fa.flash_attention(q, k, v, causal=True, **kw)
            want = ref.flash_attention(q, k, v, causal=True, **kw)
            compare("flash_attention", f"{label} {dt}", got, want, tol[dt])
            if "masked" in label:
                assert got[:, :Sq - Sk].abs().max().item() == 0.0

    # ssm_scan, y and the last state: the prefill's shape (d_inner 8192,
    # d_state 16, bf16 u, S up to 1000), a ragged S, fp32 u at batch 2
    def scan_inputs(B, S, di, ds, u_dtype):
        dt = F.softplus(randn(B, S, di, dtype=f32) - 1.0)
        return (randn(B, S, di, dtype=u_dtype), dt,
                randn(B, S, ds, dtype=f32), randn(B, S, ds, dtype=f32),
                -torch.exp(randn(di, ds, dtype=f32) * 0.3))

    for label, B, S, dt in (("B1 S1000", 1, 1000, bf),
                            ("B1 S500 ragged", 1, 500, bf),
                            ("B2 S300", 2, 300, f32)):
        args = scan_inputs(B, S, 8192, 16, dt)
        (y, h), (want_y, want_h) = ss.ssm_scan(*args), ref.ssm_scan(*args)
        compare("ssm_scan", f"{label} di8192 ds16 u {dt} y", y, want_y,
                SCAN_TOL)
        compare("ssm_scan", f"{label} di8192 ds16 u {dt} h_last", h, want_h,
                SCAN_TOL)

    # timings at the serving path's largest shapes, bf16
    x, s = randn(1000, 4096, dtype=bf), randn(4096, dtype=bf)
    g, u = randn(1000, 14336, dtype=bf), randn(1000, 14336, dtype=bf)
    S, H, Hk, hd = 1000, 32, 8, 128
    q = randn(1, S, H, hd, dtype=bf)
    k, v = randn(1, S, Hk, hd, dtype=bf), randn(1, S, Hk, hd, dtype=bf)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # SDPA's layout
    pairs = S * (S + 1) // 2          # visible (q, k) pairs, causal
    el = 2                            # bf16 bytes
    di, ds = 8192, 16
    scan = scan_inputs(1, S, di, ds, bf)
    states = S * di * ds              # (t, d, n) state updates, one exp each
    rows = {
        "rmsnorm": dict(
            source="src/repro_torch/kernels/csrc/rmsnorm.cu",
            replaces="src/repro/kernels/rmsnorm.py:19",
            shape="x (1000, 4096) bf16",
            fn=lambda: rn.rmsnorm(x, s, 1e-5),
            plain=lambda: ref.rmsnorm(x, s, 1e-5),
            library=lambda: F.rms_norm(x, (4096,), s, 1e-5),
            bytes=2 * 1000 * 4096 * el + 4096 * el,
            ops=[(4 * 1000 * 4096, fp32_peak)]),
        "swiglu": dict(
            source="src/repro_torch/kernels/csrc/swiglu.cu",
            replaces="src/repro/kernels/swiglu.py:16",
            shape="g, u (1000, 14336) bf16 -> bf16",
            fn=lambda: sg.swiglu(g, u, bf),
            plain=lambda: ref.swiglu(g, u, bf),
            library=None,
            bytes=3 * 1000 * 14336 * el,
            ops=[(8 * 1000 * 14336, fp32_peak)]),
        "flash_attention": dict(
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:91",
            shape="B1 S1000 H32 Hk8 hd128 causal bf16",
            fn=lambda: fa.flash_attention(q, k, v, causal=True),
            plain=lambda: ref.flash_attention(q, k, v, causal=True),
            library=lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True),
            bytes=(2 * S * H * hd + 2 * S * Hk * hd) * el,
            ops=[(4 * pairs * hd * H, bf16_peak)]),
        "ssm_scan": dict(
            source="src/repro_torch/kernels/csrc/ssm_scan.cu",
            replaces="src/repro/kernels/ssm_scan.py:46",
            shape="B1 S1000 di8192 ds16, u bf16, dt/B/C/A fp32",
            fn=lambda: ss.ssm_scan(*scan),
            plain=lambda: ref.ssm_scan(*scan),
            library=None,
            # u (bf16), dt and y (fp32) per (t, d); B, C per (t, n); A and
            # the last state per (d, n)
            bytes=S * di * (el + 4 + 4) + 2 * S * ds * 4 + 2 * di * ds * 4,
            # 6 fp32 FLOP per state update (dt*A, decay*h, du*B, the add,
            # h*C, the sum) and one exp on the special-function units
            ops=[(6 * states + S * di, fp32_peak),
                 (states, fp32_peak * SFU_PER_FP32_FLOP)]),
    }
    timed = {}
    for kname, r in rows.items():
        bytes_ms = r["bytes"] / bw * 1e3
        ops_ms = max(n / peak for n, peak in r["ops"]) * 1e3
        err = _max_err(r["fn"](), r["plain"]())
        timed[kname] = {
            "name": kname, "route": "cuda", "source": r["source"],
            "replaces": r["replaces"], "shape": r["shape"],
            "max_abs_err": err,
            "ms": time_ms(torch, r["fn"]),
            "plain_ms": time_ms(torch, r["plain"]),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": (time_ms(torch, r["library"])
                           if r["library"] else None),
        }
        t = timed[kname]
        log(f"[kernels] time {kname:15s} {r['shape']}: kernel {t['ms']:.4f} "
            f"ms, plain {t['plain_ms']:.4f} ms, library {t['library_ms']} "
            f"ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    return checks, timed


def _max_err(got, want) -> float:
    """Max abs difference over a tensor or a tuple of tensors."""
    if isinstance(got, tuple):
        return max(_max_err(g, w) for g, w in zip(got, want))
    return (got.float() - want.float()).abs().max().item()


# ------------------------------------------------------------- phase 4 ---
def phase_model(torch, dev, arch):
    """SMOKE fp32: kernels on the card vs plain versions on the CPU."""
    from repro_torch.models import registry

    b = registry.get_bundle(arch, smoke=True)
    cfg = b.cfg
    p_cpu = b.init(cfg, seed=0, device="cpu")
    p_gpu = _tree(p_cpu, lambda t: t.to(dev))
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 37), generator=gen)
    out = {}
    for tag, p, d in (("cpu", p_cpu, "cpu"), ("gpu", p_gpu, dev)):
        logits, _ = b.forward(p, {"tokens": tokens.to(d)}, cfg)
        last, cache = b.prefill(p, {"tokens": tokens.to(d)}, cfg, 48)
        steps = []
        cache["pos"] = torch.tensor([37, 37], device=d)  # per-row path
        tok = torch.argmax(last, -1, keepdim=True)
        for _ in range(4):
            lg, cache = b.decode_step(p, tok, cache, cfg)
            steps.append(lg)
            tok = torch.argmax(lg, -1, keepdim=True)
        state = {k: v for k, v in cache.items() if k != "pos"}
        out[tag] = [logits, last, *_leaves(state), *steps]
    for i, (a, g) in enumerate(zip(out["cpu"], out["gpu"])):
        torch.testing.assert_close(g.cpu(), a, **MODEL_TOL)
    err = max((g.cpu() - a).abs().max().item()
              for a, g in zip(out["cpu"], out["gpu"]))
    log(f"[model] {arch} SMOKE fp32 card vs CPU: forward, prefill, "
        f"{'/'.join(state)} cache, 4 decode steps max_abs_err {err:.3e} ok")
    return err


def _tree(node, fn):
    if isinstance(node, dict):
        return {k: _tree(v, fn) for k, v in node.items()}
    return fn(node)


# ------------------------------------------------------------- phase 5 ---
def phase_serve(torch, dev, kernels, arch):
    from repro_torch.models import registry
    from repro_torch.serve import ServeEngine, decode_sequential, scripted_trace

    # the previous path's weights and caches are gone: each path reports
    # its own peak
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = registry.get_config(arch)
    base = registry.bundle_for(cfg)
    t0 = time.perf_counter()
    params = base.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[serve] {arch} init {n_params / 1e9:.3f} B params on {dev} in "
        f"{init_s:.1f} s")

    reqs = scripted_trace(16, vocab_size=cfg.vocab_size, seed=0,
                          prompt_lens=(128, 500, 1000),
                          gen_lens=(16, 32, 64), arrival_every=1)
    # the timed engine runs the plain bundle; the logits are checked for
    # finiteness on the untimed decode_sequential pass below
    eng = ServeEngine(base, params, max_batch=8, max_len=2048, device=dev)
    for mod in kernels.values():
        mod.launches = 0
    t0 = time.perf_counter()
    report = eng.run(reqs)
    wall = time.perf_counter() - t0
    launches = {n: m.launches for n, m in kernels.items()}

    comps = {c.rid: c for c in report.completions}
    assert sorted(comps) == [r.rid for r in reqs], "requests lost"
    for r in reqs:
        assert len(comps[r.rid].tokens) == r.max_new_tokens, r.rid
    steps = len(reqs) + report.decode_steps      # prefills + decode steps
    L = cfg.num_layers
    if cfg.family == "ssm":   # {ln1, ssm} blocks; the scan in prefill only
        expect = {"rmsnorm": (L + 1) * steps, "swiglu": 0,
                  "flash_attention": 0, "ssm_scan": L * len(reqs)}
    else:
        expect = {"rmsnorm": (2 * L + 1) * steps, "swiglu": L * steps,
                  "flash_attention": L * len(reqs), "ssm_scan": 0}
    log(f"[serve] {arch} launches {launches} expected {expect}")
    assert launches == expect, (launches, expect)

    def finite(fn, where):
        def call(*a):
            logits, cache = fn(*a)
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"non-finite {where} logits")
            return logits, cache
        return call

    checked = dataclasses.replace(
        base, prefill=finite(base.prefill, "prefill"),
        decode_step=finite(base.decode_step, "decode"))
    seq = decode_sequential(checked, params, reqs, max_len=2048, device=dev)
    first_equal = all(comps[r.rid].tokens[0] == seq[r.rid][0] for r in reqs)
    agree = sum(a == b for r in reqs
                for a, b in zip(comps[r.rid].tokens[1:], seq[r.rid][1:]))
    n_dec = sum(len(comps[r.rid].tokens) - 1 for r in reqs)
    full_equal = sum(comps[r.rid].tokens == seq[r.rid] for r in reqs)
    log(f"[serve] {arch} first tokens equal decode_sequential: "
        f"{first_equal}; "
        f"decode tokens agreeing at their position: {agree}/{n_dec}; "
        f"streams fully equal: {full_equal}/{len(reqs)}")
    assert first_equal, "first tokens differ from decode_sequential"

    # the same statistics (mean, median, max over requests) as the CLI's
    summary = {
        "arch": arch, "params": n_params,
        **report.to_dict(), "prefills": len(reqs), "wall_s": wall,
        "init_s": init_s, "launches": launches, "expected_launches": expect,
        "decode_agree": [agree, n_dec], "streams_equal": [full_equal,
                                                          len(reqs)],
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
    }
    log(f"[serve] {arch} report {json.dumps(summary)}")
    return summary, launches


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    else:
        yield node


# ---------------------------------------------------------------- main ---
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", type=Path, default=None,
                    help="also write the checks and timings here as JSON")
    args = ap.parse_args(argv)
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 1
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    # fp32 references in full fp32 (no TF32) on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    from repro_torch.kernels import flash_attention, rmsnorm, ssm_scan, swiglu
    kernels = {"rmsnorm": rmsnorm, "swiglu": swiglu,
               "flash_attention": flash_attention, "ssm_scan": ssm_scan}

    smi, name = phase_card(torch)
    build_s = phase_build()
    checks, timed = phase_kernels(torch, dev, name)
    model_err = {arch: phase_model(torch, dev, arch) for arch in SERVE_ARCHS}
    serve, launches = {}, dict.fromkeys(kernels, 0)
    for arch in SERVE_ARCHS:
        serve[arch], counts = phase_serve(torch, dev, kernels, arch)
        for kname, n in counts.items():
            launches[kname] += n

    worst = {}
    for c in checks:
        worst[c["kernel"]] = max(worst.get(c["kernel"], 0.0),
                                 c["max_abs_err"])
    line = []
    for kname, t in timed.items():
        line.append({k: t[k] for k in (
            "name", "route", "source", "replaces")}
            | {"launches": launches[kname], "max_abs_err": t["max_abs_err"],
               "ms": t["ms"], "plain_ms": t["plain_ms"],
               "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
               "library_ms": t["library_ms"]})
    report = {"card": smi, "device_name": name, "build_s": build_s,
              "checks": checks, "worst_err_by_kernel": worst,
              "timed": timed, "model_max_abs_err": model_err,
              "serve": serve}
    if args.report:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
