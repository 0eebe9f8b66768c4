"""The port stands alone: no JAX, no ``repro``, no silent CPU fallback.

  * an AST walk of ``src/repro_torch/**.py`` and ``chip_smoke.py`` finds no
    import of jax, jaxlib, ml_dtypes or the ``repro`` package;
  * importing every ``repro_torch`` module in a fresh interpreter leaves
    ``jax`` and ``repro`` out of ``sys.modules``;
  * with no CUDA device, the entry points asked for no device raise
    instead of running on the CPU, and the kernel wrappers refuse CPU
    tensors (the CPU path is chosen by ``kernels.ops`` from the device).
"""
import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import rmsnorm as trn  # noqa: E402
from repro_torch.kernels import ssm_scan as tss  # noqa: E402
from repro_torch.kernels import swiglu as tsg  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import convert, registry, transformer  # noqa: E402
from repro_torch.serve import (ServeEngine, decode_sequential,  # noqa: E402
                               scripted_trace)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    names = list(_imported(ast.parse(path.read_text())))
    bad = [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path}: imports {bad}"


def test_importing_the_port_loads_no_jax():
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
        for p in PKG.rglob("*.py") if p.name != "__init__.py")
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(k for k in sys.modules if k.split('.')[0]"
        " in ('jax', 'jaxlib', 'ml_dtypes', 'repro'))))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert len(mods) >= 15


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda):
    b = registry.get_bundle("llama3-8b", smoke=True)
    cfg = b.cfg
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init_lm(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        b.init_cache(1, 8)
    params = b.init(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(b, params, max_batch=2, max_len=16)
    reqs = scripted_trace(1, vocab_size=cfg.vocab_size)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode_sequential(b, params, reqs, max_len=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.from_jax({"w": [[1.0]]})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--smoke"])


@pytest.mark.parametrize("argv", [[], ["--device-times"]],
                         ids=["smoke", "device-times child"])
def test_chip_smoke_fails_without_cuda(argv):
    """``chip_smoke.py``, and its profiler child, exit non-zero and print
    no result where torch sees no CUDA device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), *argv],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert r.stdout == ""
    assert "torch.cuda.is_available() is false" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """``chip_smoke.py`` copied into a directory that holds nothing else of
    the repo exits 1 and prints no result, before it imports torch: the
    required failure of the script without the program (on a machine with
    a card as on one without)."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    r = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 1
    assert r.stdout == ""
    assert "src/repro_torch not found next to this script" in r.stderr


def test_engine_rejects_params_on_another_device():
    b = registry.get_bundle("llama3-8b", smoke=True)
    params = b.init(b.cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        ServeEngine(b, params, max_batch=2, max_len=16, device="meta")
    elsewhere = {**params, "embed": params["embed"].to("meta")}
    with pytest.raises(ValueError, match="params live on meta"):
        ServeEngine(b, elsewhere, max_batch=2, max_len=16, device="cpu")


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises: no plain-version fallback."""
    x = torch.randn(2, 64)
    with pytest.raises(ValueError, match="CUDA kernel"):
        trn.rmsnorm(x, torch.ones(64))
    with pytest.raises(ValueError, match="CUDA kernel"):
        tsg.swiglu(x, x)
    q = torch.randn(1, 8, 2, 16)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tfa.flash_attention(q, q, q)
    u, bc = torch.randn(1, 8, 16), torch.randn(1, 8, 4)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tss.ssm_scan(u, u, bc, bc, torch.randn(16, 4))


def test_cli_serves_on_cpu_when_asked(capsys):
    serve_cli.main(["--smoke", "--device", "cpu", "--requests", "3",
                    "--max-batch", "2"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["device"] == "cpu" and summary["requests"] == 3
    assert summary["kernel_launches"] == {
        "rmsnorm": 0, "swiglu": 0, "flash_attention": 0, "ssm_scan": 0}
