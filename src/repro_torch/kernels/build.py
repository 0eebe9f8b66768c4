"""Build and load the port's CUDA kernels.

The sources in ``csrc/`` are compiled for Hopper (``sm_90a``) into one
shared library with a plain C interface, loaded with ``ctypes``.  Each
source gets its own ``nvcc -c`` and all of them run at once; one more
``nvcc -shared`` links the objects.  The build happens at first use, from
the sources in the repository only, into ``kernels/_build/`` (listed in
``.gitignore``), named by a digest of the sources and flags so an edited
source is rebuilt and an unchanged one is loaded as it is.

Every C function returns ``cudaGetLastError()`` after its launch;
``check`` raises on anything but 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("common.cu", "rmsnorm.cu", "swiglu.cu", "flash_attention.cu",
           "ssm_scan.cu", "ring_attention.cu")
HEADERS = ("common.cuh", "mma.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_c = ctypes
_P = _c.c_void_p
_SIGNATURES = {
    "repro_cuda_error_string": (_c.c_char_p, [_c.c_int]),
    "rmsnorm_fwd": (_c.c_int, [_P, _P, _P, _c.c_longlong, _c.c_int,
                               _c.c_float, _c.c_int, _P]),
    "rmsnorm_bwd": (_c.c_int, [_P] * 7 + [_c.c_longlong, _c.c_int, _c.c_int,
                                          _c.c_float, _c.c_int, _P]),
    "swiglu_fwd": (_c.c_int, [_P, _P, _P, _c.c_longlong, _c.c_int,
                              _c.c_int, _P]),
    "swiglu_bwd": (_c.c_int, [_P] * 5 + [_c.c_longlong, _c.c_int, _c.c_int,
                                         _P]),
    "flash_attention_fwd": (_c.c_int, [_P] * 5 + [_c.c_int] * 6
                            + [_c.c_longlong] * 9
                            + [_c.c_int, _c.c_int, _c.c_float, _c.c_float,
                               _c.c_int, _P]),
    "ssm_scan_fwd": (_c.c_int, [_P] * 8 + [_c.c_int] * 5 + [_P]),
    "ssm_scan_bwd": (_c.c_int, [_P] * 17 + [_c.c_int] * 5 + [_P]),
    "ring_step_fwd": (_c.c_int, [_P] * 9 + [_c.c_int] * 8
                      + [_c.POINTER(_c.c_int), _c.c_int, _c.c_float,
                         _c.c_int, _P]),
    "ring_step_bwd": (_c.c_int, [_P] * 9 + [_c.c_int] * 8
                      + [_c.POINTER(_c.c_int), _c.c_int, _c.c_int,
                         _c.c_float, _c.c_float, _c.c_int, _P]),
    "flash_attention_fwd_attrs": (_c.c_int, [_c.c_int,
                                             _c.POINTER(_c.c_int)]),
    "ring_step_fwd_attrs": (_c.c_int, [_c.c_int, _c.POINTER(_c.c_int)]),
    "ssm_scan_attrs": (_c.c_int, [_c.c_int, _c.POINTER(_c.c_int)]),
    "ssm_scan_bwd_attrs": (_c.c_int, [_c.c_int, _c.POINTER(_c.c_int)]),
    "ring_step_bwd_attrs": (_c.c_int, [_c.c_int, _c.c_int,
                                       _c.POINTER(_c.c_int)]),
    "rmsnorm_attrs": (_c.c_int, [_c.c_int] * 3 + [_c.POINTER(_c.c_int)]),
    "rmsnorm_bwd_blocks_per_sm": (_c.c_int, []),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
ptxas_log: str = ""                     # nvcc/ptxas output of that build


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin: "
                       "the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: List[List[str]]) -> List[str]:
    """Run the commands at once; raise on the first that fails.  Every
    process started is waited for (or killed) before returning."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs: List[str] = []
    try:
        for cmd, p in zip(cmds, procs):
            out, _ = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}): "
                                   f"{' '.join(cmd)}\n{out}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def build() -> Path:
    """Compile the library if it is not built yet; return its path."""
    global ptxas_log
    so = BUILD_DIR / f"libreprokernels-{_digest()}.so"
    if so.exists():
        return so
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR, prefix="tmp-"))
    try:
        objs = [tmp / (Path(s).stem + ".o") for s in SOURCES]
        outs = _run_all([[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c",
                          str(CSRC / s), "-o", str(o)]
                         for s, o in zip(SOURCES, objs)])
        _run_all([[nvcc, "-shared", "-o", str(tmp / so.name),
                   *map(str, objs)]])
        os.replace(tmp / so.name, so)   # atomic: readers never see a partial
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ptxas_log = "\n".join(outs)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
    return _lib


def check(err: int, kernel: str) -> None:
    if err != 0:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA error {err} ({msg})")


def kernel_attrs(fn: str, *args: int) -> dict:
    """What the card's compiled kernel behind the C function ``fn`` takes
    as launched: the bf16 tensor-core kernels (``flash_attention_fwd_attrs``,
    ``ring_step_fwd_attrs``) at head dim ``args``, the backward
    (``ring_step_bwd_attrs``) at ``(head dim, windowed)``,
    the selective scan (``ssm_scan_attrs``) and its backward
    (``ssm_scan_bwd_attrs``) for u of dtype code ``args``,
    rmsnorm (``rmsnorm_attrs``) at ``(bwd, D, dtype code)``."""
    out = (ctypes.c_int * 4)()
    check(getattr(library(), fn)(*args, out), fn)
    return dict(zip(("registers", "spill_bytes", "smem_bytes",
                     "blocks_per_sm"), out))


def require_aligned16(kernel: str, **tensors: torch.Tensor) -> None:
    """Bases and the strides of every dimension longer than 1 on 16-byte
    boundaries (the tensor-core kernels copy 16 bytes at a time)."""
    for name, t in tensors.items():
        es = t.element_size()
        bad = t.data_ptr() % 16 or any(
            (st * es) % 16 for n, st in zip(t.shape, t.stride()) if n > 1
            and st != 1)
        if bad:
            raise ValueError(f"{kernel}: {name} (strides {t.stride()}) is "
                             "not 16-byte aligned in its base and strides")


def dtype_code(t: torch.Tensor) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"unsupported dtype {t.dtype}; the kernels take "
                        f"{sorted(map(str, DTYPE_CODES))}") from None


def forbid_grad(kernel: str, use: str, *tensors: torch.Tensor) -> None:
    """A wrapper's outputs have no ``grad_fn``.  Refuse inputs that need a
    gradient while autograd records, instead of cutting the graph without
    a word; inside an autograd function (whose forward and backward run
    with grad mode off) the call is allowed.  ``use`` says what to do
    instead."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: an input requires grad and the kernel's output would "
            f"carry no gradient ({use})")


def require_cuda(*tensors: torch.Tensor) -> torch.device:
    """All tensors on the current CUDA device; return it."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel called with a tensor on {dev}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"tensor on {dev} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    return dev


def stream_handle(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream
