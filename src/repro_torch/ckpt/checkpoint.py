"""Checkpoints: atomic, async, resharding on restore (port of
``repro/ckpt/checkpoint.py``, with its names and its files).

Layout (one directory per step), as the JAX package writes it:
    <dir>/step_000042/
        manifest.json          # {"step", "extra", "leaves": [{"path",
                               #   "file", "shape", "dtype"}]}
        arrays/<idx>.npy       # one file per whole leaf

Leaves are numbered in JAX's flatten order (dict keys sorted) and their
paths are ``/``-joined keys (``params/blocks/attn/wq``, ``opt/count``,
``step``).  A tree with a scanned ``blocks`` stack carries JAX's
``_stacked`` marker (an fp32 zero) beside it, written here too, so that
for the same state the two packages write the same files and each reads
the other's.  numpy carries fp32 and int32; numpy has no bfloat16, and
JAX's ``np.save`` of one writes a 2-byte void (descr ``'<V2'``), so the
manifest's ``dtype`` is the truth: a bf16 leaf is written as that header
over its bits and read back as 2-byte integers viewed as
``torch.bfloat16``.

Fault-tolerance contract (the JAX package's):
  * atomic: written to ``step_X.tmp`` then ``os.rename``'d;
  * restartable: ``latest_step`` counts only directories with a manifest;
  * reshardable: a rank reads only its elements (``restore_rank`` through
    ``parallel/pipeline.rank_leaf_slices``), so a checkpoint written under
    one plan and rank layout restores under any other, or in one process;
    a JAX checkpoint of a stacked pp layout (``extra["layout"]``) is read
    through its stored ``virtual_layers``;
  * migratable: ``migrate`` moves a state between stacked pp layouts in
    memory (``plan_layout``, ``_norm_layout``), bit for bit on real
    layers;
  * async: ``AsyncCheckpointer.save_async`` copies the state to host
    memory before it returns and writes it on a background thread; the
    thread bookkeeping and the keep-window GC run under one lock.

Restore reads ``.npy`` files with ``mmap_mode="r"`` and copies one leaf,
or one slice of it, at a time to its device: the state never sits on the
host twice.

Ranks (``save_rank``): every rank writes its own elements into one
checkpoint, and nothing is gathered.  Rank 0 makes ``step_X.tmp`` and
every whole leaf's ``.npy`` at its full size, then marks it ready; each
rank writes the elements it owns (``LeafSlices.writer``) with positioned
writes, one a contiguous run of the file, flushes, and drops a done
marker; rank 0 writes the manifest and renames the directory once every
marker is there.  The ranks share
one filesystem (the processes of one host, as on the chip machine, or a
shared mount).  The ranks meet only through files: a background save
runs no collective, since the train step's collectives run on the same
groups.
"""
from __future__ import annotations

import io
import itertools
import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.parallel import pipeline
from repro_torch.parallel.pipeline import LeafSlices
from repro_torch.parallel.sharding import _at, map_with_path

MARKER = "_stacked"
READY = "ready"
# how long a rank waits for another's files
RANK_TIMEOUT_S = 1800.0
# (torch dtype, numpy storage dtype, .npy descr) by manifest dtype
DTYPES = {
    "float32": (torch.float32, np.float32, "<f4"),
    "int32": (torch.int32, np.int32, "<i4"),
    "bfloat16": (torch.bfloat16, np.int16, "<V2"),
}
_NAMES = {t: name for name, (t, _, _) in DTYPES.items()}


# ------------------------------------------------------------ the files ---
def _entries(tree: Any) -> List[Tuple[str, Any]]:
    """(path, leaf) in JAX's flatten order, ``_stacked`` markers included
    (a zero-d fp32 zero beside every ``blocks``); list element i (the
    hybrid stack's ``tail``) in index order under ``[i]``, JAX's name of
    a sequence key (``params/tail/[0]/ln1/scale``)."""
    out: List[Tuple[str, Any]] = []

    def walk(node, prefix):
        if isinstance(node, dict):
            if "blocks" in node and MARKER not in node:
                node = dict(node, **{MARKER: torch.zeros(())})
            for k in sorted(node):
                walk(node[k], prefix + (k,))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, prefix + (f"[{i}]",))
        else:
            out.append(("/".join(prefix), node))

    walk(tree, ())
    return out


def _manifest_leaves(tree: Any) -> List[Dict[str, Any]]:
    return [{"path": path, "file": f"{i}.npy", "shape": list(leaf.shape),
             "dtype": _NAMES[leaf.dtype]}
            for i, (path, leaf) in enumerate(_entries(tree))]


def _storage(t: torch.Tensor) -> np.ndarray:
    """A host tensor's bits as numpy (bf16 as int16), no copy."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _header(shape, dtype: str) -> bytes:
    """``np.save``'s header for a leaf (version 1.0, C order)."""
    f = io.BytesIO()
    np.lib.format.write_array_header_1_0(
        f, {"descr": DTYPES[dtype][2], "fortran_order": False,
            "shape": tuple(shape)})
    return f.getvalue()


def _write_npy(path: Path, t: torch.Tensor) -> None:
    """``np.save``'s file of a host tensor (JAX's for bf16 too)."""
    with open(path, "wb") as f:
        f.write(_header(t.shape, _NAMES[t.dtype]))
        np.ascontiguousarray(_storage(t)).tofile(f)


def _create_npy(path: Path, shape, dtype: str) -> None:
    """A ``.npy`` of ``shape`` at its full size, its elements unwritten."""
    with open(path, "wb") as f:
        f.write(_header(shape, dtype))
        n = int(np.prod(shape, dtype=np.int64))
        f.truncate(f.tell() + n * np.dtype(DTYPES[dtype][1]).itemsize)


def _pwrite(fd: int, buf: np.ndarray, offset: int) -> None:
    view = memoryview(buf).cast("B")
    while view:         # a write may take fewer bytes than it was given
        n = os.pwrite(fd, view, offset)
        view, offset = view[n:], offset + n


def _write_box(fd: int, header: int, shape: Tuple[int, ...],
               box: Tuple[slice, ...], src: np.ndarray) -> None:
    """``src`` (C-contiguous, the box's shape) into the elements ``box`` of
    a ``.npy`` of ``shape`` whose data starts at byte ``header``: one
    write a contiguous run of the file."""
    k = len(shape) - 1      # the dims after k are whole: a run spans them
    while k > 0 and box[k] == slice(0, shape[k]):
        k -= 1
    strides = [int(np.prod(shape[j + 1:], dtype=np.int64))
               for j in range(len(shape))]
    if not shape:
        _pwrite(fd, src, header)
        return
    rows = src.reshape(-1, (box[k].stop - box[k].start) * strides[k])
    size = src.itemsize
    for row, lead in zip(rows, itertools.product(
            *(range(b.start, b.stop) for b in box[:k]))):
        at = sum(i * st for i, st in zip(lead, strides)) \
            + box[k].start * strides[k]
        _pwrite(fd, row, header + at * size)


def _open(path: Path, dtype: str) -> np.ndarray:
    """A read-only memory map of a ``.npy`` as its storage dtype."""
    return np.load(path, mmap_mode="r").view(DTYPES[dtype][1])


def _step_dirs(ckpt_dir: str, step: int) -> Tuple[Path, Path]:
    root = Path(ckpt_dir)
    return root / f"step_{step:08d}", root / f"step_{step:08d}.tmp"


def _finish(tmp: Path, final: Path, manifest: Dict[str, Any]) -> Path:
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save(ckpt_dir: str, step: int, state: Any,
         extra: Optional[Dict] = None) -> Path:
    """Synchronous atomic save of a whole state (tensors, on any device:
    each leaf is copied to the host in turn)."""
    final, tmp = _step_dirs(ckpt_dir, step)
    if tmp.exists():
        shutil.rmtree(tmp)
    (tmp / "arrays").mkdir(parents=True)
    for i, (_, leaf) in enumerate(_entries(state)):
        _write_npy(tmp / "arrays" / f"{i}.npy", leaf.cpu())
    return _finish(tmp, final, {"step": step, "extra": extra or {},
                                "leaves": _manifest_leaves(state)})


def all_steps(ckpt_dir: str) -> List[int]:
    root = Path(ckpt_dir)
    if not root.exists():
        return []
    out = []
    for p in root.iterdir():
        if p.name.startswith("step_") and not p.name.endswith(".tmp") \
                and (p / "manifest.json").exists():
            out.append(int(p.name.split("_")[1]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _manifest(ckpt_dir: str, step: int) -> Dict[str, Any]:
    final, _ = _step_dirs(ckpt_dir, step)
    return json.loads((final / "manifest.json").read_text())


def manifest_extra(ckpt_dir: str, step: int) -> Dict:
    """The ``extra`` dict a checkpoint was saved with (the manifest only).
    The Trainer stores the state's pipeline layout and data state here."""
    return _manifest(ckpt_dir, step).get("extra", {})


def clear_partial(ckpt_dir: str) -> None:
    """Remove every ``step_X.tmp``: saves a crashed run left unfinished."""
    root = Path(ckpt_dir)
    if root.exists():
        for p in root.glob("step_*.tmp"):
            shutil.rmtree(p, ignore_errors=True)


# ------------------------------------------------------------- restore ---
def _stacked_leaf(path: str) -> bool:
    """A leaf the JAX pp layout stacks: blocks of the parameters and of
    the AdamW m, v and master."""
    p = path.split("/")
    return (p[:2] == ["params", "blocks"]
            or (p[0] == "opt" and p[1:2] in (["m"], ["v"], ["master"])
                and p[2:3] == ["blocks"]))


def _read(mm: np.ndarray, whole: Tuple[slice, ...],
          layout: Optional[Dict[str, Any]]) -> np.ndarray:
    """The elements ``whole`` of a canonical leaf from its file ``mm``;
    under a stacked ``layout`` each canonical layer range comes from its
    virtual stages' ``[s, c, i]`` slots."""
    if layout is None:
        return mm[whole]
    pp, vpp, vl = layout["pp"], layout["vpp"], layout["virtual_layers"]
    a, b = whole[0].start, whole[0].stop
    parts, off = [], 0
    for vs, n in enumerate(vl):
        lo, hi = max(a, off), min(b, off + n)
        if lo < hi:
            slot = (vs % pp, vs // pp) if vpp > 1 else (vs % pp,)
            parts.append(mm[slot + (slice(lo - off, hi - off),) + whole[1:]])
        off += n
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


def _stored_shape(whole: Tuple[int, ...],
                  layout: Optional[Dict[str, Any]]) -> Tuple[int, ...]:
    if layout is None:
        return whole
    vl = layout["virtual_layers"]
    if sum(vl) != whole[0]:
        raise ValueError(f"layout {layout} holds {sum(vl)} layers, the "
                         f"state {whole[0]}")
    slots = (layout["pp"],) + ((layout["vpp"],) if layout["vpp"] > 1 else ())
    return slots + (max(vl),) + tuple(whole[1:])


def _restore_tree(d: Path, manifest: Dict[str, Any], slices: Any,
                  device_of: Callable[[Tuple[str, ...]], torch.device],
                  layout: Optional[Dict[str, Any]]) -> Any:
    """``slices`` read from the checkpoint directory ``d``, each leaf
    onto ``device_of(its path)``."""
    by_path = {e["path"]: e for e in manifest["leaves"]}

    def one(path: Tuple[str, ...], sl: LeafSlices) -> torch.Tensor:
        key = "/".join(path)
        ent = by_path[key]
        lay = layout if _stacked_leaf(key) else None
        want = _stored_shape(sl.whole, lay)
        if tuple(ent["shape"]) != want:
            raise ValueError(f"shape mismatch at {key}: "
                             f"{tuple(ent['shape'])} vs {want}")
        mm = _open(d / "arrays" / ent["file"], ent["dtype"])
        out = torch.empty(sl.shape, dtype=DTYPES[ent["dtype"]][0],
                          device=device_of(path))
        for local, whole in sl.pieces:
            # one slice at a time through the host, then to the device
            host = torch.from_numpy(np.array(_read(mm, whole, lay)))
            out[local].copy_(host.view(out.dtype))
        del mm
        return out

    return map_with_path(one, slices)


def restore_rank(ckpt_dir: str, step: int, slices: Any,
                 device=None) -> Tuple[Any, Dict]:
    """A rank's state from a checkpoint: each leaf of ``slices``
    (``pipeline.rank_leaf_slices`` against the canonical whole state)
    read from its whole leaf's file, only the rank's elements, onto
    ``device`` (default the CPU).  A checkpoint of a stacked pp layout
    (``extra["layout"]``, as the JAX trainer writes) is read through that
    layout.  Returns (state, extra)."""
    final, _ = _step_dirs(ckpt_dir, step)
    manifest = _manifest(ckpt_dir, step)
    extra = manifest.get("extra", {})
    dev = torch.device("cpu" if device is None else device)
    state = _restore_tree(final, manifest, slices, lambda _: dev,
                          _norm_layout(extra.get("layout")))
    return state, extra


def read_box(ckpt_dir: str, step: int, path: str,
             box: Tuple[slice, ...]) -> torch.Tensor:
    """The elements ``box`` of the whole leaf ``path`` (``/``-joined) of a
    canonical-layout checkpoint, on the host."""
    final, _ = _step_dirs(ckpt_dir, step)
    ent = {e["path"]: e for e in _manifest(ckpt_dir, step)["leaves"]}[path]
    mm = _open(final / "arrays" / ent["file"], ent["dtype"])
    return torch.from_numpy(np.array(mm[box])).view(DTYPES[ent["dtype"]][0])


def restore(ckpt_dir: str, step: int, target: Any) -> Tuple[Any, Dict]:
    """Restore into the structure of ``target`` (a tree of tensors, or of
    ``meta`` tensors for shapes and dtypes), each leaf whole and in its
    stored shape, on the target leaf's device (the CPU for a ``meta``
    leaf).  Returns (state, extra)."""
    final, _ = _step_dirs(ckpt_dir, step)
    manifest = _manifest(ckpt_dir, step)

    def whole(t):
        shape = tuple(t.shape)
        full = tuple(slice(0, n) for n in shape)
        return LeafSlices(shape, shape, ((full, full),), True)

    def place(path):
        dev = _at(target, path).device
        return torch.device("cpu") if dev.type == "meta" else dev

    state = _restore_tree(final, manifest, tree_map(whole, target), place,
                          None)
    return state, manifest.get("extra", {})


# --------------------------------------------------------------- ranks ---
class RankPart(NamedTuple):
    """What ``save_rank`` needs of a rank: its ``rank_leaf_slices``, the
    whole state's shapes and dtypes (a ``meta`` tree), its rank and the
    world size."""
    slices: Any
    whole: Any
    rank: int
    world: int


def _wait_for(paths: List[Path], timeout_s: float, what: str) -> None:
    end = time.monotonic() + timeout_s
    while not all(p.exists() for p in paths):
        if time.monotonic() > end:
            missing = [p.name for p in paths if not p.exists()]
            raise TimeoutError(f"{what}: {missing} not there after "
                               f"{timeout_s} s")
        time.sleep(0.05)


def save_rank(ckpt_dir: str, step: int, state: Any, part: RankPart,
              extra: Optional[Dict] = None,
              timeout_s: float = RANK_TIMEOUT_S) -> Optional[Path]:
    """This rank's elements of one checkpoint, every rank calling it at
    the same step (see the module docstring); rank 0 returns the
    checkpoint's path once every rank's elements are in, the others
    None."""
    final, tmp = _step_dirs(ckpt_dir, step)
    leaves = _manifest_leaves(part.whole)
    files = {e["path"]: e for e in leaves}
    if part.rank == 0:
        if tmp.exists():
            shutil.rmtree(tmp)
        (tmp / "arrays").mkdir(parents=True)
        for e in leaves:
            _create_npy(tmp / "arrays" / e["file"], e["shape"], e["dtype"])
        for path, leaf in _entries(part.whole):   # the markers: whole here
            if path.rsplit("/", 1)[-1] == MARKER:
                _write_npy(tmp / "arrays" / files[path]["file"], leaf)
        (tmp / READY).touch()
    else:
        _wait_for([tmp / READY], timeout_s, f"rank {part.rank}, step {step}")

    def write(path: Tuple[str, ...], sl: LeafSlices, leaf: torch.Tensor):
        if not sl.writer:
            return
        ent = files["/".join(path)]
        src = _storage(leaf)
        header = len(_header(ent["shape"], ent["dtype"]))
        # positioned writes, not a writable memory map: each of a map's
        # page faults stalls the process's other threads, the train step
        fd = os.open(tmp / "arrays" / ent["file"], os.O_WRONLY)
        try:
            for local, whole in sl.pieces:
                _write_box(fd, header, tuple(ent["shape"]), whole,
                           np.ascontiguousarray(src[local]))
            os.fsync(fd)
        finally:
            os.close(fd)

    map_with_path(lambda path, sl: write(path, sl, _at(state, path)),
                  part.slices)
    (tmp / f"done.{part.rank}").touch()
    if part.rank != 0:
        return None
    done = [tmp / f"done.{r}" for r in range(part.world)]
    _wait_for(done, timeout_s, f"rank 0, step {step}")
    for p in done + [tmp / READY]:
        p.unlink()
    return _finish(tmp, final, {"step": step, "extra": extra or {},
                                "leaves": leaves})


# ---------------------------------------------------------------- async ---
def snapshot(state: Any) -> Any:
    """A host copy of every leaf (a copy on the CPU too: the train step
    updates its state in place); None leaves stay None."""
    return tree_map(lambda t: None if t is None
                    else t.detach().to("cpu", copy=True), state)


class AsyncCheckpointer:
    """Snapshot-on-call, write-on-thread.  One in-flight save at a time.

    Thread-safe as the JAX class: ``wait``/``save_async`` may race from
    different threads; the ``_thread`` swap and the keep-window ``_gc``
    both run under ``_lock``, so a ``wait()`` returning while a new
    ``save_async()`` registers cannot leave a save unsupervised, and a
    rename cannot race a GC's directory scan.  ``timings`` holds the last
    save's ``snapshot_s`` (blocking), ``write_s`` (background) and
    ``bytes``."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None
        self.timings: Dict[str, float] = {}

    def wait(self):
        """Block until no save is in flight; re-raise (once) a background
        save's error."""
        while True:
            with self._lock:
                t = self._thread
            if t is None:
                break
            t.join()
            with self._lock:
                if self._thread is t:   # only clear what we joined
                    self._thread = None
        with self._lock:
            err, self.last_error = self.last_error, None
        if err is not None:
            raise err

    def save_async(self, step: int, state: Any,
                   extra: Optional[Dict] = None,
                   part: Optional[RankPart] = None):
        """Start a background save of ``state`` (with ``part``: this
        rank's share of one checkpoint, ``save_rank``, of which only the
        leaves this rank writes are copied).  Like ``wait``, surfaces a
        previous background save's error here (once)."""
        self.wait()
        if part is not None:    # another rank writes the rest
            state = map_with_path(
                lambda path, sl: _at(state, path) if sl.writer else None,
                part.slices)
        t0 = time.perf_counter()
        host_state = snapshot(state)    # before the next step mutates it
        snap_s = time.perf_counter() - t0
        nbytes = sum(x.numel() * x.element_size()
                     for x in tree_leaves(host_state) if x is not None)

        def work():
            try:
                t1 = time.perf_counter()
                if part is None:
                    save(self.dir, step, host_state, extra)
                else:
                    save_rank(self.dir, step, host_state, part, extra)
                with self._lock:     # gc under the same lock as completion
                    self.timings = {"snapshot_s": snap_s, "bytes": nbytes,
                                    "write_s": time.perf_counter() - t1}
                    if part is None or part.rank == 0:
                        self._gc()
            except BaseException as e:  # noqa: BLE001
                with self._lock:
                    self.last_error = e

        t = threading.Thread(target=work, daemon=True)
        while True:
            with self._lock:
                if self._thread is None:
                    # register AND start under the lock: a concurrent
                    # wait() must never see (and join) an unstarted thread
                    self._thread = t
                    t.start()
                    break
            self.wait()   # lost a registration race: drain and retry

    def _gc(self):
        # caller holds self._lock; only complete checkpoints are seen
        steps = sorted(all_steps(self.dir))
        for s in steps[:-self.keep]:
            shutil.rmtree(Path(self.dir) / f"step_{s:08d}",
                          ignore_errors=True)


# ------------------------------------------------------- plan migration ---
def plan_layout(plan) -> Optional[Dict[str, Any]]:
    """A ParallelPlan's stacked-block layout as a JSON-able dict (what the
    JAX trainer stamps into manifests); None is the canonical unstacked
    ``(L, ...)`` layout, the one every route of the port trains in.
    ``stage_tp`` records each stage's tensor width: leaves are stored
    whole, so a tp change never moves content, but two layouts that
    differ only there compare unequal."""
    if plan is None:
        return None
    return {"pp": plan.pp, "vpp": plan.vpp,
            "virtual_layers": list(plan.virtual_layers),
            "stage_tp": [s.tp for s in plan.stages]}


def _norm_layout(layout) -> Optional[Dict[str, Any]]:
    if layout is None:
        return None
    if isinstance(layout, dict):
        pp = int(layout["pp"])
        if "stage_tp" not in layout:
            # a manifest from before per-stage tp: width 1 everywhere (the
            # restack is the identity on real layers, so this is safe)
            tps = [1] * pp
        else:
            # a present stage_tp must be well formed: an empty or
            # wrong-length list is corruption, not a legacy manifest
            tps = layout["stage_tp"]
            try:
                ok = (isinstance(tps, (list, tuple)) and len(tps) == pp
                      and all(int(x) >= 1 for x in tps))
            except (TypeError, ValueError):
                ok = False
            if not ok:
                raise ValueError(
                    f"malformed stage_tp {tps!r} in layout (pp={pp}): "
                    f"expected {pp} widths >= 1, or no stage_tp key at "
                    f"all for a pre-stage_tp legacy manifest")
        return {"pp": pp, "vpp": int(layout["vpp"]),
                "virtual_layers": [int(x) for x in layout["virtual_layers"]],
                "stage_tp": [int(x) for x in tps]}
    return plan_layout(layout)   # a ParallelPlan (duck-typed)


def migrate(state: Any, old_plan, new_plan) -> Any:
    """A train state moved across a plan change: ``old_plan``/``new_plan``
    are ParallelPlans, layout dicts (``plan_layout``) or None (the
    canonical layout).  The parameters and the AdamW m, v and master
    unstack to canonical layer order and restack under the new layout's
    ``virtual_layers``; real layers move bit for bit, padding rows are new
    zeros.  Works on any device, ``meta`` included (shapes of a layout)."""
    old = _norm_layout(old_plan)
    new = _norm_layout(new_plan)
    if old == new:
        return state

    def tr(tree):
        if old is not None:
            tree = pipeline.unstack_blocks_for_stages(
                tree, old["pp"], old["virtual_layers"], vpp=old["vpp"])
        if new is not None:
            tree = pipeline.stack_blocks_for_stages(
                tree, new["pp"], new["virtual_layers"], vpp=new["vpp"])
        return tree

    out = dict(state)
    out["params"] = tr(state["params"])
    opt = dict(state["opt"])
    for k in ("m", "v", "master"):
        if k in opt:
            opt[k] = tr(opt[k])
    out["opt"] = opt
    return out
