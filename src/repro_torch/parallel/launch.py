"""Local ranks for the port's multi-rank paths: ``run_ranks``.

The JAX package has no counterpart: its processes come from outside, and
within a process jax sees every device.  The port starts ``world``
processes of its own, with ``multiprocessing``'s ``spawn`` method (a
parent that has initialised CUDA must not ``fork``), each joined to one
``torch.distributed`` process group through a ``file://`` store in a
fresh temporary directory, so no TCP port is fixed and runs side by side
do not meet.  The tests and ``chip_smoke.py`` start ranks this way; the
train CLI runs under ``torchrun`` instead.

``fn`` is a module-level function of ``repro_torch`` (spawn pickles it by
name, and a rank must import no test module), called as
``fn(rank, world, *args)`` after the process group is up; its result
comes back through a queue, so it is numpy or plain Python.  Nothing
hangs: the group's own timeout is ``timeout_s``, and the parent waits at
most ``timeout_s`` for all results, kills every rank when one raises,
dies or outlives the wait, and raises.  Build the kernel library in the
parent first (``kernels.build.build``): the ranks then only load it.
"""
from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DEVICES = ("cpu", "cuda")


def _rank_main(fn, rank: int, world: int, backend: str, device: str,
               init: str, timeout_s: float, args: Sequence[Any],
               results) -> None:
    try:
        # the ranks share one host: gloo's sockets stay on the loopback
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        if device == "cuda":    # a card a rank, in turn
            torch.cuda.set_device(rank % torch.cuda.device_count())
        elif device.startswith("cuda"):
            torch.cuda.set_device(torch.device(device))
        else:   # ranks share the host's cores, and spinning threads of
            # one rank would hold up the next
            torch.set_num_threads(1)
        dist.init_process_group(
            backend, init_method=init, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            results.put((rank, True, fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:   # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def _failures(results, rank: int, world: int, trace: str,
              grace_s: float = 2.0) -> str:
    """The first failure and those that follow within ``grace_s``: the
    rank that raised first may report after a peer that lost it."""
    lines = [f"rank {rank} of {world} raised:\n{trace}"]
    end = time.monotonic() + grace_s
    while time.monotonic() < end:
        try:
            r, ok, value = results.get(timeout=max(0.0,
                                                   end - time.monotonic()))
        except queue.Empty:
            break
        if not ok:
            lines.append(f"rank {r} of {world} raised:\n{value}")
    return "\n".join(lines)


def run_ranks(fn: Callable[..., Any], world: int, *, backend: str = "gloo",
              device: str = "cuda", timeout_s: float = 60.0,
              args: Sequence[Any] = ()) -> List[Any]:
    """``[fn(rank, world, *args) for rank in range(world)]``, each in its
    own process on ``device``: ``cpu``, ``cuda:i`` (every rank on card i)
    or ``cuda`` (rank r on card ``r % device_count``), over ``backend``.
    Raises ``RuntimeError`` with the rank's traceback when a rank raises
    or dies, ``TimeoutError`` when the results are not all in after
    ``timeout_s``; every rank is gone when it returns."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    if device.split(":")[0] not in DEVICES:
        raise ValueError(f"unsupported device {device!r}; use 'cpu' or "
                         "'cuda[:i]'")
    if device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("run_ranks runs its ranks on CUDA by default and "
                           "no CUDA device is available; pass device='cpu'")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro-ranks-")
    init = f"file://{os.path.join(tmp, 'store')}"
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, backend, device, init,
                               timeout_s, tuple(args), results))
             for r in range(world)]
    out: dict = {}
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{world - len(out)} of {world} ranks gave no result "
                    f"within {timeout_s} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode}")
                continue
            if not ok:
                raise RuntimeError(_failures(results, rank, world, value))
            out[rank] = value
        for p in procs:   # they exit once their result is read
            p.join(max(5.0, deadline - time.monotonic()))
        bad = [(r, p.exitcode) for r, p in enumerate(procs)
               if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"rank {bad[0][0]} exited with code "
                               f"{bad[0][1]}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]
