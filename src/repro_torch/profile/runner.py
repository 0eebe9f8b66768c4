"""Microbenchmark harness: measure what the predictor otherwise derives.

The port's rewrite of ``repro/profile/runner.py`` on torch.  It times two
families of work on one device, the card unless the caller asks for the
CPU, and writes the results into a ProfileStore under the JAX runner's
ops and shapes, so ``ProfiledCostModel`` serves either package's profile:

  * kernels   — rmsnorm / swiglu / flash_attention through
                ``repro_torch.kernels.ops``, fwd and fwd+bwd through
                autograd (CUDA tensors launch the kernels, CPU tensors take
                the plain versions), warmup + trimmed mean;
  * layers    — the reference loss (``train.steps.make_loss_fn``) fwd and
                fwd+bwd at two depths (pattern length a and 2a); per-layer
                time is the difference, the paper's 'profile small,
                predict big' probe applied to wall time.  Swept over
                (seq_len, micro_bs, tp); ``smoke=False`` profiles the arch
                at its full width.  At tp > 1 the probes are the
                tensor-parallel loss on tp local ranks
                (``parallel/launch.run_ranks``), each timing its share.

  * collectives — psum, all_gather and ppermute through the ICCL
                ``Communicator`` over every rank of an initialised
                ``torch.distributed`` group (gloo for CPU tensors, NCCL for
                the cards), and the ``link`` / ``ring_hop`` bandwidth of
                the largest ppermute; with one process or one device they
                are skipped, as the JAX runner skips them on one device.

On the card each timed call sits between a pair of CUDA events, then a
synchronize; on the CPU ``time.perf_counter`` brackets it.

Usage:
    python -m repro_torch.profile.runner --quick --device cpu --out p.json
    python -m repro_torch.profile.runner --arch llama3-8b   # on the card
"""
from __future__ import annotations

import argparse
import statistics
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.iccl.communicator import Communicator
from repro_torch.models import registry, transformer
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import ShardingRules, shard_tree
from repro_torch.profile.store import ProfileStore
from repro_torch.train import steps
from repro_torch.utils.device import DeviceLike, resolve_device


# ----------------------------------------------------------------- timing --
def timeit(fn: Callable[[], object], warmup: int = 2, reps: int = 5,
           trim: float = 0.2, device: DeviceLike = "cpu"
           ) -> Tuple[float, float]:
    """(trimmed-mean, stdev) of fn's time in seconds.  On a CUDA device
    each rep is one call between two CUDA events, then a synchronize; on
    the CPU, ``perf_counter`` around the call."""
    cuda = torch.device(device).type == "cuda"
    for _ in range(warmup):
        fn()
    if cuda:
        torch.cuda.synchronize()
    ts: List[float] = []
    for _ in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            ts.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
    ts.sort()
    k = int(len(ts) * trim)
    core = ts[k:len(ts) - k] or ts
    mean = sum(core) / len(core)
    std = statistics.pstdev(core) if len(core) > 1 else 0.0
    return mean, std


def device_kind(device: DeviceLike = None) -> str:
    """The profile's device kind: the card's name normalised as the JAX
    runner normalises ``device_kind`` ("NVIDIA H100 80GB HBM3" ->
    "nvidia-h100-80gb-hbm3"), or "cpu"."""
    dev = resolve_device(device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return kind.strip().lower().replace(" ", "-")


# ---------------------------------------------------------------- kernels --
def bench_kernels(store: ProfileStore, dev: str, seqs: Sequence[int],
                  micro_bss: Sequence[int], d_model: int = 256,
                  warmup: int = 2, reps: int = 5, verbose: bool = True,
                  device: DeviceLike = None):
    """fwd and fwd+bwd of each kernel at the JAX runner's shapes (fp32,
    4 heads); the gradient is taken with respect to the first input, as
    ``jax.grad`` takes it there."""
    from repro_torch.kernels import ops
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    n_heads, hd = 4, d_model // 4
    for seq in seqs:
        for mbs in micro_bss:
            shape = {"seq_len": seq, "micro_bs": mbs, "d_model": d_model}
            x = torch.randn((mbs, seq, d_model), generator=gen,
                            device=device)
            scale = torch.ones((d_model,), device=device)
            qkv = torch.randn((mbs, seq, n_heads, hd), generator=gen,
                              device=device)
            cases: Dict[str, Tuple[Callable, tuple]] = {
                "rmsnorm": (ops.rmsnorm, (x, scale)),
                "swiglu": (ops.swiglu, (x, x)),
                "flash_attention": (ops.flash_attention, (qkv, qkv, qkv)),
            }
            for name, (fn, args) in cases.items():
                with torch.no_grad():
                    t_fwd, s_fwd = timeit(lambda: fn(*args), warmup, reps,
                                          device=device)
                first = args[0].detach().requires_grad_()

                def grad():
                    out = fn(first, *args[1:])
                    return torch.autograd.grad(out.float().sum(), first)

                t_fb, s_fb = timeit(grad, warmup, reps, device=device)
                store.put(dev, f"kernel_{name}", shape,
                          {"fwd_s": t_fwd, "fwd_std": s_fwd,
                           "fwdbwd_s": t_fb, "fwdbwd_std": s_fb})
                if verbose:
                    print(f"  kernel {name:16s} seq={seq:5d} mbs={mbs} "
                          f"fwd={t_fwd*1e3:8.3f}ms fwd+bwd={t_fb*1e3:8.3f}ms")


# ----------------------------------------------------------------- layers --
# how long the parent waits for the ranks of a tp > 1 probe
TP_PROBE_TIMEOUT_S = 900.0


def _loss_fns(arch: str, n_layers: int, smoke: bool, device: torch.device,
              model: Optional[Communicator] = None):
    """(cfg, fwd, step) of the reference loss at depth ``n_layers``: fwd is
    the loss without autograd, step its gradient over every parameter leaf
    (``train.steps.make_train_step``'s ``grads_of``).  On a
    tensor-parallel rank (``model``) it is this rank's share of the
    sharded loss, its collectives included."""
    b = registry.get_bundle(arch, smoke=smoke, num_layers=n_layers)
    params = b.init(b.cfg, seed=0, device=device)
    if model is not None:
        params = shard_tree(params, ShardingRules(b.cfg, tp=model.size()),
                            model.index())
    params = adamw.tree_map(lambda p: p.requires_grad_(), params)
    leaves = adamw.tree_leaves(params)
    loss = steps.make_loss_fn(b, model)

    def fwd(batch):
        with torch.no_grad():
            return loss(params, batch)[0]

    def step(batch):
        return torch.autograd.grad(loss(params, batch)[0], leaves,
                                   allow_unused=True)

    return b.cfg, fwd, step


def _batch(cfg, mbs: int, seq: int, device: torch.device):
    """The family's batch, as JAX's runner takes ``make_batch``'s: the
    enc-dec frames and the VLM's image embeddings too."""
    data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=seq,
                           global_batch=mbs, seed=0, family=cfg.family,
                           d_model=cfg.d_model,
                           n_vision_tokens=cfg.n_vision_tokens).batch_at(0)
    return {k: torch.as_tensor(v, device=device) for k, v in data.items()}


def _depths(arch: str, smoke: bool) -> Tuple[int, int]:
    cfg0 = registry.get_config(arch, smoke=smoke)
    a = len(cfg0.block_pattern) if cfg0.block_pattern else 1
    return a, 2 * a


def probe_times(arch: str, seqs: Sequence[int], micro_bss: Sequence[int],
                warmup: int, reps: int, smoke: bool, device: torch.device,
                model: Optional[Communicator] = None
                ) -> Dict[Tuple[int, int, int], Tuple[float, float]]:
    """{(seq, micro_bs, depth): (fwd_s, step_s)} of the two depth probes,
    on this process's device (a model rank's share with ``model``)."""
    probes = {L: _loss_fns(arch, L, smoke, device, model)
              for L in _depths(arch, smoke)}
    out = {}
    for seq in seqs:
        for mbs in micro_bss:
            for L, (cfg, fwd, step) in probes.items():
                batch = _batch(cfg, mbs, seq, device)
                t_f, _ = timeit(lambda: fwd(batch), warmup, reps,
                                device=device)
                t_s, _ = timeit(lambda: step(batch), warmup, reps,
                                device=device)
                out[(seq, mbs, L)] = (t_f, t_s)
    return out


def _tp_probe_times(arch: str, seqs, micro_bss, tp: int, warmup: int,
                    reps: int, smoke: bool, device: torch.device):
    """``probe_times`` on ``tp`` local ranks of one stage, its loss
    tensor-parallel: model rank 0's reading.  On the card the ranks take a
    card each over NCCL when there are ``tp`` cards; with fewer, they
    share ``device`` and their all-reduces go through the host."""
    from repro_torch.parallel import rank_programs
    from repro_torch.parallel.launch import run_ranks
    where, backend, transport = "cpu", "gloo", "cpu"
    if device.type == "cuda":
        from repro_torch.kernels import build
        build.build()       # the ranks only load the library
        if torch.cuda.device_count() >= tp:
            where, backend, transport = "cuda", "cpu:gloo,cuda:nccl", "gpu"
        else:
            where = str(device)
    return run_ranks(rank_programs.layer_probes, tp, backend=backend,
                     device=where, timeout_s=TP_PROBE_TIMEOUT_S,
                     args=(arch, list(seqs), list(micro_bss), warmup, reps,
                           smoke, transport))[0]


def bench_layers(store: ProfileStore, dev: str, arch: str,
                 seqs: Sequence[int], micro_bss: Sequence[int], tp: int = 1,
                 warmup: int = 2, reps: int = 5, verbose: bool = True,
                 smoke: bool = True, device: DeviceLike = None):
    """Per-layer fwd/bwd time from two depth probes (a vs 2a).  At
    ``tp`` > 1 the probes are the tensor-parallel loss on ``tp`` ranks
    (the JAX runner's ``--tp``), each rank timing its own share with its
    all-reduces: one layer of a tp-wide stage, what
    ``ProfiledCostModel.layer_time(..., tp)`` prices."""
    device = resolve_device(device)
    if tp > 1:      # the dense stack's; the others name their item
        transformer.check_tp_supported(registry.get_config(arch, smoke=smoke))
    times = (probe_times(arch, seqs, micro_bss, warmup, reps, smoke, device)
             if tp == 1 else
             _tp_probe_times(arch, seqs, micro_bss, tp, warmup, reps, smoke,
                             device))
    a, a2 = _depths(arch, smoke)
    for seq in seqs:
        for mbs in micro_bss:
            for L in (a, a2):
                t_f, t_s = times[(seq, mbs, L)]
                store.put(dev, "loss_probe",
                          {"arch": arch, "seq_len": seq,
                           "micro_bs": mbs, "tp": tp, "n_layers": L},
                          {"fwd_s": t_f, "step_s": t_s})
            (f1, s1), (f2, s2) = times[(seq, mbs, a)], times[(seq, mbs, a2)]
            fwd_layer = max((f2 - f1) / a, 1e-9)
            step_layer = max((s2 - s1) / a, fwd_layer)
            store.put(dev, "layer_step",
                      {"arch": arch, "seq_len": seq, "micro_bs": mbs,
                       "tp": tp},
                      {"fwd_s": fwd_layer, "bwd_s": step_layer - fwd_layer})
            if verbose:
                print(f"  layer  {arch:16s} seq={seq:5d} mbs={mbs} tp={tp} "
                      f"fwd/layer={fwd_layer*1e3:8.3f}ms "
                      f"bwd/layer={(step_layer-fwd_layer)*1e3:8.3f}ms")


# ------------------------------------------------------------ collectives --
def bench_collectives(store: ProfileStore, dev: str,
                      payload_bytes: Sequence[int], warmup: int = 2,
                      reps: int = 5, verbose: bool = True,
                      device: DeviceLike = None):
    """The JAX runner's collective entries, measured over every rank of the
    initialised process group (each rank calls this at once, with its own
    ``device``), on axis ``x`` as the JAX runner's one-axis mesh: for each
    payload, psum, all_gather and a ring ppermute of an fp32 array whose
    shard (one rank's part) is ``nbytes``, timed on every rank and averaged
    over the ranks, with the JAX runner's wire bytes; then ``link`` and
    ``ring_hop`` ``{"scope": "intra"}`` from the largest ppermute.  Every
    rank writes the same entries.  The communicator keeps its default
    transport: CPU tensors take gloo, CUDA tensors NCCL (a rank a card)."""
    from repro_torch.parallel.groups import bind_world_axis
    n = (dist.get_world_size()
         if dist.is_available() and dist.is_initialized() else 1)
    if n < 2:
        if verbose:
            print("  collectives: single device — skipped")
        return
    device = resolve_device(device)
    bind_world_axis("x", device)
    comm = Communicator(axis="x")
    perm = [(i, (i + 1) % n) for i in range(n)]
    cases = {
        "psum": (comm.iallreduce,
                 lambda nb: 2.0 * (n - 1) / n * nb),        # ring wire bytes
        "all_gather": (lambda y: comm.iallgather(y, axis=0),
                       lambda nb: (n - 1) * nb),   # receives n-1 shards
        "ppermute": (lambda y: comm.isend_irecv(y, perm),
                     lambda nb: float(nb)),
    }
    link_gbps = None
    for nbytes in payload_bytes:
        n_f32 = max(nbytes // 4 // n * n, n)
        x = torch.ones((n_f32 // n,), dtype=torch.float32, device=device)
        shard_bytes = x.numel() * x.element_size()
        for name, (fn, wire) in cases.items():
            t, s = timeit(lambda: fn(x), warmup, reps, device=device)
            t, s = (comm.iallreduce(torch.tensor([t, s], dtype=torch.float64,
                                                 device=device)) / n).tolist()
            gbps = wire(shard_bytes) * 8.0 / t / 1e9
            store.put(dev, f"collective_{name}",
                      {"nbytes": shard_bytes, "n_dev": n},
                      {"time_s": t, "std": s, "gbps": gbps})
            if name == "ppermute":
                link_gbps = gbps   # largest payload wins (last iteration)
            if verbose:
                print(f"  coll   {name:12s} shard={shard_bytes/1e6:7.3f}MB "
                      f"n={n} t={t*1e3:8.3f}ms eff={gbps:8.2f}Gb/s")
    if link_gbps is not None:
        # measured intra-island p2p bandwidth -> the predictor's link model
        store.put(dev, "link", {"scope": "intra"}, {"gbps": link_gbps})
        # the context-parallel ring hop IS a collective-permute: the same
        # measurement serves ProfiledCostModel.ring_hop_gbps
        store.put(dev, "ring_hop", {"scope": "intra"}, {"gbps": link_gbps})


# -------------------------------------------------------------------- cli --
def run(arch: str = "llama3-8b", quick: bool = False, out: str = None,
        tp_options: Sequence[int] = (1,), verbose: bool = True,
        device: DeviceLike = None) -> ProfileStore:
    """The JAX runner's sweep on this process's device; the collectives
    run when this process is one of two or more ranks of an initialised
    process group (each rank calls ``run``)."""
    device = resolve_device(device)
    dev = device_kind(device)
    store = (ProfileStore.open(out) if out
             else ProfileStore.for_device(dev))
    if quick:
        seqs, micro_bss, payloads = (64, 128), (1, 2), (1 << 20,)
        warmup, reps = 1, 3
    else:
        seqs, micro_bss = (128, 256, 512), (1, 2, 4)
        payloads = (1 << 20, 8 << 20, 64 << 20)
        warmup, reps = 2, 7
    if verbose:
        print(f"[profile] device_kind={dev} device={device} "
              f"torch={torch.__version__} -> {store.path}")
    bench_kernels(store, dev, seqs, micro_bss, warmup=warmup, reps=reps,
                  verbose=verbose, device=device)
    for tp in tp_options:
        bench_layers(store, dev, arch, seqs, micro_bss, tp=tp,
                     warmup=warmup, reps=reps, verbose=verbose,
                     device=device)
    bench_collectives(store, dev, payloads, warmup=warmup, reps=reps,
                      verbose=verbose, device=device)
    path = store.save()
    if verbose:
        print(f"[profile] {len(store)} entries -> {path}")
    return store


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--quick", action="store_true",
                    help="tiny sweep for CI (seconds, not minutes)")
    ap.add_argument("--out", default=None,
                    help="profile path (default: per-device-kind file under "
                         "chiprun_out/profiles/)")
    ap.add_argument("--tp", type=int, nargs="*", default=[1])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a CUDA device) or "
                         "cpu")
    args = ap.parse_args(argv)
    if args.arch not in registry.ARCH_IDS:
        ap.error(f"unknown --arch {args.arch!r}; "
                 f"choose from {', '.join(registry.ARCH_IDS)}")
    run(arch=args.arch, quick=args.quick, out=args.out,
        tp_options=args.tp, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
