#!/usr/bin/env python3
"""Check and time the port's selective-scan VJP kernel (``ssm_scan_bwd``)
on the card, the quick way before a whole ``chip_smoke.py``.

    PYTHONPATH=src python tools/probe_scan_bwd.py [--reps N] [--sass]

Builds the kernels, prints the backward kernel's registers, spill bytes,
dynamic shared memory and resident blocks per SM for bf16 and fp32 u,
then runs ``chip_smoke.py``'s ``SCAN_BWD_CASES`` (falcon-mamba-7b's
training shape first, then a ragged S, d_state 1, 4 and 16, a partial
block of channels, decays from 1 to underflow) against the plain reverse
loop at the same limits, each run twice (equal bit for bit) beside the
forward with its chunk states (y and the last state bit for bit), and
times the kernel at the first case with CUDA events (the mean of
``--reps`` rounds of 20 calls).  With ``--sass`` it also counts, from
``cuobjdump -sass`` of the built library, the instructions of each loop
of the kernel as the falcon shape launches it (bf16 u, cp.async
staging), by opcode.  Prints one JSON line with the card's name and
power limit; exits 1 on a failed check or without a card.
"""
from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("probe_scan_bwd: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.utils.timing import event_ms

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    build.library()
    attrs = {dt: build.kernel_attrs("ssm_scan_bwd_attrs", code)
             for dt, code in (("bf16", 1), ("fp32", 0))}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    f32 = torch.float32

    def randn(*shape, dtype=f32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    ok, cases, timed = True, [], None
    for label, B, S, di, ds, ud, (scale, add), da_rel in cs.SCAN_BWD_CASES:
        ud = {"bf": torch.bfloat16, "f32": f32}[ud]
        dt = F.softplus(randn(B, S, di) - 1.0) * scale + add
        args_ = (randn(B, S, di, dtype=ud), dt, randn(B, S, ds),
                 randn(B, S, ds), -torch.exp(randn(di, ds) * 0.3))
        dy = randn(B, S, di)
        y0, h0 = ss.ssm_scan(*args_)
        y1, h1, hc = ss.ssm_scan(*args_, keep_chunks=True)
        got = ss.ssm_scan_bwd(*args_, hc, dy)
        again = ss.ssm_scan_bwd(*args_, hc, dy)
        want = ref.ssm_scan_bwd(*args_, dy)
        rels = [cs._rel_err(g, w) for g, w in zip(got, want)]
        limits = [cs.SCAN_BWD_BF16_DU_REL if ud == torch.bfloat16
                  else cs.SCAN_BWD_REL] + [cs.SCAN_BWD_REL] * 3 + [da_rel]
        bits = (torch.equal(y0, y1) and torch.equal(h0, h1)
                and all(torch.equal(a, b) for a, b in zip(got, again)))
        good = bits and all(r <= lim for r, lim in zip(rels, limits))
        ok &= good
        cases.append({"case": label, "ok": good, "bit_for_bit": bits,
                      "rel_err": dict(zip(("du", "ddt", "dB", "dC", "dA"),
                                          rels))})
        if timed is None:
            ms = [event_ms(lambda: ss.ssm_scan_bwd(*args_, hc, dy))
                  for _ in range(args.reps)]
            timed = {"shape": label, "ms": sum(ms) / len(ms), "reps": ms}
        del got, again, want
    out = {"ok": ok, "card": card, "attrs": attrs, "cases": cases,
           "timed": timed}
    if args.sass:
        out["sass_loops"] = sass_loops(build)
    print(json.dumps(out))
    return 0 if ok else 1


def sass_loops(build) -> list:
    """Each loop (a backward branch) of ``ssm_scan_bwd_kernel<bf16,
    true>`` of at least 50 instructions: its length and opcode counts."""
    nvcc = Path(build.find_nvcc())
    dump = subprocess.run([str(nvcc.parent / "cuobjdump"), "-sass",
                           str(build.build())], capture_output=True,
                          text=True, check=True).stdout
    body = next(f for f in re.split(r"\n\s*Function : ", dump)
                if re.match(r"\S*ssm_scan_bwd_kernel\S*bfloat16Lb1E", f))
    lines = re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)
    addr = [int(a, 16) for a, _ in lines]
    ops = [re.sub(r"^@!?U?P\w+\s+", "", i).split()[0].split(".")[0]
           for _, i in lines]
    loops = []
    for end, (_, ins) in enumerate(lines):
        m = re.search(r"\bBRA (0x[0-9a-f]+)", ins)
        if m and int(m.group(1), 16) < addr[end]:
            start = addr.index(int(m.group(1), 16))
            if end - start >= 50:
                loops.append({"instructions": end - start + 1,
                              "by_opcode": dict(collections.Counter(
                                  ops[start:end + 1]).most_common())})
    return loops


if __name__ == "__main__":
    sys.exit(main())
