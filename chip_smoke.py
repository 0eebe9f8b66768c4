#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--report PATH]

Phases, each raising on failure so the script exits non-zero:
  1. card     nvidia-smi name and power limit, torch's device name
  2. build    the Hopper kernels from ``src/repro_torch/kernels/csrc``;
              nvcc -Xptxas -v's lines for the bf16 tensor-core kernels
              (flash forward, ring_step forward and backward) and the
              selective scan, and their registers, spill bytes, dynamic
              shared memory and resident blocks per SM as the card reports
              them, with those of the rmsnorm kernels at the main paths'
              widths (the flash forward and backward at every tile width,
              256 included, the backward's windowed general variant at hd
              120 and 256)
  3. kernels  each kernel against its plain PyTorch version on the card at
              the main paths' shapes (bf16 tol 2e-2, fp32 tol 2e-5, the
              selective scan 2e-4 in y and its last state), timed with CUDA
              events beside the plain version and one library call where
              there is one;
              rmsnorm and swiglu also at a decode step's 8 rows, the scan
              at each prefill length of the trace (S 128, 500, 1000); the
              flash forward also at the reference training route's B1
              S4096, beside SDPA, at head dims 120 and 24 (the tile of
              the next width, windowed, causal, softcapped), and at
              h2o-danube-3-4b's prefill of 6000 (hd 120, window 4096),
              timed beside SDPA with the same boolean band mask; the
              training kernels (ring_step, ring_step_bwd, rmsnorm_bwd,
              swiglu_bwd, the flash backward and its lse) at
              the training shapes: the cp ring's, and B1 S4096 for the
              flash backward; the flash backward also with
              h2o-danube-3-4b's window and head dim (B1 S8192 window 4096
              hd 120, on 8 heads against the plain version, beside SDPA
              with the band mask and a control with an in-band key tile
              left out, then timed at its 32 heads beside SDPA's
              backward with the band mask), at hd 24 windowed, with a
              softcap, and both in fp32; the selective scan's VJP
              (ssm_scan_bwd) at falcon-mamba-7b's training shape (B1
              S4096 di8192 ds16, bf16 u), at a ragged S, d_state 1, 4
              and 16, a partial block of channels and decays from 1 to
              underflow, each gradient by its norm, run twice (bit for
              bit), the forward with its chunk states giving y and the
              last state bit for bit.  recurrentgemma-9b's attention at
              head dim 256 over one KV head, window 2048
              (phase_griffin_kernels): the forward at B1 S3000 and S4096,
              with and without lse, fp32 at S300; the backward at B1
              S4096 on 4 heads; each beside SDPA with the band mask and a
              control with an in-band key tile left out, then timed at 16
              heads; and, timed only, the RG-LRU's plain torch (the scan
              at a prefill and a training step, a rec block's decode step
              at batch 8, a gate product's fp32-upcast and bf16-in,
              fp32-out routes).  whisper-tiny's attention without
              causality at hd 64 (phase_encdec_kernels): the forward at
              Sq < Sk, Sq > Sk and Sq 1 in bf16 and fp32, the backward at
              Sq < Sk and Sq > Sk, then its encoder (B16 S1500), cross
              (Sq 448 against 1500), decode-step cross (Sq 1, B8) and
              cross-backward rows, each held at the shape it is timed at.
              phi-3-vision-4.2b's at hd 96 in the 128 tile, 32 heads over
              32 (phase_vlm_kernels): the forward at its longest prefill
              (S1576) and with lse at S4096, the backward at S4096 against
              the plain version in groups of 4 heads, each held and timed
              at that shape, fp32 at S300.  bf16 attention (the tensor
              cores take P and dS as bf16 operands, P of the ring hop as a
              hi + lo pair; the plain versions keep them in fp32) is also
              held by each output's norm-relative error (REL_TOL), read
              beside SDPA's
              and the controls'
  4. model    llama3-8b, falcon-mamba-7b, qwen3-14b, nemotron-4-15b,
              h2o-danube-3-4b, mixtral-8x7b, phi3.5-moe-42b-a6.6b and
              recurrentgemma-9b (5 layers: a group and a tail),
              whisper-tiny and phi-3-vision-4.2b SMOKE in
              fp32: the kernels on the card
              against the plain versions on the CPU through forward/
              prefill/the cache/decode (danube's and recurrentgemma's
              prompts past their windows)
  5. serve    llama3-8b, falcon-mamba-7b, qwen3-14b, nemotron-4-15b,
              h2o-danube-3-4b, then mixtral-8x7b and phi3.5-moe at 4
              layers, then recurrentgemma-9b at full depth (their TTFT
              and TPOT printed with the card), one
              after another, each at full width and
              depth (bf16, seeded random weights) through
              ServeEngine(max_batch=8) on a 16-request trace: prompts
              {128, 500, 1000} at max_len 2048, danube's {1000, 4500,
              6000} at max_len 8192 (its window of 4096 binds in the
              prefill's flash band and wraps the decode's rolling
              buffer), recurrentgemma-9b's {1000, 2500, 3000} at max_len
              4096 (its window of 2048 the same); every kernel's launch
              count equals its expected
              count for that path (qk_norm's two norms a layer,
              nemotron's MLP without the swiglu kernel), first tokens
              equal decode_sequential's (the new archs' sequential pass
              decodes 4 tokens a request), logits are finite; each path
              reports its own peak memory, its model freed before the
              next is made.  danube also: one request's prefill of 6000
              tokens and 4 decode steps across the wrapped buffer against
              lm_forward of the same tokens, logits within 2e-2 by norm
              in bf16 (recurrentgemma-9b: 5e-2 at its 38 layers, the
              distance logged at 5, 11 and 20) and 1e-4 with the same
              weights in fp32, where a
              control decoding from JAX's front-written layout must miss;
              recurrentgemma-9b the same at a prompt of 3000, its fp32
              check on its first group and its tail (5 layers).
              whisper-tiny (1500 frames, batch 8, 128 greedy tokens,
              max_len 448) and phi-3-vision-4.2b (32 layers, 8 requests
              of 576 image positions) through their bundles, the engine
              refusing both families as JAX's does.
              Then the serve CLI (h2o-danube-3-4b, full width) with
              --plan --metrics-out --prom-out in a child process, its
              artifacts through tools/validate_serve.py
  6. train    llama3-8b SMOKE fp32, 3 Trainer steps on the card against 3 on
              the CPU from one state, on the cp route (chunks 40/31/25), the
              reference route and the pipeline over an interleaved plan
              (vpp 2, virtual stages of 2/1/1/0 of 4 SMOKE layers; losses
              within 1e-4); then llama3-8b at full width and 4 layers (bf16,
              seed 0, seq 4096): 3 steps of the cp route (batch 1, cp 4,
              chunks 1383/1057/884/772), 3 of the reference route (batch 1),
              and 3 of the pipeline route (batch 4) through the planner's
              non-uniform pp 2 plan on the train CLI's two-kind cluster,
              each with finite losses, exact launch counts (every route
              under remat: each block's forward twice), its step times,
              tokens/s and peak memory; the reference cell again with
              every block's activations kept (remat off: its step-0
              loss equal bit for bit, steps 1-2 within 5e-3, the step
              time and peak memory before and after remat); 3
              reference-route steps of
              qwen3-14b (S 4096) and of h2o-danube-3-4b (S 8192, its
              window of 4096 binding in every layer's flash backward),
              each at full width and 4 layers, batch 1 (then
              falcon-mamba-7b at 8 layers, S 4096, on the reference route
              and through a pp 2 plan in one process at batch 2, and
              mixtral-8x7b at 2 layers, and recurrentgemma-9b at 5
              layers, S 4096 (its window binding in every flash
              backward), each step 0 held to the forward loss of its
              weights, mixtral's aux printed), with finite
              losses, exact launch counts (qwen3's qk_norm two more norms
              a block), step times, tokens/s and peak memory, each freed
              before the next; the cp and reference step-0 losses
              agree within 2e-2, and the pipeline's step-0 loss lies within
              2e-2 of the reference loss on its 4 sequences; the ICCL tap
              takes one stage hop a tick.  The pp route closes HETHUB's
              loop: with the CLI's cluster and a fresh store its steps are
              timed with the recorder's tick events, then it steps until
              the store opens the profiled cost source, replans off gpu-a
              slowed 4x (the degraded kind must hold fewer layers, the
              winner predict below the logged baseline) and takes 2 steps
              on the new plan (exact launches, step 0 within 2e-2 of the
              reference loss).  Then pp_ranks: the same plan,
              state seed and batches with its transport replaced by "cpu",
              each stage in its own process on this card
              (parallel/launch.run_ranks, gloo): step-0 loss within 1e-5
              of the pp route's, steps 1-2 within 2e-2, each rank's exact
              launch counts summing to the pp route's, one isend_irecv note
              a hop (2 m a step), each rank's in-flight peak the
              simulator's; the step time, tokens/s, each rank's peak
              memory, and the host-staged hop's time beside the
              cpu_staged transport's price.  Then the checkpoints:
              pp_ranks saves after its timed steps (step 3, each process
              its own elements) into a directory of /dev/shm named after
              this checkout and its TMPDIR (removed at the phase's end,
              on SIGTERM or SIGHUP, and at the next start if a killed run
              left it) and takes a fourth step; the pp route restores
              that checkpoint, its loss within 1e-5 of the fourth, which
              pp_ranks takes after replanning as the pp route did (rank
              0 searches; the store fed by every rank's op events,
              gathered a step) and moving its state in memory, every
              element it received equal to the checkpoint's; the
              reference cell saves at step 2 into the temporary directory
              while step 3 runs, and a new trainer resumes there, its
              restored state and first loss equal bit for bit; every
              save's and restore's times and bytes.  Then tp_ranks: the
              reference cell (batch 1, seed 0, its batches) as a pp 1
              plan whose one stage's 4 layers, embedding and unembedding
              are split over 2 model ranks (tp 2, the Megatron split of
              parallel/sharding.py), the two ranks in two processes on
              this card (run_ranks, gloo, transport "cpu"): every step's
              loss within 2e-2 of the reference route's, each rank's
              launch counts equal to the reference route's, kernel by
              kernel (every norm on each rank, flash and swiglu on its
              own heads and columns), 5 L + 4 iallreduce notes a step
              (5 L + 2 of an activation's 33.55 MB: a block recomputed
              under remat reduces its attention output again) and one
              iallgather;
              each rank's peak memory, the step time, tokens/s, and one
              host-staged all-reduce of an activation's time.  Then
              cp_ranks: llama3-8b at full width and 2 layers, batch 1,
              seq 4096, as a pp 1 plan of a cp 2 ring (chunks
              cp_split(4096, 2) = 2380/1716), each ring rank in its own
              process on this card (run_ranks, gloo, transport "cpu"),
              its K and V hopping over the pod axis, against the
              one-process cp route at the same depth, chunks and seed
              (the witness, run first and freed): step-0 loss within
              1e-5, steps 1-2 within 2e-2, each rank's launches the
              witness's kernel by kernel, L (4 (cp - 1) + 1)
              isend_irecv notes a step on each rank, an iallreduce a
              gradient leaf and the loss's; each rank's peak memory,
              the step time and tokens/s.  Then pp
              vpp: the planner's interleaved plan (vpp 2, pinned by
              planner.search(schedule="interleaved-1f1b", vpp_options=[2])
              on the same cluster) at 8 layers, batch 4, checked as the pp
              route; pp_ranks vpp: that plan's two stages in two
              processes on this card, checked as pp_ranks (step 0 within
              1e-5, the wrap hop included in 2 m (V - 1) isend_irecv
              notes a step, in-flight peaks the interleaved caps); the
              reference route at batch 2 (reference b2); and dp_ranks:
              the reference cell at batch 2 as a pp 1 plan of 2 replicas
              in two processes on this card, one sequence each, ZeRO-1
              over data (transport "cpu"): every step's loss within 2e-2
              of reference b2's, each rank's launches the reference
              route's, an iallreduce a gradient leaf and the loss's and an
              iallgather a split leaf a step, each rank's optimizer bytes
              1/2 of the whole state's over the split leaves; every
              step's gradient norm and each leaf's fp32 master move from
              the initial parameters (the replicas' slices together)
              within 1e-2 of reference b2's, relative, and the replicas'
              parameters equal bit for bit; whisper-tiny (B16, S_enc
              1500, S_dec 448) and phi-3-vision-4.2b (32 layers, S 4096)
              on the reference route, the latter also through a
              one-process pp 2 plan of 4 layers
  6c. control the train CLI's autonomous controller, elastic membership
              and observability on the pp cell (llama3-8b at full width,
              4 layers, batch 2: a plan the controller moves to pp 1 runs
              the reference route, whose batch 4 would not fit beside the
              state), each run a child process on this card: --adapt with
              --degrade gpu-a:4@4 and every obs flag (the controller
              triggers, searches, gates and migrates by itself; the steps
              from the injection to its migrate event), the same steps
              with every obs output off (the step time on against off),
              and --lose gpu-a@3 --join gpu-a@5 with every obs flag (pp 2
              -> pp 1 -> pp 2, each move's bytes and seconds); every run's
              launches equal to the sum over its plans of each plan's
              launches times its steps, its losses held to the first
              run's before that run migrates (step 0 bit for bit, later
              steps on the same plan within 5e-3, pp 1 steps within
              2e-2), its artifacts passing tools/validate_obs.py
              --expect-replan and the membership run
              tools/validate_elastic.py
  6b. plan   the port's planner and profile runner on the card: the cp
              chunks above come from its cp_split; llama3-8b's per-layer
              forward and backward at full width, seq 4096, measured
              through the kernels at depths 1 and 2 (exact launch
              counts), and a quick kernel sweep, into a ProfileStore saved
              under chiprun_out/profiles/; the profiled and the analytic
              predictor's step and peak memory for phase 6's reference
              plan beside the measured ones; the planner's plan for one
              H100 (pp 1, tp 1, dp 1, cp 1); the Eq. 2 MFU of the measured
              step
  7. device   every timed row's device time from a torch.profiler trace,
              and its library call's (every kernel that call runs), and
              the launch floor: the device time of ``zero_()`` on a
              one-element tensor, the shortest kernel PyTorch launches; in
              a child process of this script (``--device-times``), so that
              the profiler never slows the launches of this one.
              rmsnorm_bwd must run as one kernel a call
Then one JSON line with every kernel (launches summed over the serve and
train runs (cp, reference, qwen3-14b, h2o-danube-3-4b, pp, pp_ranks,
tp_ranks, cp_ranks and its witness, pp vpp, pp_ranks vpp, reference b2,
dp_ranks: every rank, and phase 6c's CLI runs) and phase 6b;
rmsnorm and swiglu have a second row at their decode shape,
which takes the launches made inside decode steps, the first row the rest;
the flash forward has a second row at h2o-danube-3-4b's prefill shape,
which takes that serve cell's launches and those of danube's train run,
and ring_step_bwd one at danube's training shape, which takes that
run's launches; at head dim 256 the flash forward has a row at
recurrentgemma-9b's prefill shape (that serve cell's launches) and one
at its training forward with lse (its train run's), ring_step_bwd one
at its training shape (its train run's); at head dim 96
phi-3-vision-4.2b's prefill row (its serve cell's launches), its
training forward with lse and its backward (its reference train run's);
whisper-tiny's non-causal rows (its encoder's, cross and decode-step
cross launches and its cross backward's); the scan's row is its S1000
timing; each row with its library call's device time and the floor), the
card line, and the last line
``{"ok": true, "device": {...}}``.  ``--report PATH`` also writes every
check and timing there as JSON.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import hashlib
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
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
# the device kernels behind the rmsnorm wrapper (a row in registers over a
# block or a warp; the loop kernel past the register template)
RMSNORM_KERNELS = ("rmsnorm_fwd_kernel", "rmsnorm_fwd_warp_kernel",
                   "rmsnorm_loop_kernel")
# rmsnorm's kernels as the main paths launch them: (bwd, D, dtype code)
RMSNORM_ATTRS = {"rmsnorm_fwd_kernel D4096 bf16": (0, 4096, 1),
                 "rmsnorm_fwd_warp_kernel D128 bf16": (0, 128, 1),
                 "rmsnorm_bwd_ring_kernel D4096 bf16": (1, 4096, 1),
                 "rmsnorm_bwd_ring_kernel D100 fp32": (1, 100, 0),
                 "rmsnorm_bwd_general_kernel D100 bf16": (1, 100, 1)}
# a row whose device time is within this many launch floors is at its floor
AT_FLOOR = 1.5
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
FP32_TOL = dict(rtol=2e-5, atol=2e-5)
# bf16 attention on the tensor cores takes P (and, backward, dS) as bf16
# operands, as SDPA does, where the plain versions keep them in fp32.  An
# elementwise 2e-2 is as large as a typical output there, so each output
# tensor is also held by its norm: ||got - want|| / ||want|| <= REL_TOL.
# Every run reads SDPA's error on the same inputs and two controls (the
# plain version with one key tile, or one ring hop, left out) beside it.
REL_TOL = 1e-2
# the selective scan: an fp32 sum over up to S decayed terms, added in
# another order than the plain loop's (tests/test_kernels.py:102-103)
SCAN_TOL = dict(rtol=2e-4, atol=2e-4)
# the scan's VJP, each fp32 gradient by its norm against the plain reverse
# loop (a sum over up to S decayed terms in another order: the card reads
# ~5e-7 at falcon's training shape, ~4e-5 over 4096 steps of decays ~1
# on the H100)
SCAN_BWD_REL = 1e-4
# Where every decay is below e^-50, dA is made of those decays' terms
# alone (g dt a h), and the kernel's ex2.approx decay parts from torch's
# exp by a relative error that grows with |dt A| (the forward's notes in
# csrc/ssm_scan.cu): dA there reads 2.0e-4 on the H100, the other
# gradients ~1e-7.  Such terms are ~1e-22 of a step's and never reach h
SCAN_BWD_UNDERFLOW_DA_REL = 1e-3
# du where u is bf16: both sides round an fp32 sum to bf16, and the two
# sums (in other orders) round apart where they straddle a rounding
# boundary, one bf16 step (2^-8 relative) on those elements: 1.5e-5 and
# 2.1e-5 read on the H100.  An fp32 du held to a bf16 one reads ~1.7e-3
# (the control below), so the limit tells one rounding from a wrong sum
SCAN_BWD_BF16_DU_REL = 2e-4
# its cases: (label, B, S, d_inner, d_state, u dtype name, (dt scale, dt
# offset), dA's limit); the first is falcon-mamba-7b's training shape,
# timed
SCAN_BWD_CASES = (
    ("falcon train B1 S4096 di8192 ds16 u bf16", 1, 4096, 8192, 16, "bf",
     (1.0, 0.0), SCAN_BWD_REL),
    ("B2 S1000 ragged di8192 ds16 u fp32", 2, 1000, 8192, 16, "f32",
     (1.0, 0.0), SCAN_BWD_REL),
    ("B1 S333 di200 ds4 u bf16", 1, 333, 200, 4, "bf", (1.0, 0.0),
     SCAN_BWD_REL),
    ("B1 S257 di96 ds16 u bf16", 1, 257, 96, 16, "bf", (1.0, 0.0),
     SCAN_BWD_REL),
    ("B1 S130 di40 ds1 u fp32", 1, 130, 40, 1, "f32", (1.0, 0.0),
     SCAN_BWD_REL),
    ("B1 S4096 di96 ds16 decays ~1", 1, 4096, 96, 16, "f32", (1e-3, 0.0),
     SCAN_BWD_REL),
    ("B1 S300 di96 ds16 |dt A| >= 50", 1, 300, 96, 16, "f32", (60.0, 200.0),
     SCAN_BWD_UNDERFLOW_DA_REL),
)
# the serve cells: arch -> (prompt lengths, max_len, the tokens a request
# of the decode_sequential pass decodes (None: its whole stream)).  The
# dense family after llama takes llama's trace; h2o-danube-3-4b's longer
# prompts put its window (4096) inside the prefill's flash band and wrap
# its decode's rolling buffer.  Their sequential pass, which checks the
# first tokens, decodes the first 4 tokens of each request, to keep the
# script inside its time.
SERVE_CELLS = {
    "llama3-8b": ((128, 500, 1000), 2048, None),
    "falcon-mamba-7b": ((128, 500, 1000), 2048, None),
    "qwen3-14b": ((128, 500, 1000), 2048, 4),
    "nemotron-4-15b": ((128, 500, 1000), 2048, 4),
    "h2o-danube-3-4b": ((1000, 4500, 6000), 8192, 4),
    "mixtral-8x7b": ((128, 500, 1000), 2048, 4),
    "phi3.5-moe-42b-a6.6b": ((128, 500, 1000), 2048, 4),
    # recurrentgemma-9b at full width and depth: its window (2048) binds
    # in the longer prompts' flash band and wraps the decode's buffer
    "recurrentgemma-9b": ((1000, 2500, 3000), 4096, 4),
}
# the serve cells cut in depth (their weights at full width and depth
# would not fit one card): mixtral-8x7b ~12.1 GB and phi3.5-moe ~10.9 GB
# of bf16 weights at 4 layers
SERVE_LAYERS = {"mixtral-8x7b": 4, "phi3.5-moe-42b-a6.6b": 4}
SERVE_ARCHS = tuple(SERVE_CELLS)
# the SWA check (phase_swa): one request's prefill of a prompt past the
# window and SWA_STEPS decode steps across the wrapped buffer against
# lm_forward of the same tokens, by the logits' norm-relative error: in
# bf16 at full depth (the prefill and the forward take other GEMM shapes,
# the decode plain attention with bf16 weights; the bf16 tolerance), and
# in fp32 (the fp32 model tolerance) with the same weights, or (a number)
# with the first whole groups and the tail of that many layers.  The
# cells it runs in: arch -> (prompt, max_len, fp32 layers or None, the
# bf16 limit).  The bf16 distance between the decode steps and the
# forward grows with depth (the prefill's logits equal the forward's bit
# for bit; M = 1 products round apart from M = S ones in every layer):
# ~1e-2 at 5 recurrentgemma-9b layers to ~4e-2 at its 38, against
# danube's 1.4e-2 at 24 (PERF.md §6), so the hybrid cell's bf16
# limit is 5e-2 and phase_swa logs that distance at its cut depths
# (SWA_DEPTHS) beside it; the fp32 check and its control are the ones
# that see a misplaced key
SWA_PROMPT, SWA_STEPS = 6000, 4
SWA_REL_TOL, SWA_FP32_TOL = 2e-2, 1e-4
SWA_CHECKS = {"h2o-danube-3-4b": (SWA_PROMPT, 8192, None, SWA_REL_TOL),
              "recurrentgemma-9b": (3000, 4096, 5, 5e-2)}
SWA_DEPTHS = (5, 11, 20)
# the serve CLI's --plan --metrics-out --prom-out run on the card, checked
# by tools/validate_serve.py
SERVE_CLI_ARCH = "h2o-danube-3-4b"
# the prompt lengths of the serve trace: each Mamba prefill scans one
SCAN_SEQS = (128, 500, 1000)
# model-level fp32 tolerance: two layers of matmuls summed in other orders
# on the CPU and the card, then a 256-way unembed
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
# phase 4's SMOKE depths other than the config's: recurrentgemma-9b at 5
# layers, one group and a tail of two rec blocks
MODEL_LAYERS = {"recurrentgemma-9b": 5}
# the training slice: llama3-8b at full width, cut to 4 layers (its train
# state, ~16 bytes a parameter, does not fit 80 GB at 32), one sequence of
# 4096 over a cp = 4 ring whose chunks the port's planner splits
# (segmentation.cp_split(4096, 4, attn=1/4096, lin=0.5); main sets them
# once src/ is importable)
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_STEPS = 4, 4096, 3
TRAIN_CP, CP_SPLIT = 4, dict(attn=1 / TRAIN_SEQ, lin=0.5)
CP_CHUNKS: tuple = ()
SMOKE_CP_CHUNKS = (40, 31, 25)
TRAIN_LOSS_TOL = 2e-2   # cp, pp vs reference step-0 loss, bf16
# the rest of the dense family on the reference route at full width and
# TRAIN_LAYERS layers, batch 1: qwen3-14b at TRAIN_SEQ (2.88 B parameters,
# ~46 GB of state and gradients), h2o-danube-3-4b at SWA_TRAIN_SEQ so that
# its window (SWA_WINDOW) binds in every layer's flash backward; the
# windowed backward kernel is also checked and timed there
SWA_TRAIN_SEQ, SWA_WINDOW = 8192, 4096
NEW_TRAIN = (("qwen3-14b", TRAIN_SEQ), ("h2o-danube-3-4b", SWA_TRAIN_SEQ))
# falcon-mamba-7b trains at full width and SSM_TRAIN_LAYERS layers (1.38 B
# parameters, ~22 GB of state), S TRAIN_SEQ, batch 1 on the reference
# route, then SSM_PP_BATCH sequences through a pp 2 plan in one process;
# mixtral-8x7b at MOE_TRAIN_LAYERS layers (3.17 B parameters, ~51 GB of
# state and gradients beside AdamW's fp32 square of the 0.94 B-element
# w_gate leaf; 4 layers would not fit), S TRAIN_SEQ, batch 1.  Step 0 of
# each is held to the forward loss of its weights and batch
SSM_ARCH, SSM_TRAIN_LAYERS, SSM_PP_BATCH = "falcon-mamba-7b", 8, 2
MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS = "mixtral-8x7b", 2
# recurrentgemma-9b trains at full width and GRIFFIN_TRAIN_LAYERS layers
# (one group and a tail of two rec blocks, the 38's structure: 3.09 B
# parameters, 2.10 B of them the two untied 256000 x 4096 tables), S
# TRAIN_SEQ, batch 1 on the reference route, so that its window binds in
# every attention backward; step 0 held to the forward loss
GRIFFIN_ARCH, GRIFFIN_TRAIN_LAYERS = "recurrentgemma-9b", 5
# its attention (phase_griffin_kernels): head dim 256 over one KV head,
# window 2048; the forward at the serve trace's longest prompt and at
# the training length, the backward at the training length, checked
# against the plain version on GRIFFIN_BWD_HEADS of its 16 heads
GRIFFIN_H, GRIFFIN_WINDOW, GRIFFIN_PREFILL = 16, 2048, 3000
GRIFFIN_BWD_HEADS = 4
# whisper-tiny (the enc-dec stack) at its real sizes, full width and
# depth: 1500 frames (Whisper's 30 s window) into the encoder, the
# decoder's context of 448 (its max_len).  Served as the JAX package
# serves it, through the bundle's prefill and decode_step over a batch of
# ED_SERVE_B (the engine refuses the family): a prompt of ED_PROMPT tokens,
# ED_NEW greedy tokens, then each row again at batch 1 for its first
# ED_SEQ_TOKENS tokens; trained on the reference route at ED_TRAIN_B
# sequences of ED_TRAIN_DEC decoder tokens.  Its attention, timed in
# phase_encdec_kernels, is ED_H heads of ED_HD
ED_ARCH, ED_S_ENC, ED_MAX_LEN = "whisper-tiny", 1500, 448
ED_SERVE_B, ED_PROMPT, ED_NEW, ED_SEQ_TOKENS = 8, 4, 128, 8
ED_TRAIN_B, ED_TRAIN_DEC = 16, 448
ED_H, ED_HD = 6, 64
# phi-3-vision-4.2b (the VLM prepend) at full width and VLM_LAYERS layers
# (all 32): VLM_REQS requests of its 576 image positions ahead of text
# prompts of VLM_PROMPTS tokens, generating VLM_GENS, driven through the
# bundle one request at a time (the engine refuses the family) against
# the TTFT / TPOT limits; trained on the reference route at VLM_TRAIN_SEQ
# positions (576 image + 3520 text) at full depth; and through a
# one-process pp 2 plan at VLM_PP_LAYERS layers
VLM_ARCH, VLM_LAYERS = "phi-3-vision-4.2b", 32
VLM_PROMPTS, VLM_GENS, VLM_REQS = (128, 500, 1000), (16, 32), 8
VLM_TRAIN_SEQ = 4096
# its attention (phase_vlm_kernels): the backward's plain version runs in
# groups of VLM_BWD_HEADS of its 32 heads
VLM_BWD_HEADS = 4
VLM_PP_LAYERS, VLM_PP_SEQ, VLM_PP_BATCH = 4, 1024, 2
TTFT_LIMIT_S, TPOT_LIMIT_S = 0.5, 0.05
# phase 4's archs beyond the serve cells'
MODEL_ARCHS = (ED_ARCH, VLM_ARCH)
# the pipeline route: the planner's pp 2 plan on the train CLI's two-kind
# cluster for 4 sequences of TRAIN_SEQ; the SMOKE parity phase also runs
# an interleaved plan (vpp 2, a zero-layer chunk) at 4 SMOKE layers
PP_STAGES, PP_BATCH = 2, 4
SMOKE_VPP_LAYERS = (2, 1, 1, 0)
# the pp_ranks route: the same plan with each stage in its own process on
# the one card, over gloo through pinned host memory.  The forward does the
# pp route's operations in its order and a hop copies bits, so step 0's
# loss agrees to fp32 rounding; later steps differ by the gradient sums'
# order (each microbatch's backward apart, the norm summed over ranks)
RANKS_LOSS0_TOL, RANKS_TIMEOUT_S, HOP_REPS = 1e-5, 300, 20
# the tp_ranks route: the reference cell (batch 1, seeds, batches) as a pp 1
# plan of one stage, its 4 layers, embedding and unembedding split over 2
# model ranks (parallel/sharding.py), the two ranks in two processes on the
# one card, their all-reduces host-staged over gloo.  The bf16 row-parallel
# products round their partial sums apart from the unsharded product's, so
# every step is held at TRAIN_LOSS_TOL of the reference route's
TP_RANKS = 2
# the cp_ranks route: llama3-8b at full width and CP_RANKS_LAYERS layers
# (1.487 B parameters, 20.8 GB of state a process; two processes with
# their gradients ~48 GB beside the chunks' activations, where the 4-layer
# cell's 27 GB a process would leave too little), one sequence of
# TRAIN_SEQ over a ring of CP_RANKS ranks whose chunks cp_split gives
# (main sets CP_RANKS_CHUNKS), each ring rank in its own process.  Its
# forward runs the witness's kernels on the same rows and its hops copy
# bits, so step 0's loss agrees to fp32 rounding (RANKS_LOSS0_TOL); later
# steps differ by the ring backward's dq atomics (TRAIN_LOSS_TOL)
CP_RANKS, CP_RANKS_LAYERS = 2, 2
CP_RANKS_CHUNKS: tuple = ()
# the pp vpp route: the planner's interleaved plan (vpp 2) for PP_BATCH
# sequences at VPP_LAYERS layers (2.795 B parameters, 39.1 GB of state),
# then (pp_ranks vpp) its two stages in two processes on the card
VPP_LAYERS = 8
# the dp_ranks route: the reference cell at DP_RANKS sequences as a pp 1
# plan of DP_RANKS replicas (one sequence each, ZeRO-1 over data) in as
# many processes on the card, against the reference route at that batch.
# At AdamW's warmup rate the losses barely move in 3 steps, so each step's
# gradient norm and each leaf's master move (a replica that left its slice
# unchanged would read ~0.71 of it) are held, relative, at DP_NORM_TOL
DP_RANKS = 2
DP_NORM_TOL = 1e-2
# the checkpoint phase: pp_ranks' two processes write one checkpoint after
# their TRAIN_STEPS timed steps (so that none of those overlaps a save)
# and take one more, which the pp route, restoring the checkpoint, repeats;
# the reference cell saves every CKPT_EVERY steps (the step-2 save written
# while step 3 runs) and a new trainer resumes from it.  A checkpoint of
# the 4-layer state takes 27.0 GB.  A GPU host's scratch disk may cap a
# run's writes (45 GiB on the H100 host measured, freed blocks counted), so
# only the reference cell's goes to the disk (the temporary directory) and
# pp_ranks' to /dev/shm, in host memory beside the ranks' snapshots, in a
# directory named after this checkout and its temporary directory
CKPT_EVERY, CKPT_BYTES = 2, 27.0e9
# the closed loop: the pp cell's trainer, then pp_ranks, replan off
# REPLAN_KIND slowed REPLAN_FACTOR times (the analytic search gives the
# degraded kind's stage 1 of the 4 layers, not 3) and take REPLAN_STEPS
# steps (pp_ranks: its fourth) on the new plan
REPLAN_KIND, REPLAN_FACTOR, REPLAN_STEPS = "gpu-a", 4.0, 2


def log(msg: str) -> None:
    print(msg, flush=True)


def peaks(name: str):
    for marker, vals in PEAKS.items():
        if marker in name:
            return vals
    raise RuntimeError(f"no published peaks for {name!r}")


def _rel_err(got, want) -> float:
    """||got - want|| / ||want||, the largest over a tuple of tensors."""
    if isinstance(got, (tuple, list)):
        return max(_rel_err(g, w) for g, w in zip(got, want))
    g, w = got.double(), want.double()
    return ((g - w).norm() / w.norm().clamp_min(1e-30)).item()


def _reading(readings, kernel, case, what, got, want):
    """Log and keep one norm-relative reading: the kernel's, SDPA's, or a
    control's (a control must read above REL_TOL, or the check it sits
    beside could not fail a wrong kernel)."""
    r = _rel_err(got, want)
    readings.append({"kernel": kernel, "case": case, "what": what,
                     "rel_err": r})
    log(f"[kernels] {kernel:15s} {case:42s} rel_err {what:30s} {r:.3e}")
    if what.startswith("control"):
        assert r > REL_TOL, (kernel, case, what, r)
    return r


def _without_key_tile(torch, ref, q, k, v, lo: int, hi: int):
    """The plain fold of one rank (a leading rank axis of 1) over keys
    [0, lo) and [hi, S): the causal forward with key tile [lo, hi) left
    out, as o."""
    R, B, S, H, hd = q.shape
    empty = (torch.full((R, B, S, H, 1), ref.NEG_INF, device=q.device),
             torch.zeros((R, B, S, H, 1), device=q.device),
             torch.zeros((R, B, S, H, hd), device=q.device))
    _, l, acc = _hop_without_key_tile(ref, q, k, v, empty,
                                      [(0, 0, 0, S, S)], lo, hi)
    return (acc / l).to(q.dtype)


def _hop_without_key_tile(ref, q, k, v, carry, hops, lo: int, hi: int):
    """The plain fold of one ring step with keys [lo, hi) of every
    visiting block left out."""
    for a, b in ((0, lo), (hi, k.shape[2])):
        sub = [(qs, src, ks + a, max(0, min(kv, b) - a), qv)
               for qs, src, ks, kv, qv in hops]
        carry = ref.ring_step(q, k[:, :, a:b], v[:, :, a:b], *carry, sub)
    return carry


def _bwd_without_key_tile(torch, ref, q, k, v, do, lse, delta, lo: int,
                          hi: int, window=None):
    """The plain backward of one rank with key tile [lo, hi) left out:
    (dq, dk, dv), fp32, 0 in dk and dv on that tile."""
    S = q.shape[2]
    dq, dk, dv = (torch.zeros(t.shape, device=q.device) for t in (q, k, k))
    for a, b in ((0, lo), (hi, S)):
        ref.ring_step_bwd(q, k[:, :, a:b], v[:, :, a:b], do, lse, delta, dq,
                          dk[:, :, a:b], dv[:, :, a:b], [(0, 0, a, b - a, S)],
                          window=window)
    return dq, dk, dv


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
# the bf16 tensor-core kernels (by head dim) and the selective scan (by
# u's dtype code): the C function reporting their attributes
TC_KERNELS = {"flash_fwd_mma_kernel": "flash_attention_fwd_attrs",
              "ring_fwd_mma_kernel": "ring_step_fwd_attrs",
              "ring_bwd_mma_kernel": "ring_step_bwd_attrs"}
SCAN_KERNEL = ("ssm_scan_kernel", "ssm_scan_attrs")
SCAN_BWD_KERNEL = ("ssm_scan_bwd_kernel", "ssm_scan_bwd_attrs")


def phase_build():
    """Build; log ptxas' lines for the tensor-core kernels and the scan,
    and each one's registers, spill bytes, dynamic shared memory and
    resident blocks per SM (at every head dim; the scan for bf16 and fp32
    u), from the card."""
    from repro_torch.kernels import build
    from repro_torch.kernels import ring_attention as ra
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    t0 = time.perf_counter()
    build.library()
    secs = time.perf_counter() - t0
    log(f"[build] {secs:.2f} s (nvcc {build.find_nvcc()})")
    show = False
    for line in build.ptxas_log.splitlines():
        if "Compiling entry function" in line:
            show = any(k in line for k in (*TC_KERNELS, SCAN_KERNEL[0],
                                           SCAN_BWD_KERNEL[0]))
        if show and ("entry function" in line or "Used" in line
                     or "spill" in line):
            log(f"[build]   {line.strip()}")
    # every tile width of the flash forward and backward (256 included),
    # the ring forward's; the backward's attributes at (hd, windowed)
    variants = [(kernel, fn, (hd, 0) if "bwd" in kernel else (hd,),
                 f"hd{hd}", "(bf16, as launched)")
                for kernel, fn in TC_KERNELS.items()
                for hd in (ra.HEAD_DIMS if "ring_fwd" in kernel
                           else HEAD_DIMS)]
    # the backward's general variant (a window, a head dim narrower than
    # its tile) at h2o-danube-3-4b's hd 120 and recurrentgemma-9b's 256
    variants.append(("ring_bwd_mma_kernel", "ring_step_bwd_attrs", (120, 1),
                     "hd120", "(bf16, the windowed general variant)"))
    variants.append(("ring_bwd_mma_kernel", "ring_step_bwd_attrs", (256, 1),
                     "hd256 windowed", "(bf16, the windowed general "
                     "variant recurrentgemma-9b trains with)"))
    variants += [(*SCAN_KERNEL, (code,), f"u {dt}",
                  "(as the prefill launches it)")
                 for dt, code in (("bf16", 1), ("fp32", 0))]
    variants += [(*SCAN_BWD_KERNEL, (code,), f"u {dt}", "(as launched)")
                 for dt, code in (("bf16", 1), ("fp32", 0))]
    for key, args in RMSNORM_ATTRS.items():
        kernel, case = key.split(" ", 1)
        variants.append((kernel, "rmsnorm_attrs", args, case,
                         "(as launched)"))
    attrs = {}
    for kernel, fn, args, key, how in variants:
        a = build.kernel_attrs(fn, *args)
        attrs[f"{kernel} {key}"] = a
        log(f"[build]   {kernel} {key} {how}: "
            f"{a['registers']} registers, {a['spill_bytes']} B local, "
            f"{a['smem_bytes']} B dynamic shared, "
            f"{a['blocks_per_sm']} blocks/SM")
    return secs, {"attrs": attrs}


# ------------------------------------------------------------- phase 3 ---
def phase_kernels(torch, dev, name, device_only=False):
    """The serving path's kernels on the card against their plain
    versions, then timed with CUDA events; with ``device_only`` (phase 7's
    child process) the same checks, then each row's profiler device time
    alone."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.kernels import swiglu as sg
    from repro_torch.utils.timing import device_ms, event_ms

    bw, bf16_peak, fp32_peak = peaks(name)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    checks = []

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def compare(kernel, label, got, want, tol, rel=False):
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), **tol)
        checks.append({"kernel": kernel, "case": label, "max_abs_err": err})
        msg = ""
        if rel:
            r = checks[-1]["rel_err"] = _rel_err(got, want)
            msg = f", rel_err {r:.3e} (limit {REL_TOL})"
            assert r <= REL_TOL, (kernel, label, r)
        log(f"[kernels] {kernel:15s} {label:42s} max_abs_err {err:.3e}"
            f"{msg} ok")
        return err

    bf, f32 = torch.bfloat16, torch.float32
    tol = {bf: BF16_TOL, f32: FP32_TOL}
    readings = []

    # rmsnorm: decode (8 rows) and prefill (1000 rows) at D=4096; D=128 is
    # the one-warp-per-row path (qk_norm width), D=20480 the loop kernel
    for rows, D in ((8, 4096), (1000, 4096), (256, 128), (3, 20480)):
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
        # head dims between the tile widths: h2o-danube-3-4b's 120 and
        # nemotron-4-15b SMOKE's 24, windowed, causal, softcapped
        ("S1000 hd120 window256", 1, 1000, 1000, 32, 8, 120,
         {"window": 256}, (bf, f32)),
        ("S300 hd120 softcap30", 1, 300, 300, 8, 2, 120, {"softcap": 30.0},
         (bf,)),
        ("Sq100<Sk700 hd24 window64", 2, 100, 700, 4, 2, 24,
         {"window": 64}, (bf, f32)),
        ("S257 hd24 softcap20 window40", 1, 257, 257, 4, 2, 24,
         {"softcap": 20.0, "window": 40}, (bf,)),
    ]
    for label, B, Sq, Sk, H, Hk, hd, kw, dts in fl_cases:
        for dt in dts:
            q = randn(B, Sq, H, hd, dtype=dt)
            k, v = randn(B, Sk, Hk, hd, dtype=dt), randn(B, Sk, Hk, hd,
                                                         dtype=dt)
            got = fa.flash_attention(q, k, v, causal=True, **kw)
            want = ref.flash_attention(q, k, v, causal=True, **kw)
            compare("flash_attention", f"{label} {dt}", got, want, tol[dt],
                    rel=dt == bf)
            if "masked" in label:
                assert got[:, :Sq - Sk].abs().max().item() == 0.0
    # the reference training route's forward: B1 S4096, checked, then
    # timed beside SDPA (a row of its own; the kernel line keeps S1000).
    # Beside the kernel's error: SDPA's, and that of the plain version with
    # key tile 32 (keys 2048-2111) left out of every row that sees it
    S, H, Hk, hd = TRAIN_SEQ, 32, 8, 128
    q = randn(1, S, H, hd, dtype=bf)
    k, v = randn(1, S, Hk, hd, dtype=bf), randn(1, S, Hk, hd, dtype=bf)
    case = f"B1 S{S} H32 Hk8 hd128 causal {bf}"
    want = ref.flash_attention(q, k, v)
    err = compare("flash_attention", case, fa.flash_attention(q, k, v),
                  want, BF16_TOL, rel=True)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    _reading(readings, "flash_attention", case, "SDPA",
             F.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2),
             want)
    _reading(readings, "flash_attention", case, "control: key tile 32 out",
             _without_key_tile(torch, ref, q[None], k[None], v[None], 2048,
                               2112)[0], want)
    del want
    pairs = S * (S + 1) // 2
    bytes_ms = (2 * S * H * hd + 2 * S * Hk * hd) * 2 / bw * 1e3
    ops_ms = 4 * pairs * hd * H / bf16_peak * 1e3
    if device_only:
        fwd4096 = {"device_ms": device_ms(lambda: fa.flash_attention(q, k, v),
                                          ("flash_fwd",)),
                   "library_device_ms": device_ms(
                       lambda: F.scaled_dot_product_attention(
                           qt, kt, vt, is_causal=True, enable_gqa=True))}
    else:
        fwd4096 = {
            "shape": f"B1 S{S} H32 Hk8 hd128 causal bf16",
            "max_abs_err": err,
            "ms": event_ms(lambda: fa.flash_attention(q, k, v)),
            "plain_ms": event_ms(lambda: ref.flash_attention(q, k, v),
                                 iters=3, warmup=1),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": event_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))}
        log(f"[kernels] time flash_attention  {fwd4096['shape']}: kernel "
            f"{fwd4096['ms']:.4f} ms, plain {fwd4096['plain_ms']:.4f} ms, "
            f"library {fwd4096['library_ms']:.4f} ms, bound "
            f"{fwd4096['bound_ms']:.4f} ms ({fwd4096['bound_by']})")
    del q, k, v, qt, kt, vt

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
    scans = {S_: scan_inputs(1, S_, di, ds, bf) for S_ in SCAN_SEQS}
    # h2o-danube-3-4b's prefill of its longest prompt: hd 120, window 4096
    Sw_, W_ = SWA_PROMPT, 4096
    qw = randn(1, Sw_, 32, 120, dtype=bf)
    kw_, vw = randn(1, Sw_, 8, 120, dtype=bf), randn(1, Sw_, 8, 120,
                                                    dtype=bf)
    qwt, kwt, vwt = (t.transpose(1, 2) for t in (qw, kw_, vw))
    band = ref.attention_mask(Sw_, Sw_, causal=True, window=W_, device=dev)
    band_pairs = sum(min(i + 1, W_) for i in range(Sw_))
    if not device_only:
        case = f"B1 S{Sw_} H32 Hk8 hd120 window{W_} {bf}"
        want = ref.flash_attention(qw, kw_, vw, window=W_)
        compare("flash_attention", case,
                fa.flash_attention(qw, kw_, vw, window=W_), want, BF16_TOL,
                rel=True)
        _reading(readings, "flash_attention", case, "SDPA, band mask",
                 F.scaled_dot_product_attention(
                     qwt, kwt, vwt, attn_mask=band,
                     enable_gqa=True).transpose(1, 2), want)
        del want
    xd = randn(8, 4096, dtype=bf)     # a decode step's rows
    gd, ud = randn(8, 14336, dtype=bf), randn(8, 14336, dtype=bf)

    def scan_cost(S_):
        """Bytes and operations of one scan of S_ steps: u (bf16), dt and
        y (fp32) per (t, d); B, C per (t, n); A and the last state per
        (d, n); 6 fp32 FLOP per (t, d, n) state update (dt*A, decay*h,
        du*B, the add, h*C, the sum) and one exp on the special-function
        units."""
        states = S_ * di * ds
        return (S_ * di * (el + 4 + 4) + 2 * S_ * ds * 4 + 2 * di * ds * 4,
                [(6 * states + S_ * di, fp32_peak),
                 (states, fp32_peak * SFU_PER_FP32_FLOP)])

    rows = {
        "rmsnorm": dict(
            source="src/repro_torch/kernels/csrc/rmsnorm.cu",
            replaces="src/repro/kernels/rmsnorm.py:19",
            shape="x (1000, 4096) bf16",
            fn=lambda: rn.rmsnorm(x, s, 1e-5),
            plain=lambda: ref.rmsnorm(x, s, 1e-5),
            library=lambda: F.rms_norm(x, (4096,), s, 1e-5),
            kernels=RMSNORM_KERNELS,
            bytes=2 * 1000 * 4096 * el + 4096 * el,
            ops=[(4 * 1000 * 4096, fp32_peak)]),
        # the same kernel at a decode step's 8 rows, where most of its
        # launches run
        "rmsnorm decode": dict(
            name="rmsnorm",
            source="src/repro_torch/kernels/csrc/rmsnorm.cu",
            replaces="src/repro/kernels/rmsnorm.py:19",
            shape="x (8, 4096) bf16",
            fn=lambda: rn.rmsnorm(xd, s, 1e-5),
            plain=lambda: ref.rmsnorm(xd, s, 1e-5),
            library=lambda: F.rms_norm(xd, (4096,), s, 1e-5),
            kernels=RMSNORM_KERNELS,
            bytes=2 * 8 * 4096 * el + 4096 * el,
            ops=[(4 * 8 * 4096, fp32_peak)]),
        "swiglu": dict(
            source="src/repro_torch/kernels/csrc/swiglu.cu",
            replaces="src/repro/kernels/swiglu.py:16",
            shape="g, u (1000, 14336) bf16 -> bf16",
            fn=lambda: sg.swiglu(g, u, bf),
            plain=lambda: ref.swiglu(g, u, bf),
            library=None, kernels=("swiglu_kernel",),
            bytes=3 * 1000 * 14336 * el,
            ops=[(8 * 1000 * 14336, fp32_peak)]),
        # the same at a decode step's 8 rows (32 launches a llama step)
        "swiglu decode": dict(
            name="swiglu",
            source="src/repro_torch/kernels/csrc/swiglu.cu",
            replaces="src/repro/kernels/swiglu.py:16",
            shape="g, u (8, 14336) bf16 -> bf16",
            fn=lambda: sg.swiglu(gd, ud, bf),
            plain=lambda: ref.swiglu(gd, ud, bf),
            library=None, kernels=("swiglu_kernel",),
            bytes=3 * 8 * 14336 * el,
            ops=[(8 * 8 * 14336, fp32_peak)]),
        "flash_attention": dict(
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:91",
            shape="B1 S1000 H32 Hk8 hd128 causal bf16",
            fn=lambda: fa.flash_attention(q, k, v, causal=True),
            plain=lambda: ref.flash_attention(q, k, v, causal=True),
            library=lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True),
            kernels=("flash_fwd",),
            bytes=(2 * S * H * hd + 2 * S * Hk * hd) * el,
            ops=[(4 * pairs * hd * H, bf16_peak)]),
        # the same kernel at h2o-danube-3-4b's longest prefill (hd 120 in
        # the 128 tile); its bound counts the window band's pairs at the
        # real hd; the library call is SDPA with the same boolean band
        "flash_attention hd120": dict(
            name="flash_attention",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:91",
            shape=f"B1 S{Sw_} H32 Hk8 hd120 window{W_} causal bf16",
            fn=lambda: fa.flash_attention(qw, kw_, vw, window=W_),
            plain=lambda: ref.flash_attention(qw, kw_, vw, window=W_),
            plain_iters=3,
            library=lambda: F.scaled_dot_product_attention(
                qwt, kwt, vwt, attn_mask=band, enable_gqa=True),
            kernels=("flash_fwd",),
            bytes=(2 * Sw_ * 32 * 120 + 2 * Sw_ * 8 * 120) * el,
            ops=[(4 * band_pairs * 120 * 32, bf16_peak)]),
    }
    # the scan at each prefill length of the serve trace; the longest is
    # the kernel's row
    for S_ in SCAN_SEQS:
        nbytes, ops = scan_cost(S_)
        rows[f"ssm_scan S{S_}"] = dict(
            name="ssm_scan",
            source="src/repro_torch/kernels/csrc/ssm_scan.cu",
            replaces="src/repro/kernels/ssm_scan.py:46",
            shape=f"B1 S{S_} di8192 ds16, u bf16, dt/B/C/A fp32",
            fn=lambda a=scans[S_]: ss.ssm_scan(*a),
            plain=lambda a=scans[S_]: ref.ssm_scan(*a),
            library=None, kernels=("ssm_scan_kernel",), bytes=nbytes,
            ops=ops, line=S_ == max(SCAN_SEQS))
    timed = {}
    for kname, r in rows.items():
        if device_only:
            timed[kname] = _device_row(device_ms, r)
            continue
        bytes_ms = r["bytes"] / bw * 1e3
        ops_ms = max(n / peak for n, peak in r["ops"]) * 1e3
        err = _max_err(r["fn"](), r["plain"]())
        timed[kname] = {
            "name": r.get("name", kname), "line": r.get("line", True),
            "route": "cuda", "source": r["source"],
            "replaces": r["replaces"], "shape": r["shape"],
            "max_abs_err": err,
            "ms": event_ms(r["fn"]),
            "plain_ms": (event_ms(r["plain"], iters=r["plain_iters"],
                                  warmup=1) if "plain_iters" in r
                         else event_ms(r["plain"])),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": (event_ms(r["library"])
                           if r["library"] else None),
        }
        t = timed[kname]
        log(f"[kernels] time {kname:15s} {r['shape']}: kernel {t['ms']:.4f} "
            f"ms, plain {t['plain_ms']:.4f} ms, library {t['library_ms']} "
            f"ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    return checks, timed, {"flash_attention_S4096": fwd4096,
                           "rel_readings": readings}


def _visible_pairs(chunks, step: int):
    """Per rank, the (query, key) pairs ring step ``step`` shows, real rows
    only (numpy; what this run's data needs of a hop)."""
    import numpy as np
    starts = np.concatenate([[0], np.cumsum(chunks)[:-1]])
    cp, out = len(chunks), []
    for r in range(cp):
        src = (r - step) % cp
        qpos = starts[r] + np.arange(chunks[r])
        kpos = starts[src] + np.arange(chunks[src])
        # keys at or before each query's position
        out.append(int(np.searchsorted(kpos, qpos, side="right").sum()))
    return out


def phase_train_kernels(torch, dev, name, device_only=False):
    """The training path's kernels on the card against their plain
    versions, at the cp training shapes, then timed (``device_only``: as
    in phase_kernels)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ring_attention as ra
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import swiglu as sg
    from repro_torch.utils.timing import device_ms, device_profile, event_ms

    bw, bf16_peak, fp32_peak = peaks(name)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    checks = []
    bf, f32 = torch.bfloat16, torch.float32
    tol = {bf: BF16_TOL, f32: FP32_TOL}

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    readings = []

    def compare(kernel, label, got, want, tol_, rel=False):
        err = _max_err(got, want)
        for g, w in zip(got, want):
            torch.testing.assert_close(g.float(), w.float(), **tol_)
        checks.append({"kernel": kernel, "case": label, "max_abs_err": err})
        msg = ""
        if rel:   # each tensor's own norm-relative error, the largest
            r = checks[-1]["rel_err"] = _rel_err(got, want)
            msg = f", rel_err {r:.3e} (limit {REL_TOL})"
            assert r <= REL_TOL, (kernel, label, r)
        log(f"[kernels] {kernel:15s} {label:42s} max_abs_err {err:.3e}"
            f"{msg} ok")
        return err

    def empty_carry(R, B, C, H, hd):
        return (torch.full((R, B, C, H, 1), ref.NEG_INF, device=dev),
                torch.zeros((R, B, C, H, 1), device=dev),
                torch.zeros((R, B, C, H, hd), device=dev))

    def lse_of(l, m):
        return torch.where(l > 0, m + torch.log(l), torch.inf)[..., 0]

    # ring_step, every step of a cp = 4 ring at the slice's shape (bf16),
    # the kernel and the plain fold from the same carry at each step
    cp, C, B, H, Hk, hd = len(CP_CHUNKS), max(CP_CHUNKS), 1, 32, 8, 128
    q = randn(cp, B, C, H, hd, dtype=bf)
    k, v = randn(cp, B, C, Hk, hd, dtype=bf), randn(cp, B, C, Hk, hd,
                                                    dtype=bf)
    # (the tensor cores take P as a bf16 hi + lo pair: BF16_TOL and
    # REL_TOL on each of m, l and acc), beside a control: the plain fold of
    # the diagonal step with key tile 1 (keys 64-127) left out
    carry = empty_carry(cp, B, C, H, hd)
    for step in range(cp):
        hops = ra.ring_hops(CP_CHUNKS, step)
        got = ra.ring_step(q, k, v, *carry, hops)
        want = ref.ring_step(q, k, v, *carry, hops)
        case = f"cp4 {CP_CHUNKS} step {step} bf16"
        compare("ring_step", case, got, want, BF16_TOL, rel=True)
        if step == 0:
            _reading(readings, "ring_step", case, "control: key tile 1 out",
                     _hop_without_key_tile(ref, q, k, v, carry, hops, 64,
                                           128), want)
        carry = want
    m_fin, l_fin, acc_fin = carry
    # one hop in fp32: a ragged partial block over a warm carry, then a
    # fully masked wrap hop, which must leave the carry as it was
    qs, ks, vs = (randn(1, 2, 200, 8, 64, dtype=f32),
                  randn(1, 2, 200, 2, 64, dtype=f32),
                  randn(1, 2, 200, 2, 64, dtype=f32))
    warm = ref.ring_step(qs, ks, vs, *empty_carry(1, 2, 200, 8, 64),
                         [(300, 0, 300, 200, 200)])
    hop = [(300, 0, 130, 77, 200)]
    compare("ring_step", "one hop B2 C200 H8 Hk2 hd64 k_valid77 fp32",
            ra.ring_step(qs, ks, vs, *warm, hop),
            ref.ring_step(qs, ks, vs, *warm, hop), FP32_TOL)
    masked = ra.ring_step(qs, ks, vs, *warm, [(300, 0, 500, 200, 200)])
    compare("ring_step", "fully masked hop keeps the carry fp32", masked,
            warm, dict(rtol=1e-6, atol=1e-6))

    # ring_step_bwd: the ring's backward at the slice's shape, all cp hops
    # accumulated, from the final carry's logsumexp; o and lse as
    # kernels/ops.py makes them (the pad rows see no key: 0 and +inf), and
    # dout 0 on the pad rows, as unpad_chunks' gradient gives
    o = (acc_fin / l_fin.clamp_min(1e-30)).to(bf)
    lse = lse_of(l_fin, m_fin).contiguous()
    do = randn(cp, B, C, H, hd, dtype=bf)
    for r, c in enumerate(CP_CHUNKS):
        do[r, :, c:] = 0
    delta = (do.float() * o.float()).sum(-1)

    def zeros_like_qkv():
        return (torch.zeros(q.shape, device=dev),
                torch.zeros(k.shape, device=dev),
                torch.zeros(k.shape, device=dev))

    got, want = zeros_like_qkv(), zeros_like_qkv()
    for step in range(cp):
        hops = ra.ring_hops(CP_CHUNKS, step)
        ra.ring_step_bwd(q, k, v, do, lse, delta, *got, hops)
        ref.ring_step_bwd(q, k, v, do, lse, delta, *want, hops)
    # the tensor-core kernel takes P and dS as bf16 operands (as SDPA does)
    # where the plain version keeps them in fp32: the bf16 tolerance and
    # REL_TOL; the mean magnitudes, and the plain ring with hop 1 left out
    # as the control, say what they are set against
    mags = ", ".join(f"{n} {w.abs().mean().item():.3e}"
                     for n, w in zip(("dq", "dk", "dv"), want))
    log(f"[kernels] ring_step_bwd cp4 mean |grad|: {mags}")
    case = f"cp4 {CP_CHUNKS} 4 hops bf16 (dq,dk,dv)"
    compare("ring_step_bwd", case, got, want, BF16_TOL, rel=True)
    ctl = zeros_like_qkv()
    for step in (0, 2, 3):
        ref.ring_step_bwd(q, k, v, do, lse, delta, *ctl,
                          ra.ring_hops(CP_CHUNKS, step))
    _reading(readings, "ring_step_bwd", case, "control: hop 1 out", ctl,
             want)
    del ctl
    # one hop in fp32 (dq summed by atomics: fp32 order only)
    os_ = (warm[2] / warm[1]).contiguous()
    lse_s = lse_of(warm[1], warm[0]).contiguous()
    dos = randn(1, 2, 200, 8, 64, dtype=f32)
    dls = (dos * os_).sum(-1)
    g1 = (torch.zeros_like(qs), torch.zeros_like(ks), torch.zeros_like(ks))
    w1 = (torch.zeros_like(qs), torch.zeros_like(ks), torch.zeros_like(ks))
    hop = [(300, 0, 130, 200, 200)]
    ra.ring_step_bwd(qs, ks, vs, dos, lse_s, dls, *g1, hop)
    ref.ring_step_bwd(qs, ks, vs, dos, lse_s, dls, *w1, hop)
    compare("ring_step_bwd", "one hop B2 C200 H8 Hk2 hd64 fp32 (dq,dk,dv)",
            g1, w1, FP32_TOL)

    # the flash backward (FlashAttentionFn: flash forward with lse, then
    # the one-rank ring_step_bwd) against autograd through the plain
    # flash, and the lse against the plain one: at the reference route's
    # shape (B1 S4096, bf16; these inputs are also the ones timed below)
    # and on a small fp32 case
    S = TRAIN_SEQ
    flash_in = {}
    for label, S_, dt in ((f"B1 S{S} H32 Hk8 hd128", S, bf),
                          ("B1 S300 H8 Hk2 hd64", 300, f32)):
        Hq, Hkv, d_ = (32, 8, 128) if S_ == S else (8, 2, 64)
        qf = randn(1, S_, Hq, d_, dtype=dt).requires_grad_()
        kf = randn(1, S_, Hkv, d_, dtype=dt).requires_grad_()
        vf = randn(1, S_, Hkv, d_, dtype=dt).requires_grad_()
        dof = randn(1, S_, Hq, d_, dtype=dt)
        got = torch.autograd.grad(ops.flash_attention(qf, kf, vf), (qf, kf, vf),
                                  dof)
        want = torch.autograd.grad(ref.flash_attention(qf, kf, vf),
                                   (qf, kf, vf), dof)
        case = f"flash backward {label} {dt}"
        err = compare("ring_step_bwd", case, got, want, tol[dt],
                      rel=dt == bf)
        del got
        with torch.no_grad():
            of, lse_k = fa.flash_attention(qf, kf, vf, return_lse=True)
            o_r, lse_r = ref.flash_attention(qf, kf, vf, return_lse=True)
        if S_ == S:
            # beside it: SDPA's backward, and the plain backward with key
            # tile 32 left out (from the plain lse and delta)
            ts = [t.transpose(1, 2).detach().requires_grad_()
                  for t in (qf, kf, vf)]
            sd = torch.autograd.grad(F.scaled_dot_product_attention(
                *ts, is_causal=True, enable_gqa=True), ts,
                dof.transpose(1, 2))
            _reading(readings, "ring_step_bwd", case, "SDPA",
                     tuple(t.transpose(1, 2) for t in sd), want)
            del ts, sd
            dl_r = (dof.float() * o_r.float()).sum(-1)
            _reading(readings, "ring_step_bwd", case,
                     "control: key tile 32 out",
                     _bwd_without_key_tile(
                         torch, ref, *(t.detach()[None] for t in (qf, kf, vf)),
                         dof[None], lse_r[None], dl_r[None], 2048, 2112),
                     tuple(w[None] for w in want))
            del dl_r
        del want, o_r
        compare("flash_attention", f"lse {label} {dt}", (lse_k,), (lse_r,),
                FP32_TOL)
        if S_ == S:
            flash_in = dict(q=qf.detach(), k=kf.detach(), v=vf.detach(),
                            do=dof, o=of, lse=lse_k, err=err)

    # the tp_ranks route's shapes: each of its TP_RANKS model ranks runs
    # the flash forward and backward on its 16 q and 4 kv heads, and swiglu
    # forward and backward on its 7168 columns of d_ff (its norms are the
    # reference route's)
    Ht, Hkt, Ft = 32 // TP_RANKS, 8 // TP_RANKS, 14336 // TP_RANKS
    tp_label = f"B1 S{S} H{Ht} Hk{Hkt} hd128 (tp_ranks)"
    qt_, kt_, vt_ = (randn(1, S, n_, 128, dtype=bf).requires_grad_()
                     for n_ in (Ht, Hkt, Hkt))
    dot_ = randn(1, S, Ht, 128, dtype=bf)
    tp_in = (qt_, kt_, vt_)
    compare("ring_step_bwd", f"flash backward {tp_label} bf16",
            torch.autograd.grad(ops.flash_attention(*tp_in), tp_in, dot_),
            torch.autograd.grad(ref.flash_attention(*tp_in), tp_in, dot_),
            BF16_TOL, rel=True)
    with torch.no_grad():
        o_t, lse_t = fa.flash_attention(*tp_in, return_lse=True)
        o_tr, lse_tr = ref.flash_attention(*tp_in, return_lse=True)
    compare("flash_attention", f"{tp_label} bf16", (o_t,), (o_tr,),
            BF16_TOL, rel=True)
    compare("flash_attention", f"lse {tp_label} bf16", (lse_t,), (lse_tr,),
            FP32_TOL)
    del o_tr, lse_tr
    gt_, ut_, dht_ = (randn(S, Ft, dtype=bf) for _ in range(3))
    compare("swiglu", f"{S}x{Ft} bf16 (tp_ranks)", (sg.swiglu(gt_, ut_),),
            (ref.swiglu(gt_, ut_),), BF16_TOL)
    compare("swiglu_bwd", f"{S}x{Ft} bf16 (dg,du) (tp_ranks)",
            sg.swiglu_bwd(gt_, ut_, dht_), ref.swiglu_bwd(gt_, ut_, dht_),
            BF16_TOL)

    # the flash backward with a window, a softcap and head dims between
    # the tile widths: the one-rank ring_step_bwd kernel against the plain
    # hop backward on the same o, lse (the flash kernel's) and delta
    def hop_bwd_inputs(B_, S_, H_, Hk_, hd_, dt, window=None, softcap=None):
        q_, do_ = (randn(1, B_, S_, H_, hd_, dtype=dt) for _ in range(2))
        k_, v_ = (randn(1, B_, S_, Hk_, hd_, dtype=dt) for _ in range(2))
        with torch.no_grad():
            o_, lse_ = fa.flash_attention(q_[0], k_[0], v_[0], window=window,
                                          softcap=softcap, return_lse=True)
        dl_ = (do_.float() * o_[None].float()).sum(-1)
        return q_, k_, v_, do_, lse_[None], dl_

    def hop_bwd(fn, ins, S_, **kw):
        q_, k_ = ins[0], ins[1]
        acc_ = (torch.zeros(q_.shape, device=dev),
                torch.zeros(k_.shape, device=dev),
                torch.zeros(k_.shape, device=dev))
        return fn(*ins, *acc_, [(0, 0, 0, S_, S_)], **kw)

    # h2o-danube-3-4b's band and head dim at its training length (S
    # SWA_TRAIN_SEQ, window SWA_WINDOW: the band binds in every row past
    # the window), on 8 of its 32 heads (the plain version's four
    # score-sized fp32 tensors take ~8.6 GB there, ~34 GB at 32), beside
    # SDPA with the boolean band mask and a control with key tile
    # SWA_WINDOW .. SWA_WINDOW + 63 (inside the band of every later row)
    # left out; then head dim 24, a softcap, and both with fp32
    Sw, W = SWA_TRAIN_SEQ, SWA_WINDOW
    sw_in = hop_bwd_inputs(1, Sw, 8, 2, 120, bf, window=W)
    case = f"flash backward B1 S{Sw} H8 Hk2 hd120 window{W} bf16"
    want = hop_bwd(ref.ring_step_bwd, sw_in, Sw, window=W)
    err_w = compare("ring_step_bwd", case,
                    hop_bwd(ra.ring_step_bwd, sw_in, Sw, window=W), want,
                    BF16_TOL, rel=True)
    band = ref.attention_mask(Sw, Sw, causal=True, window=W, device=dev)
    ts = [t[0].transpose(1, 2).detach().requires_grad_() for t in sw_in[:3]]
    sd = torch.autograd.grad(F.scaled_dot_product_attention(
        *ts, attn_mask=band, enable_gqa=True), ts, sw_in[3][0].transpose(1, 2))
    _reading(readings, "ring_step_bwd", case, "SDPA, band mask",
             tuple(t.transpose(1, 2)[None] for t in sd), want)
    del ts, sd
    _reading(readings, "ring_step_bwd", case,
             f"control: key tile {W} out",
             _bwd_without_key_tile(torch, ref, *sw_in, W, W + 64, window=W),
             want)
    del want, sw_in
    for label, shape_, dt, kw in (
            ("B1 S1000 H8 Hk2 hd24 window300", (1, 1000, 8, 2, 24), bf,
             dict(window=300)),
            ("B1 S1000 H8 Hk2 hd128 softcap30", (1, 1000, 8, 2, 128), bf,
             dict(softcap=30.0)),
            ("B2 S300 H8 Hk2 hd120 window100 softcap20",
             (2, 300, 8, 2, 120), f32, dict(window=100, softcap=20.0))):
        ins = hop_bwd_inputs(*shape_, dt, **kw)
        compare("ring_step_bwd", f"flash backward {label} {dt}",
                hop_bwd(ra.ring_step_bwd, ins, shape_[1], **kw),
                hop_bwd(ref.ring_step_bwd, ins, shape_[1], **kw), tol[dt],
                rel=dt == bf)

    # rmsnorm_bwd and swiglu_bwd at the training shapes (4096 tokens)
    x, sc, dy = (randn(TRAIN_SEQ, 4096, dtype=bf), randn(4096, dtype=bf),
                 randn(TRAIN_SEQ, 4096, dtype=bf))
    compare("rmsnorm_bwd", f"{TRAIN_SEQ}x4096 bf16 (dx,dscale)",
            rn.rmsnorm_bwd(x, sc, dy, 1e-5), ref.rmsnorm_bwd(x, sc, dy, 1e-5),
            BF16_TOL)
    # off the main path: a masked ring row (D 100 fp32: 25 packs) and the
    # general kernel (D 100 bf16 is no multiple of 8; D 20480 is past the
    # ring)
    for rows, D, dt in ((37, 100, f32), (37, 100, bf), (40, 20480, bf)):
        xs_, ss_, dys = (randn(rows, D, dtype=dt), randn(D, dtype=dt),
                         randn(rows, D, dtype=dt))
        compare("rmsnorm_bwd", f"{rows}x{D} {dt} (dx,dscale)",
                rn.rmsnorm_bwd(xs_, ss_, dys), ref.rmsnorm_bwd(xs_, ss_, dys),
                tol[dt])
    g, u, dh = (randn(TRAIN_SEQ, 14336, dtype=bf) for _ in range(3))
    compare("swiglu_bwd", f"{TRAIN_SEQ}x14336 bf16 (dg,du)",
            sg.swiglu_bwd(g, u, dh), ref.swiglu_bwd(g, u, dh), BF16_TOL)
    gs_, us_ = randn(3, 5, 77, dtype=f32), randn(3, 5, 77, dtype=f32)
    dhs = randn(3, 5, 77, dtype=bf)
    compare("swiglu_bwd", "3x5x77 fp32, dh bf16 (dg,du)",
            sg.swiglu_bwd(gs_, us_, dhs), ref.swiglu_bwd(gs_, us_, dhs),
            FP32_TOL)

    # ssm_scan_bwd, the scan's VJP, against the plain reverse loop: at
    # falcon-mamba-7b's training shape (the timed inputs), then a ragged S
    # (not a multiple of the 64-step chunk), d_state 1, 4 and 16, a partial
    # block of channels, and decays from 1 (|dt A| ~ 1e-3 over 4096 steps)
    # to underflow (|dt A| >= 50).  Each gradient by its norm
    # (SCAN_BWD_REL; du, rounded to bf16 where u is bf16, at
    # SCAN_BWD_BF16_DU_REL, beside a control on the small bf16 cases: that
    # du against the plain loop's fp32 du, which must read above the
    # limit), the kernel run twice (equal bit for bit: no float atomics),
    # and the forward with its chunk states giving y and the last state of
    # the forward without them, bit for bit
    from repro_torch.kernels import ssm_scan as ss

    def scan_in(B_, S_, di_, ds_, u_dtype, dt_scale, dt_add):
        dt_ = F.softplus(randn(B_, S_, di_, dtype=f32) - 1.0) * dt_scale
        return (randn(B_, S_, di_, dtype=u_dtype), dt_ + dt_add,
                randn(B_, S_, ds_, dtype=f32), randn(B_, S_, ds_, dtype=f32),
                -torch.exp(randn(di_, ds_, dtype=f32) * 0.3))

    scan_train = None
    for label, B_, S_, di_, ds_, ud, dts, da_rel in SCAN_BWD_CASES:
        ud = {"bf": bf, "f32": f32}[ud]
        sargs = scan_in(B_, S_, di_, ds_, ud, *dts)
        sdy = randn(B_, S_, di_, dtype=f32)
        y0, h0 = ss.ssm_scan(*sargs)
        y1, h1, shc = ss.ssm_scan(*sargs, keep_chunks=True)
        if scan_train is None:
            scan_train = (sargs, shc, sdy)
        if device_only:
            continue
        assert torch.equal(y0, y1) and torch.equal(h0, h1), label
        got = ss.ssm_scan_bwd(*sargs, shc, sdy)
        again = ss.ssm_scan_bwd(*sargs, shc, sdy)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), label
        want = ref.ssm_scan_bwd(*sargs, sdy)
        rels = [_rel_err(g, w) for g, w in zip(got, want)]
        limits = [SCAN_BWD_BF16_DU_REL if ud == bf else SCAN_BWD_REL] + \
            [SCAN_BWD_REL] * 3 + [da_rel]
        checks.append({"kernel": "ssm_scan_bwd", "case": label,
                       "max_abs_err": _max_err(got, want),
                       "rel_err": max(rels)})
        control = ""
        if ud == bf and B_ * S_ * di_ < 10 ** 6:
            du32 = ref.ssm_scan_bwd(sargs[0].float(), *sargs[1:], sdy)[0]
            ctl = _rel_err(got[0], du32)
            control = f", control du vs an fp32 du {ctl:.2e}"
            assert ctl > SCAN_BWD_BF16_DU_REL, (label, ctl)
        log(f"[kernels] ssm_scan_bwd    {label:42s} rel_err du/ddt/dB/dC/dA "
            + "/".join(f"{r:.2e}" for r in rels) + " (limits "
            + "/".join(f"{lim:g}" for lim in limits) + ")" + control
            + ", fwd with chunk states and a second run bit for bit ok")
        assert all(r <= lim for r, lim in zip(rels, limits)), (label, rels)
        del got, again, want
    scan_fwd_ms = None
    if not device_only:
        fwd_chunks = event_ms(lambda: ss.ssm_scan(*scan_train[0],
                                                  keep_chunks=True))
        fwd_plain = event_ms(lambda: ss.ssm_scan(*scan_train[0]))
        scan_fwd_ms = {"without_chunk_states": fwd_plain,
                       "with_chunk_states": fwd_chunks}
        log(f"[kernels] time ssm_scan S{TRAIN_SEQ} di8192 ds16 bf16: "
            f"{fwd_plain:.4f} ms, with its chunk states {fwd_chunks:.4f} ms")

    # ---- timings, bf16, at the training shapes
    el, f4 = 2, 4
    carry0 = empty_carry(cp, B, C, H, hd)
    tables = [ra.ring_hops(CP_CHUNKS, s_) for s_ in range(cp)]
    vis = [_visible_pairs(CP_CHUNKS, s_) for s_ in range(cp)]
    carry_bytes = cp * B * C * H * (hd + 2) * f4 * 2      # read + write
    ring_bytes = ring_ops = 0
    for s_, per_rank in enumerate(vis):
        ring_bytes += carry_bytes
        for r, n in enumerate(per_rank):
            if n:
                src = tables[s_][r][1]
                ring_bytes += (B * C * H * hd
                               + 2 * B * CP_CHUNKS[src] * Hk * hd) * el
                ring_ops += 4 * n * B * H * hd
    pairs = S * (S + 1) // 2
    # the checked S4096 inputs, with a leading rank axis of one
    qf, kf, vf, dof, of, lsef = (flash_in[n][None] for n in
                                 ("q", "k", "v", "do", "o", "lse"))
    dlf = (dof.float() * of.float()).sum(-1)
    flash_hop = [(0, 0, 0, S, S)]
    bwd_acc = (torch.zeros(qf.shape, device=dev),
               torch.zeros(kf.shape, device=dev),
               torch.zeros(kf.shape, device=dev))
    # SDPA's layout and autograd graph for its backward alone
    qt, kt, vt = (t[0].transpose(1, 2).detach().requires_grad_()
                  for t in (qf, kf, vf))
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
    do_t = dof[0].transpose(1, 2)
    xr = x.detach().requires_grad_()
    sr = sc.detach().requires_grad_()
    rms_out = F.rms_norm(xr, (4096,), sr, 1e-5)
    # h2o-danube-3-4b's flash backward at its training shape (all 32
    # heads), beside SDPA's backward with the boolean band mask; the plain
    # version runs in 4 groups of 8 heads (its score-sized temporaries)
    sw_in = hop_bwd_inputs(1, Sw, 32, 8, 120, bf, window=W)
    sw_acc = tuple(torch.zeros(sw_in[i].shape, device=dev)
                   for i in (0, 1, 1))
    sw_hop = [(0, 0, 0, Sw, Sw)]
    sw_t = [t[0].transpose(1, 2).detach().requires_grad_()
            for t in sw_in[:3]]
    sw_out = F.scaled_dot_product_attention(*sw_t, attn_mask=band,
                                            enable_gqa=True)
    sw_do = sw_in[3][0].transpose(1, 2)
    band_pairs = sum(min(i + 1, W) for i in range(Sw))

    def sw_plain():
        q_, k_, v_, do_, lse_, dl_ = sw_in
        for g_ in range(4):
            h_, hk_ = slice(8 * g_, 8 * g_ + 8), slice(2 * g_, 2 * g_ + 2)
            ref.ring_step_bwd(
                q_[:, :, :, h_], k_[:, :, :, hk_], v_[:, :, :, hk_],
                do_[:, :, :, h_], lse_[..., h_], dl_[..., h_],
                sw_acc[0][:, :, :, h_], sw_acc[1][:, :, :, hk_],
                sw_acc[2][:, :, :, hk_], sw_hop, window=W)

    def ring_all(step_fn):
        return lambda: [step_fn(q, k, v, *carry0, t) for t in tables]

    rows = {
        "ring_step": dict(
            source="src/repro_torch/kernels/csrc/ring_attention.cu",
            replaces="src/repro/kernels/ring_attention.py:169",
            shape=f"cp4 chunks {'/'.join(map(str, CP_CHUNKS))} B1 H32 Hk8 "
                  "hd128 bf16, fp32 carry; per launch, mean of the 4 steps",
            fn=ring_all(ra.ring_step), plain=ring_all(ref.ring_step),
            per_call=cp, library=None, kernels=("ring_fwd",),
            bytes=ring_bytes / cp, ops=[(ring_ops / cp, bf16_peak)],
            err=max(c["max_abs_err"] for c in checks
                    if c["kernel"] == "ring_step")),
        "ring_step_bwd": dict(
            source="src/repro_torch/kernels/csrc/ring_attention.cu",
            replaces="src/repro/kernels/ring_attention.py:169 (its VJP; "
                     "no TPU backward kernel)",
            shape=f"one rank B1 S{S} H32 Hk8 hd128 causal bf16 (the flash "
                  "backward), fp32 dq/dk/dv",
            fn=lambda: ra.ring_step_bwd(qf, kf, vf, dof, lsef, dlf, *bwd_acc,
                                        flash_hop),
            plain=lambda: ref.ring_step_bwd(qf, kf, vf, dof, lsef, dlf,
                                            *bwd_acc, flash_hop),
            per_call=1, kernels=("ring_bwd",),
            library=lambda: torch.autograd.grad(
                sdpa_out, (qt, kt, vt), do_t, retain_graph=True),
            bytes=(2 * S * H * hd + 2 * S * Hk * hd) * el + 2 * S * H * f4
            + (S * H * hd + 2 * S * Hk * hd) * f4,
            ops=[(10 * pairs * H * hd, bf16_peak)],
            err=flash_in["err"]),
        # the same kernel at h2o-danube-3-4b's training shape: hd 120 in
        # the 128 tile, the window's band (its bound counts the band's
        # pairs at the real hd)
        "ring_step_bwd hd120": dict(
            name="ring_step_bwd",
            source="src/repro_torch/kernels/csrc/ring_attention.cu",
            replaces="src/repro/kernels/ring_attention.py:169 (its VJP; "
                     "no TPU backward kernel)",
            shape=f"one rank B1 S{Sw} H32 Hk8 hd120 window{W} causal bf16 "
                  "(h2o-danube-3-4b's flash backward), fp32 dq/dk/dv; "
                  "plain in 4 groups of 8 heads",
            fn=lambda: ra.ring_step_bwd(*sw_in, *sw_acc, sw_hop, window=W),
            plain=sw_plain, per_call=1, kernels=("ring_bwd",),
            library=lambda: torch.autograd.grad(
                sw_out, sw_t, sw_do, retain_graph=True),
            bytes=(2 * Sw * 32 * 120 + 2 * Sw * 8 * 120) * el
            + 2 * Sw * 32 * f4 + (Sw * 32 * 120 + 2 * Sw * 8 * 120) * f4,
            ops=[(10 * band_pairs * 32 * 120, bf16_peak)],
            err=err_w),
        "rmsnorm_bwd": dict(
            source="src/repro_torch/kernels/csrc/rmsnorm.cu",
            replaces="src/repro/kernels/rmsnorm.py:19 (its VJP; no TPU "
                     "backward kernel)",
            shape=f"x, dy ({S}, 4096) bf16 -> dx bf16, dscale fp32",
            fn=lambda: rn.rmsnorm_bwd(x, sc, dy, 1e-5),
            plain=lambda: ref.rmsnorm_bwd(x, sc, dy, 1e-5), per_call=1,
            kernels=("rmsnorm_bwd_ring_kernel",),
            library=lambda: torch.autograd.grad(rms_out, (xr, sr), dy,
                                                retain_graph=True),
            bytes=3 * S * 4096 * el + 4096 * (el + f4),
            ops=[(10 * S * 4096, fp32_peak)],
            err=max(c["max_abs_err"] for c in checks
                    if c["kernel"] == "rmsnorm_bwd")),
        "swiglu_bwd": dict(
            source="src/repro_torch/kernels/csrc/swiglu.cu",
            replaces="src/repro/kernels/swiglu.py:16 (its VJP; no TPU "
                     "backward kernel)",
            shape=f"g, u, dh ({S}, 14336) bf16 -> dg, du bf16",
            fn=lambda: sg.swiglu_bwd(g, u, dh),
            plain=lambda: ref.swiglu_bwd(g, u, dh), per_call=1, library=None,
            kernels=("swiglu_bwd_kernel",),
            bytes=5 * S * 14336 * el,
            ops=[(12 * S * 14336, fp32_peak),
                 (S * 14336, fp32_peak * SFU_PER_FP32_FLOP)],
            err=max(c["max_abs_err"] for c in checks
                    if c["kernel"] == "swiglu_bwd")),
    }
    # the scan's VJP at falcon-mamba-7b's training shape: u, dt, dy, B, C,
    # A and the chunk states read once, du, ddt, dB, dC and dA written
    # once; per state and step ~20 FLOP (the recomputed update and the
    # reverse step) and one exponential: the recurrence and the gradients
    # share a_t = exp(dt_t A), which the kernel, by its design (a walk
    # over the chunk for its carry, then a recompute of each sub-chunk),
    # takes twice.  A call is the flags' memset, the walk and the passes
    # adding its partials
    sa, shc, sdy = scan_train
    Sb, dib = sa[0].shape[1:]
    dsb = sa[2].shape[-1]
    states = Sb * dib * dsb
    rows["ssm_scan_bwd"] = dict(
        source="src/repro_torch/kernels/csrc/ssm_scan.cu",
        replaces="src/repro/kernels/ssm_scan.py:58 (its VJP; no TPU "
                 "backward kernel)",
        shape=f"B1 S{Sb} di{dib} ds{dsb}, u bf16, dy fp32 -> du bf16, "
              "ddt/dB/dC/dA fp32 (falcon-mamba-7b's training shape)",
        fn=lambda: ss.ssm_scan_bwd(*sa, shc, sdy),
        plain=lambda: ref.ssm_scan_bwd(*sa, sdy), per_call=1,
        library=None, kernels=("ssm_scan_bwd_kernel", "sum_partials_kernel",
                               "Memset"),
        bytes=(Sb * dib * (el + 4 + 4 + el + 4) + 4 * Sb * dsb * f4
               + 2 * dib * dsb * f4 + shc.numel() * f4),
        ops=[(20 * states, fp32_peak),
             (states, fp32_peak * SFU_PER_FP32_FLOP)],
        err=max((c["max_abs_err"] for c in checks
                 if c["kernel"] == "ssm_scan_bwd"), default=0.0))
    timed = {}
    for kname, r in rows.items():
        n = r["per_call"]
        if device_only:
            timed[kname] = _device_row(device_ms, r, n)
            if kname == "rmsnorm_bwd":   # what one call runs on the card
                timed[kname]["runs_a_call"] = {
                    k: c for k, (c, _) in device_profile(r["fn"]).items()}
            continue
        bytes_ms = r["bytes"] / bw * 1e3
        ops_ms = max(n / peak for n, peak in r["ops"]) * 1e3
        timed[kname] = {
            "name": r.get("name", kname), "line": True, "route": "cuda",
            "source": r["source"],
            "replaces": r["replaces"], "shape": r["shape"],
            "max_abs_err": r["err"],
            "ms": event_ms(r["fn"]) / n,
            "plain_ms": event_ms(r["plain"], iters=3, warmup=1) / n,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": (event_ms(r["library"])
                           if r["library"] else None),
        }
        t = timed[kname]
        log(f"[kernels] time {kname:15s} {r['shape']}: kernel {t['ms']:.4f} "
            f"ms, plain {t['plain_ms']:.4f} ms, library {t['library_ms']} "
            f"ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    # the cp ring's backward per launch at the slice's shape (no library
    # call computes a ring hop's gradient); a hop's work is its real rows'
    # (the kernel skips the pad rows): q, dout, lse, delta and dq of every
    # rank's chunk, k, v, dk and dv of every source chunk
    bwd_bytes = bwd_ops = 0
    rows = B * sum(CP_CHUNKS)
    for per_rank in vis:
        bwd_bytes += (2 * rows * H * hd + 2 * rows * Hk * hd) * el
        bwd_bytes += 2 * rows * H * f4
        bwd_bytes += 2 * rows * (H + 2 * Hk) * hd * f4
        bwd_ops += sum(10 * n_ * B * H * hd for n_ in per_rank)
    acc3 = zeros_like_qkv()

    def cp_bwd():
        return [ra.ring_step_bwd(q, k, v, do, lse, delta, *acc3, t)
                for t in tables]

    if device_only:
        return checks, timed, {"ring_step_bwd_cp4_per_launch_device_ms":
                               device_ms(cp_bwd, ("ring_bwd",)) / cp}
    cp_bwd_ms = event_ms(cp_bwd) / cp
    cp_bwd_bound = max(bwd_bytes / cp / bw, bwd_ops / cp / bf16_peak) * 1e3
    extra = {"ring_step_bwd_cp4_per_launch_ms": cp_bwd_ms,
             "ring_step_bwd_cp4_bound_ms": cp_bwd_bound,
             f"ssm_scan_S{TRAIN_SEQ}_ms": scan_fwd_ms,
             "rel_readings": readings}
    log(f"[kernels] time ring_step_bwd    cp4 {CP_CHUNKS} bf16 per launch: "
        f"kernel {cp_bwd_ms:.4f} ms, bound {cp_bwd_bound:.4f} ms")
    # the tp_ranks shapes (CUDA events): the kernels beside SDPA, forward
    # and backward (the flash backward as a one-rank ring_step_bwd from the
    # kernel's o and lse), and their bounds
    q1, k1, v1, do1 = (t.detach()[None] for t in (*tp_in, dot_))
    o1, lse1 = o_t[None], lse_t[None]
    dl1 = (do1.float() * o1.float()).sum(-1)
    acc1 = (torch.zeros(q1.shape, device=dev),
            torch.zeros(k1.shape, device=dev),
            torch.zeros(k1.shape, device=dev))
    qs1, ks1, vs1 = (t.detach().transpose(1, 2).requires_grad_()
                     for t in tp_in)
    sd_out = F.scaled_dot_product_attention(qs1, ks1, vs1, is_causal=True,
                                            enable_gqa=True)
    pairs_tp = S * (S + 1) // 2
    tp_rows = {
        "flash_attention": (
            lambda: fa.flash_attention(*(t.detach() for t in tp_in)),
            lambda: F.scaled_dot_product_attention(
                qs1.detach(), ks1.detach(), vs1.detach(), is_causal=True,
                enable_gqa=True),
            2 * S * (Ht + Hkt) * 128 * el, 4 * pairs_tp * Ht * 128),
        "ring_step_bwd": (
            lambda: ra.ring_step_bwd(q1, k1, v1, do1, lse1, dl1, *acc1,
                                     [(0, 0, 0, S, S)]),
            lambda: torch.autograd.grad(sd_out, (qs1, ks1, vs1),
                                        dot_.transpose(1, 2),
                                        retain_graph=True),
            (2 * S * Ht * 128 + 2 * S * Hkt * 128) * el + 2 * S * Ht * f4
            + (S * Ht * 128 + 2 * S * Hkt * 128) * f4,
            10 * pairs_tp * Ht * 128),
        "swiglu": (lambda: sg.swiglu(gt_, ut_), None, 3 * S * Ft * el, 0),
        "swiglu_bwd": (lambda: sg.swiglu_bwd(gt_, ut_, dht_), None,
                       5 * S * Ft * el, 12 * S * Ft),
    }
    extra["tp_ranks_shapes"] = {}
    for kname, (fn, lib, nbytes, nops) in tp_rows.items():
        peak = bf16_peak if "ring" in kname or "flash" in kname else \
            fp32_peak
        row = {"shape": tp_label if "swiglu" not in kname
               else f"({S}, {Ft}) bf16", "ms": event_ms(fn),
               "library_ms": event_ms(lib) if lib else None,
               "bound_ms": max(nbytes / bw, nops / peak) * 1e3}
        extra["tp_ranks_shapes"][kname] = row
        log(f"[kernels] time {kname:15s} {row['shape']}: kernel "
            f"{row['ms']:.4f} ms, library {row['library_ms']} ms, bound "
            f"{row['bound_ms']:.4f} ms")
    return checks, timed, extra


# ----------------------------------------------------------- phase 3b ---
def _band_without_key_tile(torch, F, ref, q, k, v, window: int, lo: int,
                           hi: int):
    """The windowed causal forward in fp32 (SDPA on the plain math path)
    with keys [lo, hi) left out of every row: a control."""
    S = q.shape[1]
    mask = ref.attention_mask(S, S, causal=True, window=window,
                              device=q.device).clone()
    mask[:, lo:hi] = False
    qt, kt, vt = (t.float().transpose(1, 2) for t in (q, k, v))
    return F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True).transpose(1, 2)


def phase_griffin_kernels(torch, dev, name, device_only=False):
    """recurrentgemma-9b's attention kernels at head dim 256 over one KV
    head, window GRIFFIN_WINDOW, against their plain versions on the card
    (bf16 2e-2 and REL_TOL by norm, beside SDPA with the boolean band
    mask and a control with an in-band key tile left out): the forward at
    the serve trace's longest prompt (B1 S GRIFFIN_PREFILL) and at the
    training length (B1 S TRAIN_SEQ) with and without lse, fp32 at a
    small shape; the backward (one-rank ring_step_bwd) at B1 S TRAIN_SEQ
    on GRIFFIN_BWD_HEADS heads.  Then each is timed at 16 heads beside
    the plain version (the backward's in groups of GRIFFIN_BWD_HEADS
    heads) and SDPA with the band mask, with its bound counted over the
    band's pairs.  Also timed, not kernels (the JAX package has none
    there either): the RG-LRU scan (plain torch) at a prefill and a
    training step, one decode step of a rec block at the engine's batch,
    and a gate product's two routes (fp32 upcasts, which training takes,
    and cuBLAS's bf16 product with fp32 output, which serving takes).
    ``device_only``: as in phase_kernels."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import ring_attention as ra
    from repro_torch.models import griffin, registry
    from repro_torch.utils.timing import device_ms, event_ms

    bw, bf16_peak, fp32_peak = peaks(name)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    checks, readings = [], []
    bf, f32 = torch.bfloat16, torch.float32
    H, W, hd, el, f4 = GRIFFIN_H, GRIFFIN_WINDOW, 256, 2, 4
    S_pf, S_tr = GRIFFIN_PREFILL, TRAIN_SEQ

    def randn(*shape, dtype=bf):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def compare(kernel, label, got, want, tol_, rel=False):
        err = _max_err(got, want)
        for g, w in zip(got, want):
            torch.testing.assert_close(g.float(), w.float(), **tol_)
        checks.append({"kernel": kernel, "case": label, "max_abs_err": err})
        msg = ""
        if rel:
            r = checks[-1]["rel_err"] = _rel_err(got, want)
            msg = f", rel_err {r:.3e} (limit {REL_TOL})"
            assert r <= REL_TOL, (kernel, label, r)
        log(f"[kernels] {kernel:15s} {label:42s} max_abs_err {err:.3e}"
            f"{msg} ok")
        return err

    def band_pairs(S):
        return sum(min(i + 1, W) for i in range(S))

    def sdpa_band(q, k, v):
        S = q.shape[1]
        band = ref.attention_mask(S, S, causal=True, window=W, device=dev)
        return F.scaled_dot_product_attention(
            *(t.transpose(1, 2) for t in (q, k, v)), attn_mask=band,
            enable_gqa=True).transpose(1, 2)

    fwd = {S: (randn(1, S, H, hd), randn(1, S, 1, hd), randn(1, S, 1, hd))
           for S in (S_pf, S_tr)}
    errs = {}
    if not device_only:
        for S, (q, k, v) in fwd.items():
            case = f"B1 S{S} H16 Hk1 hd256 window{W} bf16"
            want, want_lse = ref.flash_attention(q, k, v, window=W,
                                                 return_lse=True)
            errs[S] = compare("flash_attention", case,
                              (fa.flash_attention(q, k, v, window=W),),
                              (want,), BF16_TOL, rel=True)
            got, lse = fa.flash_attention(q, k, v, window=W,
                                          return_lse=True)
            errs[S, "lse"] = compare("flash_attention", case + " +lse",
                                     (got,), (want,), BF16_TOL, rel=True)
            compare("flash_attention", case + " its lse", (lse,),
                    (want_lse,), FP32_TOL)
            _reading(readings, "flash_attention", case, "SDPA, band mask",
                     sdpa_band(q, k, v), want)
            _reading(readings, "flash_attention", case,
                     f"control: key tile {W} out",
                     _band_without_key_tile(torch, F, ref, q, k, v, W, W,
                                            W + 64), want)
            del want, want_lse, got, lse
        qs, ks, vs = (randn(1, 300, 4, hd, dtype=f32),
                      randn(1, 300, 1, hd, dtype=f32),
                      randn(1, 300, 1, hd, dtype=f32))
        compare("flash_attention", "B1 S300 H4 Hk1 hd256 window100 fp32",
                (fa.flash_attention(qs, ks, vs, window=100),),
                (ref.flash_attention(qs, ks, vs, window=100),), FP32_TOL)

    # the backward at the training length: inputs with o and lse from the
    # forward kernel, as FlashAttentionFn saves them
    def bwd_inputs(heads):
        q_, do_ = randn(1, 1, S_tr, heads, hd), randn(1, 1, S_tr, heads, hd)
        k_, v_ = randn(1, 1, S_tr, 1, hd), randn(1, 1, S_tr, 1, hd)
        with torch.no_grad():
            o_, lse_ = fa.flash_attention(q_[0], k_[0], v_[0], window=W,
                                          return_lse=True)
        dl_ = (do_.float() * o_[None].float()).sum(-1)
        return q_, k_, v_, do_, lse_[None], dl_

    hop = [(0, 0, 0, S_tr, S_tr)]

    def acc_of(ins):
        return (torch.zeros(ins[0].shape, device=dev),
                torch.zeros(ins[1].shape, device=dev),
                torch.zeros(ins[1].shape, device=dev))

    if not device_only:
        few = bwd_inputs(GRIFFIN_BWD_HEADS)
        case = (f"flash backward B1 S{S_tr} H{GRIFFIN_BWD_HEADS} Hk1 hd256 "
                f"window{W} bf16")
        want = ref.ring_step_bwd(*few, *acc_of(few), hop, window=W)
        errs["bwd"] = compare("ring_step_bwd", case,
                              ra.ring_step_bwd(*few, *acc_of(few), hop,
                                               window=W), want, BF16_TOL,
                              rel=True)
        band = ref.attention_mask(S_tr, S_tr, causal=True, window=W,
                                  device=dev)
        ts = [t[0].transpose(1, 2).detach().requires_grad_()
              for t in few[:3]]
        sd = torch.autograd.grad(F.scaled_dot_product_attention(
            *ts, attn_mask=band, enable_gqa=True), ts,
            few[3][0].transpose(1, 2))
        _reading(readings, "ring_step_bwd", case, "SDPA, band mask",
                 tuple(t.transpose(1, 2)[None] for t in sd), want)
        del ts, sd
        _reading(readings, "ring_step_bwd", case,
                 f"control: key tile {W} out",
                 _bwd_without_key_tile(torch, ref, *few, W, W + 64,
                                       window=W), want)
        del want, few

    # ---- timings at 16 heads
    bq = bwd_inputs(H)
    bacc = acc_of(bq)
    bt = [t[0].transpose(1, 2).detach().requires_grad_() for t in bq[:3]]
    band_tr = ref.attention_mask(S_tr, S_tr, causal=True, window=W,
                                 device=dev)
    b_out = F.scaled_dot_product_attention(*bt, attn_mask=band_tr,
                                           enable_gqa=True)
    b_do = bq[3][0].transpose(1, 2)
    G = GRIFFIN_BWD_HEADS

    def bwd_plain():
        q_, k_, v_, do_, lse_, dl_ = bq
        for g_ in range(H // G):
            h_ = slice(G * g_, G * g_ + G)
            ref.ring_step_bwd(q_[:, :, :, h_], k_, v_, do_[:, :, :, h_],
                              lse_[..., h_], dl_[..., h_],
                              bacc[0][:, :, :, h_], bacc[1], bacc[2], hop,
                              window=W)

    qp, kp, vp = fwd[S_pf]
    qt_, kt_, vt_ = fwd[S_tr]
    src = "src/repro_torch/kernels/csrc/"
    rows = {
        "flash_attention hd256": dict(
            name="flash_attention", source=src + "flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:91",
            shape=f"B1 S{S_pf} H16 Hk1 hd256 window{W} causal bf16 "
                  "(recurrentgemma-9b's prefill)",
            fn=lambda: fa.flash_attention(qp, kp, vp, window=W),
            plain=lambda: ref.flash_attention(qp, kp, vp, window=W),
            library=lambda: sdpa_band(qp, kp, vp), kernels=("flash_fwd",),
            bytes=(2 * S_pf * H * hd + 2 * S_pf * hd) * el,
            ops=[(4 * band_pairs(S_pf) * hd * H, bf16_peak)],
            err=errs.get(S_pf)),
        "flash_attention hd256 lse": dict(
            name="flash_attention", source=src + "flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:91",
            shape=f"B1 S{S_tr} H16 Hk1 hd256 window{W} causal bf16, with "
                  "lse (recurrentgemma-9b's training forward)",
            fn=lambda: fa.flash_attention(qt_, kt_, vt_, window=W,
                                          return_lse=True),
            plain=lambda: ref.flash_attention(qt_, kt_, vt_, window=W,
                                              return_lse=True),
            library=lambda: sdpa_band(qt_, kt_, vt_),
            kernels=("flash_fwd",),
            bytes=(2 * S_tr * H * hd + 2 * S_tr * hd) * el + S_tr * H * f4,
            ops=[(4 * band_pairs(S_tr) * hd * H, bf16_peak)],
            err=errs.get((S_tr, "lse"))),
        "ring_step_bwd hd256": dict(
            name="ring_step_bwd", source=src + "ring_attention.cu",
            replaces="src/repro/kernels/ring_attention.py:169 (its VJP; "
                     "no TPU backward kernel)",
            shape=f"one rank B1 S{S_tr} H16 Hk1 hd256 window{W} causal bf16 "
                  "(recurrentgemma-9b's flash backward), fp32 dq/dk/dv; "
                  f"plain in {H // G} groups of {G} heads",
            fn=lambda: ra.ring_step_bwd(*bq, *bacc, hop, window=W),
            plain=bwd_plain, kernels=("ring_bwd",),
            library=lambda: torch.autograd.grad(b_out, bt, b_do,
                                                retain_graph=True),
            bytes=(2 * S_tr * H * hd + 2 * S_tr * hd) * el
            + 2 * S_tr * H * f4 + (S_tr * H * hd + 2 * S_tr * hd) * f4,
            ops=[(10 * band_pairs(S_tr) * H * hd, bf16_peak)],
            err=errs.get("bwd")),
    }
    timed = {}
    for kname, r in rows.items():
        if device_only:
            timed[kname] = _device_row(device_ms, r)
            continue
        bytes_ms = r["bytes"] / bw * 1e3
        ops_ms = max(n / peak for n, peak in r["ops"]) * 1e3
        timed[kname] = {
            "name": r["name"], "line": True, "route": "cuda",
            "source": r["source"], "replaces": r["replaces"],
            "shape": r["shape"], "max_abs_err": r["err"],
            "ms": event_ms(r["fn"]),
            "plain_ms": event_ms(r["plain"], iters=3, warmup=1),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": event_ms(r["library"]),
        }
        t = timed[kname]
        log(f"[kernels] time {kname:15s} {r['shape']}: kernel {t['ms']:.4f} "
            f"ms, plain {t['plain_ms']:.4f} ms, library {t['library_ms']:.4f}"
            f" ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    del bq, bacc, bt, b_out, fwd
    if device_only:
        return checks, timed, {}

    # the RG-LRU's plain torch at full width (W 4096): the scan over a
    # prefill (no gradient) and a training step (forward and backward),
    # one rec block's decode step at the engine's batch of 8, and one gate
    # product (S, W) x (W, W) by both routes
    cfg = registry.get_config(GRIFFIN_ARCH)
    Wd = cfg.lru_width_
    rg = {}
    with torch.no_grad():
        x, ig, la = (randn(1, S_pf, Wd, dtype=f32) for _ in range(3))
        ig, la = torch.sigmoid(ig), -torch.rand(
            (1, S_pf, Wd), generator=gen, device=dev)
        rg[f"scan_prefill_S{S_pf}_ms"] = event_ms(
            lambda: griffin.rglru_scan(x, ig, la))
    xs = [randn(1, S_tr, Wd, dtype=f32).requires_grad_() for _ in range(3)]
    dh = randn(1, S_tr, Wd, dtype=f32)

    def scan_train():
        h = griffin.rglru_scan(xs[0], torch.sigmoid(xs[1]),
                               -torch.nn.functional.softplus(xs[2]))
        return torch.autograd.grad(h, xs, dh)

    rg[f"scan_train_fwd_bwd_S{S_tr}_ms"] = event_ms(scan_train, iters=5)
    del xs, dh
    gb = torch.Generator(device=dev).manual_seed(4)
    one = griffin.init_rglru_block(gb, cfg, 1)
    p1 = {k: v[0] for k, v in one.items()}
    with torch.no_grad():
        xd = randn(8, 1, cfg.d_model)
        h8 = torch.zeros((8, Wd), device=dev)
        c8 = torch.zeros((8, cfg.ssm_conv - 1, Wd), dtype=bf, device=dev)
        rg["decode_step_B8_ms"] = event_ms(
            lambda: griffin.rglru_decode(p1, xd, h8, c8, cfg))
        u = randn(1, S_pf, Wd)
        wg = p1["w_input_gate"]
        rg[f"gate_mm_upcast_S{S_pf}_ms"] = event_ms(
            lambda: u.float() @ wg.float())
        rg[f"gate_mm_bf16_fp32_out_S{S_pf}_ms"] = event_ms(
            lambda: griffin._mm_f32(u, wg))
        rg["gate_mm_max_abs_diff"] = (
            (griffin._mm_f32(u, wg) - u.float() @ wg.float()).abs().max()
            .item())
    rg["gate_mm_bound_ms"] = 2 * S_pf * Wd * Wd / bf16_peak * 1e3
    log(f"[kernels] RG-LRU plain torch W{Wd}: " + ", ".join(
        f"{k} {v:.4g}" for k, v in rg.items()))
    del one, p1
    return checks, timed, {"rel_readings": readings, "rglru": rg}


def phase_encdec_kernels(torch, dev, name, device_only=False):
    """whisper-tiny's attention without causality at head dim 64, where
    the decoder's queries meet the encoder's keys at Sq != Sk, against
    the plain versions on the card (bf16 at 2e-2 and REL_TOL by norm,
    beside SDPA; fp32 at FP32_TOL): the flash forward at Sq < Sk, Sq > Sk
    and Sq 1, with and without lse, and its backward (the one-rank
    ``ring_step_bwd`` at the hop ``(Sk - Sq, 0, 0, Sk, Sq)`` that
    ``ops.FlashAttentionFn`` passes, negative at Sq > Sk) at Sq < Sk and
    Sq > Sk.  Then timed at whisper's shapes beside the plain version and
    SDPA: the encoder (B ED_TRAIN_B, S ED_S_ENC), the cross-attention (Sq
    ED_TRAIN_DEC against ED_S_ENC), the decode step's cross-attention (Sq
    1 at B ED_SERVE_B), and the cross-attention's backward, each row
    held against its plain version at the shape it is timed at.
    ``device_only``: as in phase_kernels."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import ring_attention as ra
    from repro_torch.utils.timing import device_ms, event_ms

    bw, bf16_peak, _ = peaks(name)
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    checks, readings = [], []
    bf, f32 = torch.bfloat16, torch.float32
    H, hd, el, f4 = ED_H, ED_HD, 2, 4

    def randn(*shape, dtype=bf):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def compare(kernel, label, got, want, tol_, rel=False):
        err = _max_err(got, want)
        for g, w in zip(got, want):
            torch.testing.assert_close(g.float(), w.float(), **tol_)
        checks.append({"kernel": kernel, "case": label, "max_abs_err": err})
        msg = ""
        if rel:
            r = checks[-1]["rel_err"] = _rel_err(got, want)
            msg = f", rel_err {r:.3e} (limit {REL_TOL})"
            assert r <= REL_TOL, (kernel, label, r)
        log(f"[kernels] {kernel:15s} {label:42s} max_abs_err {err:.3e}"
            f"{msg} ok")
        return err

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            *(t.transpose(1, 2) for t in (q, k, v))).transpose(1, 2)

    def qkv(B, sq, sk, dtype=bf):
        return (randn(B, sq, H, hd, dtype=dtype),
                randn(B, sk, H, hd, dtype=dtype),
                randn(B, sk, H, hd, dtype=dtype))

    def hop(sq, sk):
        return [(sk - sq, 0, 0, sk, sq)]

    def bwd_inputs(B, sq, sk, dtype=bf):
        """q, k, v, dO with a rank axis of 1, and the forward kernel's lse
        and delta, as ``FlashAttentionFn`` saves and makes them."""
        q_, k_, v_ = (t[None] for t in qkv(B, sq, sk, dtype))
        do_ = randn(1, B, sq, H, hd, dtype=dtype)
        with torch.no_grad():
            o_, lse_ = fa.flash_attention(q_[0], k_[0], v_[0], causal=False,
                                          return_lse=True)
        dl_ = (do_.float() * o_[None].float()).sum(-1)
        return q_, k_, v_, do_, lse_[None], dl_

    def acc_of(ins):
        return (torch.zeros(ins[0].shape, device=dev),
                torch.zeros(ins[1].shape, device=dev),
                torch.zeros(ins[1].shape, device=dev))

    S_e, S_d, Bt, Bs = ED_S_ENC, ED_TRAIN_DEC, ED_TRAIN_B, ED_SERVE_B
    if not device_only:
        # the forward: bf16 at whisper's lengths (2 rows), fp32 shorter
        for B, sq, sk, dtype in ((2, S_d, S_e, bf), (2, S_e, S_d, bf),
                                 (Bs, 1, S_e, bf), (1, 200, 520, f32),
                                 (1, 520, 200, f32), (2, 1, 520, f32)):
            case = (f"B{B} Sq{sq} Sk{sk} H{H} hd{hd} non-causal "
                    f"{'bf16' if dtype == bf else 'fp32'}")
            q, k, v = qkv(B, sq, sk, dtype)
            want, want_lse = ref.flash_attention(q, k, v, causal=False,
                                                 return_lse=True)
            tol_ = BF16_TOL if dtype == bf else FP32_TOL
            got, lse = fa.flash_attention(q, k, v, causal=False,
                                          return_lse=True)
            compare("flash_attention", case, (got,), (want,), tol_,
                    rel=dtype == bf)
            compare("flash_attention", case + " its lse", (lse,),
                    (want_lse,), FP32_TOL)
            compare("flash_attention", case + " no lse",
                    (fa.flash_attention(q, k, v, causal=False),), (want,),
                    tol_, rel=dtype == bf)
            if dtype == bf:
                _reading(readings, "flash_attention", case, "SDPA",
                         sdpa(q, k, v), want)
            del q, k, v, want, want_lse, got, lse
        # the backward at the cross shapes, both ways round
        for B, sq, sk, dtype in ((2, S_d, S_e, bf), (2, S_e, S_d, bf),
                                 (1, 200, 520, f32), (1, 520, 200, f32)):
            case = (f"flash backward B{B} Sq{sq} Sk{sk} H{H} hd{hd} "
                    f"non-causal {'bf16' if dtype == bf else 'fp32'}")
            ins = bwd_inputs(B, sq, sk, dtype)
            want = ref.ring_step_bwd(*ins, *acc_of(ins), hop(sq, sk),
                                     causal=False)
            compare("ring_step_bwd", case,
                    ra.ring_step_bwd(*ins, *acc_of(ins), hop(sq, sk),
                                     causal=False), want,
                    BF16_TOL if dtype == bf else FP32_TOL, rel=dtype == bf)
            if dtype == bf:
                ts = [t[0].transpose(1, 2).detach().requires_grad_()
                      for t in ins[:3]]
                sd = torch.autograd.grad(F.scaled_dot_product_attention(*ts),
                                         ts, ins[3][0].transpose(1, 2))
                _reading(readings, "ring_step_bwd", case, "SDPA",
                         tuple(t.transpose(1, 2)[None] for t in sd), want)
                del ts, sd
            del ins, want

    # ---- timings at whisper's shapes
    enc, cross = qkv(Bt, S_e, S_e), qkv(Bt, S_d, S_e)
    dec = qkv(Bs, 1, S_e)
    bq = bwd_inputs(Bt, S_d, S_e)
    bacc = acc_of(bq)
    bt = [t[0].transpose(1, 2).detach().requires_grad_() for t in bq[:3]]
    b_out = F.scaled_dot_product_attention(*bt)
    b_do = bq[3][0].transpose(1, 2)

    def fwd_bytes(B, sq, sk):
        return (2 * B * sq * H * hd + 2 * B * sk * H * hd) * el

    src = "src/repro_torch/kernels/csrc/"
    rows = {}
    for key, (B, sq, (q, k, v), what) in {
            "flash_attention whisper enc": (
                Bt, S_e, enc, "whisper-tiny's encoder self-attention"),
            "flash_attention whisper cross": (
                Bt, S_d, cross, "whisper-tiny's cross-attention, training"),
            "flash_attention whisper decode": (
                Bs, 1, dec, "whisper-tiny's decode-step cross-attention")
            }.items():
        sk = k.shape[1]
        rows[key] = dict(
            name="flash_attention", source=src + "flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:91",
            shape=f"B{B} Sq{sq} Sk{sk} H{H} hd{hd} non-causal bf16 ({what})",
            fn=functools.partial(fa.flash_attention, q, k, v, causal=False),
            plain=functools.partial(ref.flash_attention, q, k, v,
                                    causal=False),
            library=functools.partial(sdpa, q, k, v),
            kernels=("flash_fwd",), bytes=fwd_bytes(B, sq, sk),
            ops=[(4 * B * H * sq * sk * hd, bf16_peak)])
    rows["ring_step_bwd whisper cross"] = dict(
        name="ring_step_bwd", source=src + "ring_attention.cu",
        replaces="src/repro/kernels/ring_attention.py:169 (its VJP; no TPU "
                 "backward kernel)",
        shape=f"one rank B{Bt} Sq{S_d} Sk{S_e} H{H} hd{hd} non-causal bf16 "
              "(whisper-tiny's cross-attention backward), fp32 dq/dk/dv",
        fn=lambda: ra.ring_step_bwd(*bq, *bacc, hop(S_d, S_e), causal=False),
        plain=lambda: ref.ring_step_bwd(*bq, *bacc, hop(S_d, S_e),
                                        causal=False),
        library=lambda: torch.autograd.grad(b_out, bt, b_do,
                                            retain_graph=True),
        kernels=("ring_bwd",),
        # q, k, v, dO in, lse and delta, the gradients written once (the
        # one-rank VJP zero-fills them, so none is read)
        bytes=fwd_bytes(Bt, S_d, S_e) + 2 * Bt * S_d * H * f4
        + (Bt * S_d * H * hd + 2 * Bt * S_e * H * hd) * f4,
        ops=[(10 * Bt * H * S_d * S_e * hd, bf16_peak)],
        check=lambda: (ra.ring_step_bwd(*bq, *acc_of(bq), hop(S_d, S_e),
                                        causal=False),
                       ref.ring_step_bwd(*bq, *acc_of(bq), hop(S_d, S_e),
                                         causal=False)))
    timed = {}
    for kname, r in rows.items():
        if device_only:
            timed[kname] = _device_row(device_ms, r)
            continue
        # each row's error is its own, at the shape it is timed at
        got, want = (r["check"]() if "check" in r
                     else ((r["fn"](),), (r["plain"](),)))
        r["err"] = compare(r["name"], r["shape"], got, want, BF16_TOL,
                           rel=True)
        del got, want
        bytes_ms = r["bytes"] / bw * 1e3
        ops_ms = max(n / peak for n, peak in r["ops"]) * 1e3
        timed[kname] = {
            "name": r["name"], "line": True, "route": "cuda",
            "source": r["source"], "replaces": r["replaces"],
            "shape": r["shape"], "max_abs_err": r["err"],
            "ms": event_ms(r["fn"]),
            "plain_ms": event_ms(r["plain"], iters=3, warmup=1),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": event_ms(r["library"]),
        }
        t = timed[kname]
        log(f"[kernels] time {kname:15s} {r['shape']}: kernel {t['ms']:.4f} "
            f"ms, plain {t['plain_ms']:.4f} ms, library {t['library_ms']:.4f}"
            f" ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    del bq, bacc, bt, b_out, enc, cross, dec
    return checks, timed, {"rel_readings": readings}


def phase_vlm_kernels(torch, dev, name, device_only=False):
    """phi-3-vision-4.2b's attention: head dim 96 in the kernels' 128 tile,
    32 heads over 32 KV heads, causal, the image positions first.  Each
    row is held against its plain version at the shape it is timed at
    (bf16 at 2e-2 and REL_TOL by norm) and timed beside it and SDPA: the
    forward at the serve cell's longest prompt (576 image positions and
    max(VLM_PROMPTS) tokens), with lse at the training length
    VLM_TRAIN_SEQ, and its backward (the one-rank ring_step_bwd) there,
    whose plain version runs in groups of VLM_BWD_HEADS heads; fp32 at a
    small shape.  ``device_only``: as in phase_kernels."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import ring_attention as ra
    from repro_torch.models import registry
    from repro_torch.utils.timing import device_ms, event_ms

    bw, bf16_peak, _ = peaks(name)
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    checks = []
    bf, f32 = torch.bfloat16, torch.float32
    cfg = registry.get_config(VLM_ARCH)
    H, hd, el, f4 = cfg.n_heads, cfg.hd, 2, 4
    assert (H, cfg.n_kv_heads, hd) == (32, 32, 96), (H, cfg.n_kv_heads, hd)
    S_pf, S_tr, G = cfg.n_vision_tokens + max(VLM_PROMPTS), VLM_TRAIN_SEQ, \
        VLM_BWD_HEADS

    def randn(*shape, dtype=bf):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def compare(kernel, label, got, want, tol_, rel=False):
        err = _max_err(got, want)
        for g, w in zip(got, want):
            torch.testing.assert_close(g.float(), w.float(), **tol_)
        checks.append({"kernel": kernel, "case": label, "max_abs_err": err})
        msg = ""
        if rel:
            r = checks[-1]["rel_err"] = _rel_err(got, want)
            msg = f", rel_err {r:.3e} (limit {REL_TOL})"
            assert r <= REL_TOL, (kernel, label, r)
        log(f"[kernels] {kernel:15s} {label:42s} max_abs_err {err:.3e}"
            f"{msg} ok")
        return err

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            *(t.transpose(1, 2) for t in (q, k, v)),
            is_causal=True).transpose(1, 2)

    def qkv(S, heads=H, dtype=bf):
        return tuple(randn(1, S, heads, hd, dtype=dtype) for _ in range(3))

    if not device_only:
        qs, ks, vs = qkv(300, 4, f32)
        want, want_lse = ref.flash_attention(qs, ks, vs, return_lse=True)
        got, lse = fa.flash_attention(qs, ks, vs, return_lse=True)
        compare("flash_attention", "B1 S300 H4 hd96 causal fp32", (got, lse),
                (want, want_lse), FP32_TOL)
        del qs, ks, vs, want, want_lse, got, lse

    pf, tr = qkv(S_pf), qkv(S_tr)
    # the backward's inputs, a rank axis of 1, with o and lse from the
    # forward kernel as FlashAttentionFn saves them
    q_, k_, v_ = (t[None] for t in tr)
    do_ = randn(1, 1, S_tr, H, hd)
    with torch.no_grad():
        o_, lse_ = fa.flash_attention(*tr, return_lse=True)
    bq = (q_, k_, v_, do_, lse_[None],
          (do_.float() * o_[None].float()).sum(-1))
    del o_, lse_
    hop = [(0, 0, 0, S_tr, S_tr)]

    def zeros_of(ins):
        return (torch.zeros(ins[0].shape, device=dev),
                torch.zeros(ins[1].shape, device=dev),
                torch.zeros(ins[2].shape, device=dev))

    bacc = zeros_of(bq)

    def bwd_plain(acc=bacc):
        """The plain backward in groups of G heads (MHA: each group's q
        heads with their own K/V heads), into ``acc``."""
        for g_ in range(H // G):
            h_ = slice(G * g_, G * g_ + G)
            ref.ring_step_bwd(*(t[:, :, :, h_] for t in bq[:4]),
                              *(t[..., h_] for t in bq[4:]),
                              *(t[:, :, :, h_] for t in acc), hop)
        return acc

    bt = [t.transpose(1, 2).detach().requires_grad_() for t in tr]
    b_out = F.scaled_dot_product_attention(*bt, is_causal=True)
    b_do = do_[0].transpose(1, 2)
    pairs_pf, pairs_tr = S_pf * (S_pf + 1) // 2, S_tr * (S_tr + 1) // 2
    src = "src/repro_torch/kernels/csrc/"
    rows = {
        "flash_attention hd96": dict(
            name="flash_attention", source=src + "flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:91",
            shape=f"B1 S{S_pf} H{H} Hk{H} hd{hd} causal bf16 "
                  "(phi-3-vision-4.2b's longest prefill)",
            fn=functools.partial(fa.flash_attention, *pf),
            plain=functools.partial(ref.flash_attention, *pf),
            library=functools.partial(sdpa, *pf), kernels=("flash_fwd",),
            bytes=4 * S_pf * H * hd * el,
            ops=[(4 * pairs_pf * H * hd, bf16_peak)]),
        "flash_attention hd96 lse": dict(
            name="flash_attention", source=src + "flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:91",
            shape=f"B1 S{S_tr} H{H} Hk{H} hd{hd} causal bf16, with lse "
                  "(phi-3-vision-4.2b's training forward)",
            fn=functools.partial(fa.flash_attention, *tr, return_lse=True),
            plain=functools.partial(ref.flash_attention, *tr,
                                    return_lse=True),
            library=functools.partial(sdpa, *tr), kernels=("flash_fwd",),
            bytes=4 * S_tr * H * hd * el + S_tr * H * f4,
            ops=[(4 * pairs_tr * H * hd, bf16_peak)],
            check=lambda: (fa.flash_attention(*tr, return_lse=True),
                           ref.flash_attention(*tr, return_lse=True))),
        "ring_step_bwd hd96": dict(
            name="ring_step_bwd", source=src + "ring_attention.cu",
            replaces="src/repro/kernels/ring_attention.py:169 (its VJP; no "
                     "TPU backward kernel)",
            shape=f"one rank B1 S{S_tr} H{H} Hk{H} hd{hd} causal bf16 "
                  "(phi-3-vision-4.2b's flash backward), fp32 dq/dk/dv; "
                  f"plain in {H // G} groups of {G} heads",
            fn=lambda: ra.ring_step_bwd(*bq, *bacc, hop),
            plain=bwd_plain, kernels=("ring_bwd",),
            library=lambda: torch.autograd.grad(b_out, bt, b_do,
                                                retain_graph=True),
            # q, k, v, dO in, lse and delta, the gradients written once
            bytes=4 * S_tr * H * hd * el + 2 * S_tr * H * f4
            + 3 * S_tr * H * hd * f4,
            ops=[(10 * pairs_tr * H * hd, bf16_peak)],
            check=lambda: (ra.ring_step_bwd(*bq, *zeros_of(bq), hop),
                           bwd_plain(zeros_of(bq)))),
    }
    timed = {}
    for kname, r in rows.items():
        if device_only:
            timed[kname] = _device_row(device_ms, r)
            continue
        got, want = (r["check"]() if "check" in r
                     else ((r["fn"](),), (r["plain"](),)))
        err = compare(r["name"], r["shape"], got, want, BF16_TOL, rel=True)
        del got, want
        bytes_ms = r["bytes"] / bw * 1e3
        ops_ms = max(n / peak for n, peak in r["ops"]) * 1e3
        timed[kname] = {
            "name": r["name"], "line": True, "route": "cuda",
            "source": r["source"], "replaces": r["replaces"],
            "shape": r["shape"], "max_abs_err": err,
            "ms": event_ms(r["fn"]),
            "plain_ms": event_ms(r["plain"], iters=3, warmup=1),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": event_ms(r["library"]),
        }
        t = timed[kname]
        log(f"[kernels] time {kname:15s} {r['shape']}: kernel {t['ms']:.4f} "
            f"ms, plain {t['plain_ms']:.4f} ms, library {t['library_ms']:.4f}"
            f" ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    del pf, tr, bq, bacc, bt, b_out
    return checks, timed, {}


def _device_row(device_ms, r, per_call: int = 1) -> dict:
    """A timed row's profiler readings: its kernels' device time a launch,
    and its library call's (everything that call runs on the card)."""
    return {"device_ms": device_ms(r["fn"], r["kernels"]) / per_call,
            "library_device_ms": (device_ms(r["library"]) if r["library"]
                                  else None)}


def _max_err(got, want) -> float:
    """Max abs difference over a tensor or a tuple of tensors."""
    if isinstance(got, tuple):
        return max(_max_err(g, w) for g, w in zip(got, want))
    return (got.float() - want.float()).abs().max().item()


# ------------------------------------------------------------- phase 4 ---
def phase_model(torch, dev, arch):
    """SMOKE fp32: kernels on the card vs plain versions on the CPU."""
    from repro_torch.models import registry

    b = registry.get_bundle(arch, smoke=True, **(
        {"num_layers": MODEL_LAYERS[arch]} if arch in MODEL_LAYERS else {}))
    cfg = b.cfg
    p_cpu = b.init(cfg, seed=0, device="cpu")
    p_gpu = _tree(p_cpu, lambda t: t.to(dev))
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 37),
                                     generator=gen)}
    S = 37 + cfg.n_vision_tokens     # the VLM's image positions first
    if cfg.family == "encdec":       # the frontend stubs' embeddings
        batch["frames"] = torch.randn((2, 45, cfg.d_model), generator=gen)
    elif cfg.family == "vlm":
        batch["image_embeds"] = torch.randn(
            (2, cfg.n_vision_tokens, cfg.d_model), generator=gen)
    out = {}
    for tag, p, d in (("cpu", p_cpu, "cpu"), ("gpu", p_gpu, dev)):
        bd = {k: v.to(d) for k, v in batch.items()}
        logits, _ = b.forward(p, bd, cfg)
        last, cache = b.prefill(p, bd, cfg, S + 11)
        steps = []
        cache["pos"] = torch.tensor([S, S], device=d)  # per-row path
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
    log(f"[model] {arch} SMOKE ({cfg.num_layers} layers) fp32 card vs CPU: "
        f"forward, prefill, "
        f"{'/'.join(state)} cache, 4 decode steps max_abs_err {err:.3e} ok")
    return err


def _tree(node, fn):
    if isinstance(node, dict):
        return {k: _tree(v, fn) for k, v in node.items()}
    if isinstance(node, list):      # the hybrid stack's tail
        return [_tree(v, fn) for v in node]
    return fn(node)


# ------------------------------------------------------------- phase 5 ---
def phase_serve(torch, dev, arch):
    """One serve cell of SERVE_CELLS at full width and depth: the engine's
    exact launch counts, first tokens equal decode_sequential's, finite
    logits, the report; an SWA arch also the SWA check."""
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.serve import ServeEngine, decode_sequential, scripted_trace

    # the previous path's weights and caches are gone: each path reports
    # its own peak
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = registry.get_config(arch, **(
        {"num_layers": SERVE_LAYERS[arch]} if arch in SERVE_LAYERS else {}))
    base = registry.bundle_for(cfg)
    t0 = time.perf_counter()
    params = base.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[serve] {arch} init {n_params / 1e9:.3f} B params on {dev} in "
        f"{init_s:.1f} s")

    prompt_lens, max_len, seq_tokens = SERVE_CELLS[arch]
    reqs = scripted_trace(16, vocab_size=cfg.vocab_size, seed=0,
                          prompt_lens=prompt_lens,
                          gen_lens=(16, 32, 64), arrival_every=1)
    # the timed engine runs the plain bundle, its decode steps' launches
    # counted apart (two reads of the counters a step); the logits are
    # checked for finiteness on the untimed decode_sequential pass below
    decode_launches = dict.fromkeys(ops.LAUNCH_COUNTERS, 0)

    def counted_decode(*a):
        before = ops.launch_counts()
        out = base.decode_step(*a)
        for kname, n in ops.launch_counts().items():
            decode_launches[kname] += n - before[kname]
        return out

    eng = ServeEngine(dataclasses.replace(base, decode_step=counted_decode),
                      params, max_batch=8, max_len=max_len, device=dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    report = eng.run(reqs)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()

    comps = {c.rid: c for c in report.completions}
    assert sorted(comps) == [r.rid for r in reqs], "requests lost"
    for r in reqs:
        assert len(comps[r.rid].tokens) == r.max_new_tokens, r.rid
    steps = len(reqs) + report.decode_steps      # prefills + decode steps
    L = cfg.num_layers
    expect = dict.fromkeys(launches, 0)
    if cfg.family == "ssm":   # {ln1, ssm} blocks; the scan in prefill only
        per_step, sg_step = L + 1, 0
        expect.update(rmsnorm=per_step * steps, ssm_scan=L * len(reqs))
    else:
        # ln1, ln2 (and qk_norm's q_norm, k_norm) a layer, the final norm;
        # the swiglu kernel only for swiglu MLPs (nemotron's squared ReLU
        # is plain torch, as in the JAX package); flash in prefills only
        # (a hybrid stack: ln1, ln2 a block of either kind; flash in its
        # attn blocks)
        per_step = (2 + 2 * cfg.qk_norm) * L + 1
        sg_step = L if cfg.act == "swiglu" else 0
        expect.update(rmsnorm=per_step * steps, swiglu=sg_step * steps,
                      flash_attention=cfg.layer_kinds().count("attn")
                      * len(reqs))
    log(f"[serve] {arch} launches {launches} expected {expect}")
    assert launches == expect, (launches, expect)
    log(f"[serve] {arch} rmsnorm / swiglu launches in decode steps "
        f"{decode_launches['rmsnorm']} / {decode_launches['swiglu']} "
        f"expected {per_step * report.decode_steps} / "
        f"{sg_step * report.decode_steps}")
    assert decode_launches["rmsnorm"] == per_step * report.decode_steps
    assert decode_launches["swiglu"] == sg_step * report.decode_steps

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
    seq_reqs = reqs if seq_tokens is None else [
        dataclasses.replace(r, max_new_tokens=min(r.max_new_tokens,
                                                  seq_tokens))
        for r in reqs]
    seq = decode_sequential(checked, params, seq_reqs, max_len=max_len,
                            device=dev)
    first_equal = all(comps[r.rid].tokens[0] == seq[r.rid][0] for r in reqs)
    agree = sum(a == b for r in reqs
                for a, b in zip(comps[r.rid].tokens[1:], seq[r.rid][1:]))
    n_dec = sum(len(seq[r.rid]) - 1 for r in reqs)
    full_equal = sum(comps[r.rid].tokens[:len(seq[r.rid])] == seq[r.rid]
                     for r in reqs)
    log(f"[serve] {arch} first tokens equal decode_sequential: "
        f"{first_equal}; "
        f"decode tokens agreeing at their position: {agree}/{n_dec}; "
        f"streams fully equal: {full_equal}/{len(reqs)}")
    assert first_equal, "first tokens differ from decode_sequential"
    swa = phase_swa(torch, dev, base, params) if arch in SWA_CHECKS else None

    # the same statistics (mean, median, max over requests) as the CLI's
    summary = {
        "arch": arch, "layers": L, "params": n_params,
        **report.to_dict(), "prefills": len(reqs), "wall_s": wall,
        "init_s": init_s, "launches": launches, "expected_launches": expect,
        "decode_launches": decode_launches,
        "decode_agree": [agree, n_dec], "streams_equal": [full_equal,
                                                          len(reqs)],
        "sequential_tokens": seq_tokens, "max_len": max_len,
        "prompt_lens": list(prompt_lens), "swa": swa,
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
    }
    log(f"[serve] {arch} report {json.dumps(summary)}")
    return summary, launches


def phase_swa(torch, dev, b, params):
    """An SWA arch at full width (SWA_CHECKS: its prompt, max_len and the
    depth of its fp32 check): one request's prefill of the prompt (past
    the window, so the rolling buffer holds positions S - Sw .. S - 1 at
    their index mod Sw) and SWA_STEPS decode steps, each step's logits
    against lm_forward over the whole sequence so far (the flash kernel's
    window band) at its last position, by norm: in bf16 within
    SWA_REL_TOL, the distance between two bf16 routes; then the same
    weights (recurrentgemma-9b: its first group and its tail, 5 layers)
    in fp32 within SWA_FP32_TOL.  A control decodes from JAX's
    front-written buffer layout (a hybrid's recurrent state as the
    prefill left it).  With random weights attention is near uniform over
    the window's keys, so the key or two such a fault misplaces a step
    moves the logits by about the bf16 distance; in fp32 the control must
    read above the limit."""
    cfg = b.cfg
    S, max_len, fp32_layers, bf16_tol = SWA_CHECKS[cfg.name]
    n = SWA_STEPS
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (1, S + n),
                           generator=gen).to(dev)

    def check(b_, params_):
        """(rel err, max abs err, the control's rel err) of b_'s steps."""
        full, _ = b_.forward(params_, {"tokens": tokens}, b_.cfg)
        want = full[0, S - 1:].clone()
        del full

        def decode_from(last, cache):
            got = [last[0]]
            for t in range(n):
                lg, cache = b_.decode_step(
                    params_, tokens[:, S + t:S + t + 1], cache, b_.cfg)
                got.append(lg[0])
            return torch.stack(got)

        last, cache = b_.prefill(params_, {"tokens": tokens[:, :S]}, b_.cfg,
                                 max_len)
        Sw = cache["kv"]["k"].shape[2]
        # JAX's layout: the kept positions S - Sw .. S - 1 at the front
        front = {"pos": torch.tensor(S, device=dev),
                 "kv": {k: torch.roll(v, -(S % Sw), dims=2)
                        for k, v in cache["kv"].items()}}
        if "rec" in cache:
            front["rec"] = _tree(cache["rec"], lambda t: t.clone())
        got = decode_from(last, cache)
        ctl = decode_from(last, front)
        return (_rel_err(got, want), _max_err(got, want),
                _rel_err(ctl, want), Sw)

    def cut(b_, params_, layers):
        """The first whole groups and the tail: ``layers`` layers."""
        g = (layers - len(params_["tail"])) // len(cfg.block_pattern)
        return (dataclasses.replace(b_, cfg=dataclasses.replace(
                    b_.cfg, num_layers=layers)),
                dict(params_, groups=_tree(params_["groups"],
                                           lambda t: t[:g])))

    rel, err, ctl, Sw = check(b, params)
    by_depth = {}
    if fp32_layers:     # the bf16 distance at the cut depths
        for layers in SWA_DEPTHS:
            by_depth[layers] = check(*cut(b, params, layers))[0]
        by_depth[cfg.num_layers] = rel
        log(f"[serve] {cfg.name} SWA bf16 rel_err by depth: " + ", ".join(
            f"{k} layers {v:.3e}" for k, v in by_depth.items()))
    b32 = dataclasses.replace(b, cfg=dataclasses.replace(
        cfg, param_dtype="float32", dtype="float32"))
    p32 = params
    if fp32_layers:
        b32, p32 = cut(b32, params, fp32_layers)
    cfg32 = b32.cfg
    p32 = _tree(p32, lambda t: t.float())
    rel32, err32, ctl32, _ = check(b32, p32)
    del p32
    log(f"[serve] {cfg.name} SWA: prefill S{S} (window {cfg.window}, "
        f"buffer {Sw}) + {n} decode steps vs lm_forward: bf16 rel_err "
        f"{rel:.3e} (limit {bf16_tol}), max_abs_err {err:.3e}, control "
        f"(JAX's front layout) {ctl:.3e}; fp32 ({cfg32.num_layers} layers) "
        f"rel_err {rel32:.3e} (limit {SWA_FP32_TOL}), max_abs_err "
        f"{err32:.3e}, control {ctl32:.3e}")
    assert rel <= bf16_tol, (rel, bf16_tol)
    assert rel32 <= SWA_FP32_TOL, (rel32, SWA_FP32_TOL)
    assert ctl32 > SWA_FP32_TOL, ("the control reads inside the limit",
                                  ctl32)
    return {"prompt": S, "steps": n, "buffer": Sw, "rel_err": rel,
            "max_abs_err": err, "control_rel_err": ctl,
            "bf16_limit": bf16_tol, "bf16_rel_err_by_depth": by_depth,
            "fp32_layers": cfg32.num_layers,
            "fp32_rel_err": rel32, "fp32_max_abs_err": err32,
            "fp32_control_rel_err": ctl32}


def _encdec_counts(cfg, encodes: int, decoder_passes: int,
                   decode_steps: int, bwd_steps: int = 0,
                   remat: bool = True) -> tuple:
    """whisper-tiny's exact launches, and its flash launches by row: over
    ``encodes`` encoder passes and as many decoder passes over a whole
    sequence (a prefill or a training forward), ``decode_steps`` decode
    steps (one token each row) and ``bwd_steps`` training steps, whose
    forwards run under remat (``remat``: each layer's forward kernels
    twice).  A pass: the encoder's two norms and flash a layer and its
    final norm; the decoder's three norms, causal flash and cross flash a
    layer and its final norm; a decode step: the decoder's norms, its
    cross flash (the self-attention reads the cache in plain torch).  The
    rows (phase_encdec_kernels): the encoder's flash, the cross flash at
    Sq > 1, the decode step's at Sq 1, the cross backward; the decoder's
    causal flash and the other backwards stay in the general rows."""
    Le, L = cfg.n_encoder_layers, cfg.num_layers
    f = 2 if remat and bwd_steps else 1
    launches = {
        "rmsnorm": f * 2 * Le * encodes + encodes
        + (f * 3 * L + 1) * decoder_passes + (3 * L + 1) * decode_steps,
        "flash_attention": f * Le * encodes + f * 2 * L * decoder_passes
        + L * decode_steps}
    rows = {"flash_attention whisper enc": f * Le * encodes,
            "flash_attention whisper cross": f * L * decoder_passes,
            "flash_attention whisper decode": L * decode_steps,
            "ring_step_bwd whisper cross": L * bwd_steps}
    if bwd_steps:
        launches.update(rmsnorm_bwd=(2 * Le + 1 + 3 * L + 1) * bwd_steps,
                        ring_step_bwd=(Le + 2 * L) * bwd_steps)
    return launches, rows


def phase_serve_encdec(torch, dev, smi: str):
    """whisper-tiny at full width and depth, served as the JAX package
    serves it: the bundle's prefill (the encoder over ED_S_ENC frames,
    then the decoder over an ED_PROMPT-token prompt) and ED_NEW - 1 greedy
    decode steps over a batch of ED_SERVE_B rows, with ``max_len``
    ED_MAX_LEN; each decode step's cross-attention is the flash kernel at
    Sq 1.  Exact launch counts, finite logits, then each row alone at
    batch 1 for ED_SEQ_TOKENS tokens: its first token must equal the
    batch's.  The encode + prefill time, the decode step time and the
    peak memory."""
    from repro_torch.kernels import ops
    from repro_torch.models import registry

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    b = registry.get_bundle(ED_ARCH)
    cfg = b.cfg
    params = b.init(cfg, seed=0, device=dev)
    n_params = sum(t.numel() for t in _leaves(params))
    gen = torch.Generator(device=dev).manual_seed(5)
    frames = torch.randn((ED_SERVE_B, ED_S_ENC, cfg.d_model), generator=gen,
                         device=dev).to(cfg.adtype)
    prompt = torch.randint(0, cfg.vocab_size, (ED_SERVE_B, ED_PROMPT),
                           generator=gen, device=dev)

    def greedy(f, p, n):
        """(the n greedy tokens (B, n), the prefill's seconds, each decode
        step's seconds)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = b.prefill(params, {"frames": f, "tokens": p}, cfg,
                                  ED_MAX_LEN)
        assert bool(torch.isfinite(logits).all()), "non-finite prefill"
        tok = torch.argmax(logits, -1, keepdim=True)
        pre = time.perf_counter() - t0
        toks, step_s = [tok], []
        for _ in range(n - 1):
            t0 = time.perf_counter()
            logits, cache = b.decode_step(params, tok, cache, cfg)
            tok = torch.argmax(logits, -1, keepdim=True)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            toks.append(tok)
            assert bool(torch.isfinite(logits).all()), "non-finite decode"
        return torch.cat(toks, 1), pre, step_s

    with torch.no_grad():
        greedy(frames, prompt, 3)       # warm-up: cuBLAS handles, kernels
        ops.reset_launch_counts()
        toks, pre_s, step_s = greedy(frames, prompt, ED_NEW)
        launches = ops.launch_counts()
        alone = [greedy(frames[r:r + 1], prompt[r:r + 1], ED_SEQ_TOKENS)[0]
                 for r in range(ED_SERVE_B)]
        all_launches = ops.launch_counts()
    expect = dict.fromkeys(launches, 0)
    counts, _ = _encdec_counts(cfg, 1, 1, ED_NEW - 1)
    expect.update(counts)
    log(f"[serve] {ED_ARCH} launches {launches} expected {expect}")
    assert launches == expect, (launches, expect)
    total = dict.fromkeys(launches, 0)
    counts, rows = _encdec_counts(cfg, 1 + ED_SERVE_B, 1 + ED_SERVE_B,
                                  ED_NEW - 1 + ED_SERVE_B
                                  * (ED_SEQ_TOKENS - 1))
    total.update(counts)
    assert all_launches == total, (all_launches, total)
    first_equal = all(int(a[0, 0]) == int(toks[r, 0])
                      for r, a in enumerate(alone))
    agree = sum(int((a[0] == toks[r, :ED_SEQ_TOKENS]).sum())
                for r, a in enumerate(alone))
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    dec_ms = 1e3 * sum(step_s) / len(step_s)
    log(f"[serve] {ED_ARCH} on {smi}: B{ED_SERVE_B} frames {ED_S_ENC}, "
        f"prompt {ED_PROMPT}, {ED_NEW} new tokens, max_len {ED_MAX_LEN}: "
        f"encode + prefill {1e3 * pre_s:.3f} ms, decode step {dec_ms:.4f} "
        f"ms (median {1e3 * sorted(step_s)[len(step_s) // 2]:.4f}), "
        f"{ED_SERVE_B * (ED_NEW - 1) / sum(step_s):.1f} decoded tok/s, "
        f"peak {peak:.3f} GB; first tokens equal batch 1: {first_equal}; "
        f"tokens agreeing over the first {ED_SEQ_TOKENS}: "
        f"{agree}/{ED_SERVE_B * ED_SEQ_TOKENS}")
    assert first_equal, "first tokens differ from batch-1 passes"
    n_steps = ED_NEW - 1 + ED_SERVE_B * (ED_SEQ_TOKENS - 1)
    summary = {"arch": ED_ARCH, "params": n_params, "batch": ED_SERVE_B,
               "decode_launches": {
                   "rmsnorm": (3 * cfg.num_layers + 1) * n_steps,
                   "swiglu": 0},
               "s_enc": ED_S_ENC, "prompt": ED_PROMPT, "new": ED_NEW,
               "max_len": ED_MAX_LEN, "prefill_ms": 1e3 * pre_s,
               "decode_step_ms": dec_ms,
               "decode_step_ms_all": [1e3 * x for x in step_s],
               "first_equal": first_equal,
               "agree": [agree, ED_SERVE_B * ED_SEQ_TOKENS],
               "launches": launches, "expected_launches": expect,
               "peak_mem_gb": peak}
    del params, frames
    return summary, all_launches, rows


def phase_train_encdec(torch, dev, smi: str):
    """whisper-tiny at full width and depth on the reference route, bf16:
    TRAIN_STEPS steps of ED_TRAIN_B sequences of ED_S_ENC frames and
    ED_TRAIN_DEC decoder tokens (its own batches: the synthetic pipeline
    gives the encoder and the decoder one length), exact launch counts
    (each layer's forward kernels twice under remat: the cross-attention
    through the flash kernel at Sq ED_TRAIN_DEC against ED_S_ENC, its
    backward through ring_step_bwd at the negative-offset hop), step 0's
    loss held to a forward of the same weights and batch."""
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.train import steps

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    b = registry.get_bundle(ED_ARCH)
    cfg = b.cfg
    state = steps.init_train_state(b, seed=0, device=dev)
    step = steps.make_train_step(b)
    gen = torch.Generator(device=dev).manual_seed(7)

    def batch():
        toks = torch.randint(0, cfg.vocab_size, (ED_TRAIN_B,
                                                 ED_TRAIN_DEC + 1),
                             generator=gen, device=dev)
        return {"frames": torch.randn((ED_TRAIN_B, ED_S_ENC, cfg.d_model),
                                      generator=gen, device=dev).to(
                                          cfg.adtype),
                "tokens": toks[:, :-1], "labels": toks[:, 1:]}

    batches = [batch() for _ in range(TRAIN_STEPS)]
    with torch.no_grad():
        loss0 = float(steps.make_loss_fn(b)(state["params"], batches[0])[0])
    ops.reset_launch_counts()
    losses, step_s = [], []
    for bt in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, bt)
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t0)
    launches = ops.launch_counts()
    expect = dict.fromkeys(launches, 0)
    counts, rows = _encdec_counts(cfg, TRAIN_STEPS, TRAIN_STEPS, 0,
                                  TRAIN_STEPS)
    expect.update(counts)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"[train] {ED_ARCH} reference route on {smi}: B{ED_TRAIN_B} frames "
        f"{ED_S_ENC} decoder {ED_TRAIN_DEC}: losses {losses}, step s "
        f"{step_s}, peak {peak:.3f} GB; step-0 loss vs the forward's "
        f"{loss0}: diff {abs(losses[0] - loss0):.3e} (tol {TRAIN_LOSS_TOL})")
    log(f"[train] {ED_ARCH} launches {launches} expected {expect}")
    assert all(map(math.isfinite, losses)), losses
    assert launches == expect, (launches, expect)
    assert abs(losses[0] - loss0) < TRAIN_LOSS_TOL, (losses, loss0)
    n_tok = ED_TRAIN_B * ED_TRAIN_DEC
    summary = {"arch": ED_ARCH, "route": "reference", "batch": ED_TRAIN_B,
               "s_enc": ED_S_ENC, "s_dec": ED_TRAIN_DEC, "losses": losses,
               "forward_loss_step0": loss0, "step_s": step_s,
               "dec_tok_s_steady": n_tok * (len(step_s) - 1)
               / sum(step_s[1:]), "peak_mem_gb": peak,
               "launches": launches, "expected_launches": expect}
    del state, batches
    return summary, launches, rows


def phase_serve_vlm(torch, dev, smi: str):
    """phi-3-vision-4.2b at full width and VLM_LAYERS layers, bf16,
    driven through the bundle (the engine refuses the family): VLM_REQS
    requests, each its image positions (random embeddings from a
    seed, the CLIP stub's output) ahead of a text prompt of VLM_PROMPTS
    tokens, generating VLM_GENS tokens greedily, one request at a time at
    batch 1.  TTFT is a request's prefill and first sample, TPOT the mean
    of its decode steps; exact launch counts (the image positions through
    the causal flash band of every layer's prefill), finite logits."""
    from repro_torch.kernels import ops
    from repro_torch.models import registry

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    b = registry.get_bundle(VLM_ARCH, num_layers=VLM_LAYERS)
    cfg = b.cfg
    t0 = time.perf_counter()
    params = b.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    n_img = cfg.n_vision_tokens
    gen = torch.Generator(device=dev).manual_seed(8)
    reqs = [(VLM_PROMPTS[i % len(VLM_PROMPTS)], VLM_GENS[i % len(VLM_GENS)])
            for i in range(VLM_REQS)]

    def one(n_text, n_new):
        img = torch.randn((1, n_img, cfg.d_model), generator=gen,
                          device=dev).to(cfg.adtype)
        toks = torch.randint(0, cfg.vocab_size, (1, n_text), generator=gen,
                             device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = b.prefill(params, {"image_embeds": img,
                                           "tokens": toks}, cfg,
                                  n_img + n_text + n_new)
        tok = torch.argmax(logits, -1, keepdim=True)
        ok = bool(torch.isfinite(logits).all())
        ttft = time.perf_counter() - t0
        assert int(cache["pos"]) == n_img + n_text
        step_s = []
        for _ in range(n_new - 1):
            t0 = time.perf_counter()
            logits, cache = b.decode_step(params, tok, cache, cfg)
            tok = torch.argmax(logits, -1, keepdim=True)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            ok = ok and bool(torch.isfinite(logits).all())
        assert ok, "non-finite logits"
        return ttft, step_s

    with torch.no_grad():
        one(64, 2)                  # warm-up
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = [one(n, g) for n, g in reqs]
        wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    L = cfg.num_layers
    n_dec = sum(g - 1 for _, g in reqs)
    expect = dict.fromkeys(launches, 0)
    expect.update(rmsnorm=(2 * L + 1) * (len(reqs) + n_dec),
                  swiglu=L * (len(reqs) + n_dec),
                  flash_attention=L * len(reqs))
    log(f"[serve] {VLM_ARCH} launches {launches} expected {expect}")
    assert launches == expect, (launches, expect)
    ttft = [t for t, _ in out]
    tpot = [sum(s) / len(s) for _, s in out]
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"[serve] {VLM_ARCH} ({L} layers, {n_params / 1e9:.3f} B params) on "
        f"{smi}: {len(reqs)} requests of {n_img} image positions + "
        f"{VLM_PROMPTS} text tokens, {VLM_GENS} new: TTFT s mean "
        f"{sum(ttft) / len(ttft):.4f} max {max(ttft):.4f} (limit "
        f"{TTFT_LIMIT_S}), TPOT s mean {sum(tpot) / len(tpot):.5f} max "
        f"{max(tpot):.5f} (limit {TPOT_LIMIT_S}), peak {peak:.3f} GB, "
        f"wall {wall:.2f} s")
    summary = {"arch": VLM_ARCH, "layers": L, "params": n_params,
               "requests": reqs, "image_positions": n_img,
               "ttft_s": ttft, "tpot_s": tpot, "init_s": init_s,
               "ttft_limit_s": TTFT_LIMIT_S, "tpot_limit_s": TPOT_LIMIT_S,
               "decode_launches": {"rmsnorm": (2 * L + 1) * n_dec,
                                   "swiglu": L * n_dec},
               "peak_mem_gb": peak, "wall_s": wall, "launches": launches,
               "expected_launches": expect}
    del params
    return summary, launches


def phase_train_vlm(torch, dev, smi: str):
    """phi-3-vision-4.2b on the reference route at full width and
    VLM_LAYERS layers, VLM_TRAIN_SEQ positions (576 of them image
    embeddings), bf16 (phase_train: exact launches, step 0 held to the
    forward)."""
    return phase_train(torch, dev, "reference", arch=VLM_ARCH,
                       seq=VLM_TRAIN_SEQ, layers=VLM_LAYERS,
                       hold_loss0=True)


def phase_train_vlm_pp(torch, dev, smi: str):
    """phi-3-vision-4.2b at full width and VLM_PP_LAYERS layers through a
    one-process pp 2 plan (VLM_PP_BATCH sequences of VLM_PP_SEQ positions,
    one microbatch each): stage 0 prepends each microbatch's image
    embeddings; exact launch counts, step 0's loss against the reference
    loss on the same microbatches."""
    from repro_torch.core.plan import ParallelPlan, StagePlacement
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.train import steps
    from repro_torch.train.trainer import Trainer, TrainerConfig

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    half = VLM_PP_LAYERS // 2
    b = registry.get_bundle(VLM_ARCH, num_layers=VLM_PP_LAYERS)
    plan = ParallelPlan(stages=(StagePlacement(0, half, 1, 1),
                                StagePlacement(1, half, 1, 1, True)),
                        micro_bs=1, global_batch=VLM_PP_BATCH,
                        seq_len=VLM_PP_SEQ)
    t = Trainer(b, TrainerConfig(global_batch=VLM_PP_BATCH,
                                 seq_len=VLM_PP_SEQ), plan=plan, device=dev)
    assert t._pipeline_active()
    m = plan.micro_batches
    batch = t._device_batch(t.data.batch_at(t.step))
    assert batch["image_embeds"].shape[:3] == (m, 1,
                                               b.cfg.n_vision_tokens)
    with torch.no_grad():
        ref = sum(float(steps.make_loss_fn(b)(
            t.state["params"], {k: v[j] for k, v in batch.items()})[0])
            for j in range(m)) / m
    del batch
    ops.reset_launch_counts()
    out = t.run(TRAIN_STEPS)
    launches = ops.launch_counts()
    expect = dict.fromkeys(launches, 0)
    expect.update(_pp_launches(m, VLM_PP_LAYERS, TRAIN_STEPS))
    losses = out["losses"]
    log(f"[train] {VLM_ARCH} pp 2 ({VLM_PP_LAYERS} layers, S {VLM_PP_SEQ}) "
        f"on {smi}: losses {losses}, step s {out['step_s']}; step-0 loss vs "
        f"reference {ref}: diff {abs(losses[0] - ref):.3e} (tol "
        f"{TRAIN_LOSS_TOL})")
    log(f"[train] {VLM_ARCH} pp launches {launches} expected {expect}")
    assert all(map(math.isfinite, losses)), losses
    assert launches == expect, (launches, expect)
    assert abs(losses[0] - ref) < TRAIN_LOSS_TOL, (losses[0], ref)
    summary = {"route": "pp", "arch": VLM_ARCH, "layers": VLM_PP_LAYERS,
               "seq": VLM_PP_SEQ, "global_batch": VLM_PP_BATCH,
               "losses": losses, "reference_loss_step0": ref,
               "step_s": out["step_s"],
               "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
               "launches": launches, "expected_launches": expect,
               "plan": plan.describe()}
    del t
    return summary, launches


def phase_serve_cli(torch):
    """The serve CLI with --plan --metrics-out --prom-out at full width on
    this card, in a child process; its artifacts through
    tools/validate_serve.py.  Returns its summary."""
    gc.collect()
    torch.cuda.empty_cache()
    d = Path(tempfile.mkdtemp(prefix="repro-serve-"))
    try:
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
               SERVE_CLI_ARCH, "--plan", "--metrics-out",
               str(d / "metrics.jsonl"), "--prom-out", str(d / "m.prom")]
        env = dict(os.environ, PYTHONPATH=str(SRC), TMPDIR=str(d))
        t0 = time.perf_counter()
        r = subprocess.run(cmd, env=env, cwd=str(ROOT), capture_output=True,
                           text=True, timeout=600)
        wall = time.perf_counter() - t0
        (d / "run.log").write_text(r.stdout)
        if r.returncode != 0:
            raise RuntimeError(f"the serve CLI exited {r.returncode}:\n"
                               f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
        lines = r.stdout.strip().splitlines()
        summary = json.loads(lines[-1])
        assert lines[0].startswith("serving plan: "), lines[0]
        assert summary["run_id"] and "plan" in summary, summary
        assert summary["device"].startswith("cuda"), summary["device"]
        assert summary["kernel_launches"]["flash_attention"] > 0
        out = _validate("validate_serve.py", "--metrics",
                        str(d / "metrics.jsonl"), "--run-log",
                        str(d / "run.log"))
        prom = (d / "m.prom").read_text()
        assert "serve_tpot_s_count" in prom, prom[:500]
        log(f"[serve-cli] {SERVE_CLI_ARCH} {lines[0]}")
        log(f"[serve-cli] run_id {summary['run_id']} replans "
            f"{summary['replans']} occupancy {summary['occupancy']} "
            f"launches {summary['kernel_launches']} in {wall:.1f} s; "
            f"validate_serve.py: {out}")
        summary["wall_s"] = wall
        return summary
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _cp_plan(chunks, global_batch: int, n_layers: int):
    """A one-stage plan whose cp ring ranks take ``chunks``."""
    from repro_torch.core.plan import ParallelPlan, StagePlacement
    cp = len(chunks)
    return ParallelPlan(stages=(StagePlacement(0, n_layers, cp, 1, True),),
                        micro_bs=1, global_batch=global_batch,
                        seq_len=sum(chunks), cp=cp, cp_chunks=tuple(chunks))


# ------------------------------------------------------------- phase 6 ---
def _vpp_plan(chunk_layers, global_batch: int, seq_len: int):
    """A two-stage interleaved plan (vpp 2) whose virtual stages take
    ``chunk_layers``, one sequence a microbatch."""
    from repro_torch.core.plan import ParallelPlan, StagePlacement
    pp = PP_STAGES
    n = [sum(chunk_layers[c * pp + s] for c in range(2)) for s in range(pp)]
    return ParallelPlan(stages=(StagePlacement(0, n[0], 1, 1),
                                StagePlacement(1, n[1], 1, 1, True)),
                        micro_bs=1, global_batch=global_batch,
                        seq_len=seq_len, schedule="interleaved-1f1b", vpp=2,
                        chunk_layers=tuple(chunk_layers))


def phase_train_parity(torch, dev):
    """SMOKE fp32: 3 Trainer steps with the kernels on the card against 3
    with the plain versions on the CPU, from one state, on each route: cp,
    reference, and the pipeline over an interleaved plan with a zero-layer
    chunk (4 SMOKE layers, 4 microbatches)."""
    from repro_torch.models import registry
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.steps import init_train_state
    from repro_torch.train.trainer import Trainer, TrainerConfig

    b = registry.get_bundle("llama3-8b", smoke=True)
    b4 = registry.get_bundle("llama3-8b", smoke=True,
                             num_layers=sum(SMOKE_VPP_LAYERS))
    seq = sum(SMOKE_CP_CHUNKS)
    cfg = TrainerConfig(global_batch=2, seq_len=seq)
    opt = AdamWConfig(lr=1e-2, warmup_steps=2)
    out = {}
    for route, bundle, plan, tcfg in (
            ("cp", b, _cp_plan(SMOKE_CP_CHUNKS, 2, b.cfg.num_layers), cfg),
            ("reference", b, None, cfg),
            ("pp vpp 2", b4, _vpp_plan(SMOKE_VPP_LAYERS, PP_BATCH, seq),
             TrainerConfig(global_batch=PP_BATCH, seq_len=seq))):
        state = init_train_state(bundle, seed=0, device="cpu")
        losses = {}
        for d in ("cpu", dev):
            t = Trainer(bundle, tcfg, plan=plan, opt_cfg=opt, state=state,
                        device=d)
            assert t._cp_active() == (route == "cp")
            assert t._pipeline_active() == route.startswith("pp")
            losses[str(d)] = t.run(TRAIN_STEPS)["losses"]
        cpu, gpu = losses["cpu"], losses[str(dev)]
        err = max(abs(a - g) for a, g in zip(cpu, gpu))
        torch.testing.assert_close(torch.tensor(gpu), torch.tensor(cpu),
                                   **MODEL_TOL)
        log(f"[train] SMOKE fp32 {route} route, card vs CPU losses "
            f"{gpu} / {cpu}: max diff {err:.3e} ok")
        out[route] = {"card": gpu, "cpu": cpu, "max_abs_err": err}
    return out


def phase_train(torch, dev, route: str, global_batch: int = 1,
                moves: bool = False, arch: str = "llama3-8b",
                seq: int = TRAIN_SEQ, remat: bool = True,
                layers: int = TRAIN_LAYERS, chunks=None,
                hold_loss0: bool = False):
    """``arch`` at full width, ``layers`` layers, bf16: TRAIN_STEPS
    steps of one route at ``global_batch`` sequences of ``seq`` with exact
    launch counts (a batched kernel launches once whatever the batch;
    under remat each block's forward twice); its own peak memory; with
    ``moves``, each leaf's squared master move after every step
    (``rank_programs.run_steps``); ``remat`` False: the blocks' activations
    kept (each kernel once a pass), the route's cost before remat;
    ``chunks``: the cp route's (default CP_CHUNKS); ``hold_loss0``: step
    0's loss held to the loss of a forward of the same weights on the same
    batch (the CE plus AUX_COEF times the MoE aux, which is printed)."""
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.parallel.rank_programs import run_steps
    from repro_torch.train import steps
    from repro_torch.train.trainer import Trainer, TrainerConfig

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    b = registry.get_bundle(arch, num_layers=layers, remat=remat)
    chunks = chunks or CP_CHUNKS
    plan = _cp_plan(chunks, 1, layers) if route == "cp" else None
    t0 = time.perf_counter()
    t = Trainer(b, TrainerConfig(global_batch=global_batch,
                                 seq_len=seq), plan=plan, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    assert t._cp_active() == (route == "cp")
    route = route if global_batch == 1 else f"{route} b{global_batch}"
    if arch != "llama3-8b":
        route = f"{arch} {route}"
    if not remat:
        route = f"{route} no-remat"
    if layers != TRAIN_LAYERS:
        route = f"{route} {layers}-layer"
    n_params = sum(x.numel() for x in tree_leaves(t.state["params"]))
    state_gb = torch.cuda.memory_allocated(dev) / 1e9
    log(f"[train] {route} route: {arch} {layers} layers, seq {seq}, "
        f"{n_params / 1e9:.3f} B params, train state {state_gb:.2f} GB, "
        f"init {init_s:.1f} s")
    fwd0 = None
    if hold_loss0:      # the forward of step 0's weights and batch
        batch = t._device_batch(t.data.batch_at(t.step))
        with torch.no_grad():
            loss0, met0 = steps.make_loss_fn(b)(t.state["params"], batch)
        fwd0 = {k: float(v) for k, v in dict(met0, loss=loss0).items()}
        del batch, loss0, met0
        log(f"[train] {route} forward of step 0's weights and batch: "
            f"loss {fwd0['loss']} = CE {fwd0['ce']} + {steps.AUX_COEF} x "
            f"aux {fwd0['aux']}")
    ops.reset_launch_counts()
    out, moved = run_steps(t, TRAIN_STEPS, moves)
    launches = ops.launch_counts()
    L, cp, n = layers, len(chunks), TRAIN_STEPS
    expect = dict.fromkeys(launches, 0)
    expect.update(_ssm_launches(L, n) if b.cfg.family == "ssm" else
                  _hybrid_launches(b.cfg, n, remat)
                  if b.cfg.family == "hybrid" else
                  _reference_launches(L, n, b.cfg.qk_norm, remat))
    if route.startswith("cp"):
        # the ring in each block's forward, again in its recompute
        expect.update(flash_attention=0, ring_step=2 * L * cp * n,
                      ring_step_bwd=L * cp * n)
    losses = out["losses"]
    log(f"[train] {route} route losses {losses} step_s {out['step_s']}")
    log(f"[train] {route} launches {launches} expected {expect}")
    assert all(map(math.isfinite, losses)), losses
    assert launches == expect, (launches, expect)
    if fwd0 is not None:
        log(f"[train] {route} step-0 loss {losses[0]} vs the forward's "
            f"{fwd0['loss']}: diff {abs(losses[0] - fwd0['loss']):.3e} "
            f"(tol {TRAIN_LOSS_TOL})")
        assert abs(losses[0] - fwd0["loss"]) < TRAIN_LOSS_TOL, (losses,
                                                                 fwd0)
    steady = out["step_s"][1:]
    summary = {
        "forward_step0": fwd0,
        "route": route, "arch": arch, "layers": L, "seq": seq,
        "global_batch": global_batch, "params": n_params, "losses": losses,
        "grad_norms": out["grad_norms"], "master_moves": moved,
        "step_s": out["step_s"],
        "tok_s_steady": global_batch * seq * len(steady) / sum(steady),
        "init_s": init_s, "state_gb": state_gb,
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "launches": launches, "expected_launches": expect,
        "plan": plan.describe() if plan else None,
    }
    log(f"[train] {route} report {json.dumps(summary)}")
    del t
    return summary, launches


def _vpp_search(cfg):
    """The planner's interleaved plan (vpp 2) on the train CLI's two-kind
    cluster for PP_BATCH sequences of TRAIN_SEQ."""
    from repro_torch.core import cluster as C
    from repro_torch.core import planner
    cluster = C.ClusterSpec(groups=(C.NodeGroup(C.AMD, 1, accel_per_node=1),
                                    C.NodeGroup(C.GPU_A, 1,
                                                accel_per_node=1)))
    return planner.search(
        cluster, cfg, global_batch=PP_BATCH, seq_len=TRAIN_SEQ,
        pp_options=[PP_STAGES], tp_options=[1], micro_bs_options=[1, 2],
        require_fit=False, include_tp_comm=False,
        schedule="interleaved-1f1b", vpp_options=[2]).plan


def phase_train_pp(torch, dev, smi: str, vpp: int = 1):
    """llama3-8b at full width, bf16, PP_BATCH sequences of TRAIN_SEQ:
    TRAIN_STEPS steps through the planner's non-uniform pp plan
    (TRAIN_LAYERS layers; with ``vpp`` 2 its interleaved plan at
    VPP_LAYERS), with exact launch counts (only the valid slots' real
    layers run; each block forward twice under remat), the ICCL tap's
    stage hops, and the step-0 loss against the reference loss on the
    same sequences (forward only, one microbatch at a time)."""
    from repro_torch.iccl import communicator
    from repro_torch.kernels import ops
    from repro_torch.core.cluster import cli_cluster
    from repro_torch.launch.train import search_plan
    from repro_torch.models import registry
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.profile.store import ProfileStore
    from repro_torch.train import steps
    from repro_torch.train.trainer import Trainer, TrainerConfig

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    route = "pp" if vpp == 1 else "pp vpp"
    layers = TRAIN_LAYERS if vpp == 1 else VPP_LAYERS
    b = registry.get_bundle("llama3-8b", num_layers=layers)
    plan = (search_plan(b.cfg, PP_STAGES, PP_BATCH, TRAIN_SEQ) if vpp == 1
            else _vpp_search(b.cfg))
    vl, m = plan.virtual_layers, plan.micro_batches
    log(f"[train] {route} route plan (planner.search, the train CLI's "
        f"two-kind cluster): {plan.describe()}, virtual layers {vl}, m {m}")
    assert plan.pp == PP_STAGES and plan.vpp == vpp, plan.describe()
    assert len(set(vl)) > 1, plan.describe()
    t0 = time.perf_counter()
    # the pp cell closes the loop: the CLI's cluster and a fresh store
    t = Trainer(b, TrainerConfig(global_batch=PP_BATCH, seq_len=TRAIN_SEQ),
                plan=plan, device=dev,
                cluster=cli_cluster() if vpp == 1 else None,
                profile_store=ProfileStore() if vpp == 1 else None)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    assert t._pipeline_active() and not t._cp_active()
    n_params = sum(x.numel() for x in tree_leaves(t.state["params"]))
    state_gb = torch.cuda.memory_allocated(dev) / 1e9
    batch = t._device_batch(t.data.batch_at(t.step))
    ref_loss = steps.make_loss_fn(b)
    with torch.no_grad():
        ref = sum(float(ref_loss(t.state["params"],
                                 {k: v[j] for k, v in batch.items()})[0])
                  for j in range(m)) / m
    del batch
    log(f"[train] {route} route: llama3-8b {layers} layers, "
        f"{n_params / 1e9:.3f} B params, train state {state_gb:.2f} GB, "
        f"init {init_s:.1f} s; reference loss on step 0's {PP_BATCH} "
        f"sequences {ref}")
    hops = []
    communicator.set_collective_sink(lambda *note: hops.append(note))
    ops.reset_launch_counts()
    try:
        out = t.run(TRAIN_STEPS)
    finally:
        communicator.set_collective_sink(None)
    launches = ops.launch_counts()
    L, n = sum(vl), TRAIN_STEPS
    expect = dict.fromkeys(launches, 0)
    expect.update(_pp_launches(m, L, n))
    losses, step_s = out["losses"], out["step_s"]
    steady = step_s[1:]
    tok_s = PP_BATCH * TRAIN_SEQ * len(steady) / sum(steady)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    ticks = m + len(vl) - 1
    log(f"[train] {route} route losses {losses} step_s {step_s}")
    log(f"[train] {route} launches {launches} expected {expect}")
    log(f"[train] {route} route on {smi}: step s {step_s[0]:.4f} / "
        f"{step_s[1]:.4f} / {step_s[2]:.4f}, tok/s (steps 1-2) {tok_s:.1f}, "
        f"peak {peak:.2f} GB")
    log(f"[train] {route} step-0 loss {losses[0]} vs reference {ref}: diff "
        f"{abs(losses[0] - ref):.3e} (tol {TRAIN_LOSS_TOL}); ICCL notes "
        f"{len(hops)} ({ticks} pp_shift a step expected)")
    assert all(map(math.isfinite, losses)), losses
    assert launches == expect, (launches, expect)
    assert abs(losses[0] - ref) < TRAIN_LOSS_TOL, (losses[0], ref)
    assert [h[0] for h in hops] == ["pp_shift"] * ticks * n, hops[:4]
    summary = {
        "route": route, "layers": L, "seq": TRAIN_SEQ,
        "global_batch": PP_BATCH, "params": n_params, "losses": losses,
        "reference_loss_step0": ref, "step_s": step_s, "tok_s_steady": tok_s,
        "init_s": init_s, "state_gb": state_gb, "peak_mem_gb": peak,
        "launches": launches, "expected_launches": expect,
        "iccl_notes_a_step": len(hops) // n, "plan": plan.describe(),
        "plan_dict": plan.to_dict(), "virtual_layers": list(vl),
        "micro_batches": m,
    }
    if vpp == 1:    # the timed steps' launches stay the summary's
        summary["replan"], added = _replan_pp(torch, t, smi, ref_loss)
        launches = {k: n + added[k] for k, n in launches.items()}
    log(f"[train] {route} report {json.dumps(summary)}")
    del t
    return summary, launches


def phase_train_ssm_pp(torch, dev, smi: str, ref: dict):
    """falcon-mamba-7b at full width and SSM_TRAIN_LAYERS layers through the
    one-process pipeline, pp 2 of even stages, SSM_PP_BATCH sequences of
    TRAIN_SEQ one a microbatch: TRAIN_STEPS steps, exact launches (each
    block's forward twice under remat), step 0 against the reference
    route's loss on the same sequences (forward only, a microbatch at a
    time)."""
    from repro_torch.core.plan import ParallelPlan, StagePlacement
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.train import steps
    from repro_torch.train.trainer import Trainer, TrainerConfig

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    L, m = SSM_TRAIN_LAYERS, SSM_PP_BATCH
    b = registry.get_bundle(SSM_ARCH, num_layers=L)
    plan = ParallelPlan(stages=(StagePlacement(0, L // 2, 1, 1),
                                StagePlacement(1, L // 2, 1, 1, True)),
                        micro_bs=1, global_batch=m, seq_len=TRAIN_SEQ)
    t = Trainer(b, TrainerConfig(global_batch=m, seq_len=TRAIN_SEQ),
                plan=plan, device=dev)
    assert t._pipeline_active()
    batch = t._device_batch(t.data.batch_at(t.step))
    with torch.no_grad():
        want = sum(float(steps.make_loss_fn(b)(
            t.state["params"], {k: v[j] for k, v in batch.items()})[0])
            for j in range(m)) / m
    del batch
    ops.reset_launch_counts()
    out = t.run(TRAIN_STEPS)
    launches = ops.launch_counts()
    expect = dict.fromkeys(launches, 0)
    expect.update(_ssm_launches(L, TRAIN_STEPS, m))
    losses, step_s = out["losses"], out["step_s"]
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"[train] {SSM_ARCH} pp route ({plan.describe()}) on {smi}: losses "
        f"{losses}, step s {step_s}, peak {peak:.2f} GB; step-0 loss vs "
        f"the reference loss on its {m} sequences {want}: diff "
        f"{abs(losses[0] - want):.3e} (tol {TRAIN_LOSS_TOL}); reference "
        f"route's step 0 (batch 1) {ref['losses'][0]}")
    log(f"[train] {SSM_ARCH} pp launches {launches} expected {expect}")
    assert all(map(math.isfinite, losses)), losses
    assert launches == expect, (launches, expect)
    assert abs(losses[0] - want) < TRAIN_LOSS_TOL, (losses[0], want)
    steady = step_s[1:]
    summary = {"route": f"{SSM_ARCH} pp", "layers": L, "seq": TRAIN_SEQ,
               "global_batch": m, "losses": losses,
               "reference_loss_step0": want, "step_s": step_s,
               "tok_s_steady": m * TRAIN_SEQ * len(steady) / sum(steady),
               "peak_mem_gb": peak, "launches": launches,
               "plan": plan.describe()}
    log(f"[train] {SSM_ARCH} pp report {json.dumps(summary)}")
    del t
    return summary, launches


def _pp_launches(m: int, L: int, n: int) -> dict:
    """The pp route's launches over n steps of m microbatches of L layers
    (each block forward twice under remat)."""
    return dict(rmsnorm=m * (4 * L + 1) * n, flash_attention=2 * m * L * n,
                swiglu=2 * m * L * n, rmsnorm_bwd=m * (2 * L + 1) * n,
                swiglu_bwd=m * L * n, ring_step_bwd=m * L * n)


def _replan_pp(torch, t, smi: str, ref_loss):
    """Phase (a) of the closed loop on the pp route's trainer ``t`` (after
    its timed steps, with the CLI's cluster and a store): steps until the
    store opens the profiled cost source, ``gpu-a`` degraded REPLAN_FACTOR
    times and ``replan`` with the CLI's search constraints (the search
    and ``_adopt`` timed apart), then REPLAN_STEPS steps on the new plan.
    Holds JAX's invariants (the degraded kind holds fewer layers, the
    source is profiled with the degradation as its time scale, the winner
    predicted below the logged baseline), the steps' launches exactly and
    the first step's loss within TRAIN_LOSS_TOL of the reference loss on
    its sequences.  Returns (its summary, the steps' launches)."""
    from repro_torch.kernels import ops
    from repro_torch.core.cluster import cli_search_kw
    from repro_torch.profile.model import ProfiledCostModel

    old = t.plan
    degraded = t.cluster.degrade(REPLAN_KIND, REPLAN_FACTOR)
    ops.reset_launch_counts()
    more = []
    while t.profiled_cost_source(degraded) is None:
        assert len(more) < 8, "the profile never opened"
        more += t.run(1)["step_s"]
    extra = ops.launch_counts()
    m, L = old.micro_batches, sum(old.virtual_layers)
    want = dict.fromkeys(extra, 0)
    want.update(_pp_launches(m, L, len(more)))
    assert extra == want, (extra, want)
    health = t.schedule_health()
    ticks = t._stage_tick_obs()
    obs = sum(e.value["n"] for e in t.profile_store.entries()
              if e.op in ("observed_layer_step", "observed_stage_tick"))
    log(f"[replan] pp route on {smi}: {len(more)} more steps {more} until "
        f"the profile holds {obs:.0f} observations; stage ticks {ticks} s, "
        f"schedule_health {health}")
    src = t.profiled_cost_source(degraded)
    assert isinstance(src, ProfiledCostModel), src
    assert src.time_scale == {REPLAN_KIND: REPLAN_FACTOR}, src.time_scale
    t0 = time.perf_counter()
    res = t.plan_for(degraded, global_batch=PP_BATCH, seq_len=TRAIN_SEQ,
                     **cli_search_kw(PP_STAGES))
    search_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    t._adopt(res, degraded)
    adopt_s = time.perf_counter() - t0
    new = t.plan

    def on_kind(p):
        return sum(st.n_layers for st in p.stages
                   if degraded.groups[st.group].device.name == REPLAN_KIND)

    base = dict(res.log).get(f"baseline {old.describe()}")
    log(f"[replan] pp route: {old.describe()} -> {new.describe()} "
        f"(virtual layers {list(new.virtual_layers)}), {REPLAN_KIND} "
        f"layers {on_kind(old)} -> {on_kind(new)}; predicted "
        f"{res.prediction.iter_time:.6f} s vs the baseline's {base}; search "
        f"{search_s:.3f} s, _adopt {adopt_s:.3f} s, migrations "
        f"{t.migrations}")
    assert on_kind(new) < on_kind(old), (old.describe(), new.describe())
    assert base is not None and res.prediction.iter_time < base, res.log
    assert t.migrations == {"memory": 1, "checkpoint": 0}, t.migrations
    batch = t._device_batch(t.data.batch_at(t.step))
    nm = new.micro_batches
    with torch.no_grad():
        ref = sum(float(ref_loss(t.state["params"],
                                 {k: v[j] for k, v in batch.items()})[0])
                  for j in range(nm)) / nm
    del batch
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = t.run(REPLAN_STEPS)
    after = ops.launch_counts()
    want = dict.fromkeys(after, 0)
    want.update(_pp_launches(nm, sum(new.virtual_layers), REPLAN_STEPS))
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = out["losses"]
    log(f"[replan] pp route on {smi}, {new.describe()}: losses {losses} "
        f"(reference {ref}: diff {abs(losses[0] - ref):.3e}, tol "
        f"{TRAIN_LOSS_TOL}), step s {out['step_s']}, peak {peak:.2f} GB; "
        f"launches {after} expected {want}")
    assert all(map(math.isfinite, losses)), losses
    assert after == want, (after, want)
    assert abs(losses[0] - ref) < TRAIN_LOSS_TOL, (losses[0], ref)
    return {"more_step_s": more, "observations": obs, "stage_ticks": ticks,
            "health": health, "old_plan": old.describe(),
            "plan": new.describe(), "virtual_layers": list(new.virtual_layers),
            "iter_time": res.prediction.iter_time, "baseline_time": base,
            "search_s": search_s, "adopt_s": adopt_s, "losses": losses,
            "reference_loss": ref, "step_s": out["step_s"],
            "peak_mem_gb": peak, "launches": after}, {
                k: extra[k] + after[k] for k in after}


def _rank_launches(n_layers: int, last: bool, m: int, steps: int) -> dict:
    """A pp stage's launches over ``steps`` steps of m microbatches: each
    block forward twice under remat and backward once, the final norm on
    the last stage."""
    return {"rmsnorm": steps * m * (4 * n_layers + last),
            "flash_attention": steps * m * 2 * n_layers,
            "swiglu": steps * m * 2 * n_layers,
            "rmsnorm_bwd": steps * m * (2 * n_layers + last),
            "swiglu_bwd": steps * m * n_layers,
            "ring_step_bwd": steps * m * n_layers}


def phase_train_pp_ranks(torch, dev, smi: str, pp: dict,
                         hop: bool = True, ckpt_dir=None):
    """The plan of the pp route ``pp`` (its summary) with each stage in its
    own process on this card: PP_STAGES ranks from ``run_ranks`` over
    gloo, the plan's transport replaced by "cpu" (NCCL cannot put two
    ranks on one device).  Checked against the pp route's losses and
    launches; then, with ``hop``, the host-staged hop alone, a ping-pong
    of one activation between the two ranks.  With ``ckpt_dir`` the ranks
    write one checkpoint there after the timed steps, each its own
    elements, then replan off REPLAN_KIND slowed REPLAN_FACTOR times (the
    train CLI's cluster, search constraints and a store the ranks' gathered
    telemetry fed; the "cpu" transport kept), move the state onto the new
    plan in memory, hold every element a rank received against the
    checkpoint bit for bit, and take one more step on the new plan
    (``after_losses``)."""
    from repro_torch.core.plan import ParallelPlan
    from repro_torch.core.simulator import peak_activation_microbatches
    from repro_torch.iccl.transports import default_registry
    from repro_torch.core.cluster import cli_search_kw
    from repro_torch.models import registry
    from repro_torch.parallel import rank_programs
    from repro_torch.parallel.launch import run_ranks

    gc.collect()
    torch.cuda.empty_cache()
    route = pp["route"].replace("pp", "pp_ranks", 1)
    cfg = registry.get_config("llama3-8b", num_layers=pp["layers"])
    found = ParallelPlan.from_dict(pp["plan_dict"])
    plan = dataclasses.replace(found, transport="cpu")
    vl, m, n = plan.virtual_layers, plan.micro_batches, TRAIN_STEPS
    V = len(vl)
    stage_layers = [sum(vl[s::PP_STAGES]) for s in range(PP_STAGES)]
    log(f"[train] {route} plan: {found.describe()}, transport "
        f"{found.transport!r} replaced by 'cpu' (two ranks on one card)")
    t0 = time.perf_counter()
    res = run_ranks(rank_programs.pp_train, PP_STAGES, device=str(dev),
                    timeout_s=RANKS_TIMEOUT_S,
                    args=(dict(arch="llama3-8b", num_layers=pp["layers"]),
                          plan.to_dict(), n, None, False,
                          None if ckpt_dir is None else str(ckpt_dir),
                          n, 0, int(ckpt_dir is not None), False,
                          None if ckpt_dir is None else dict(
                              kind=REPLAN_KIND, factor=REPLAN_FACTOR,
                              search_kw=cli_search_kw(PP_STAGES))))
    wall = time.perf_counter() - t0
    losses = res[-1]["losses"]
    step_s = [max(r["step_s"][i] for r in res) for i in range(n)]
    steady = step_s[1:]
    tok_s = PP_BATCH * TRAIN_SEQ * len(steady) / sum(steady)
    diffs = [abs(a - b) for a, b in zip(losses, pp["losses"])]
    act = torch.empty((), dtype=cfg.adtype)
    hop_bytes = (plan.tokens_per_tick * TRAIN_SEQ * cfg.d_model
                 * act.element_size())
    hops = [h for r in res for h in r["notes"] if h[0] == "isend_irecv"]
    others = sorted({tuple(h) for r in res for h in r["notes"]} - set(hops))
    launches = {k: sum(r["launches"][k] for r in res) for k in pp["launches"]}
    for r in res:
        log(f"[train] {route} rank {r['rank']} (stage {r['stage']}, "
            f"{r['n_params'] / 1e9:.3f} B params, state "
            f"{r['state_gb']:.2f} GB, init {r['init_s']:.1f} s): step s "
            f"{r['step_s']}, peak {r['peak_gb']:.2f} GB, in-flight peak "
            f"{r['peak_inflight']}, isend_irecv notes "
            f"{sum(h[0] == 'isend_irecv' for h in r['notes'])}, launches "
            f"{r['launches']}")
    log(f"[train] {route} losses {losses} vs {pp['route']} route "
        f"{pp['losses']}: diffs {diffs}; run_ranks wall {wall:.1f} s")
    log(f"[train] {route} on {smi}: step s {step_s[0]:.4f} / "
        f"{step_s[1]:.4f} / {step_s[2]:.4f}, tok/s (steps 1-2) "
        f"{tok_s:.1f}, peak GB {[round(r['peak_gb'], 2) for r in res]}; "
        f"isend_irecv notes {len(hops)} ({2 * m * (V - 1) * n} "
        f"expected), other notes {others}")
    assert all(r["losses"] == losses for r in res), [r["losses"] for r in res]
    assert all(map(math.isfinite, losses)), losses
    assert diffs[0] < RANKS_LOSS0_TOL, (losses[0], pp["losses"][0])
    assert max(diffs[1:]) < TRAIN_LOSS_TOL, diffs
    for r in res:
        s = r["stage"]
        want = dict.fromkeys(r["launches"], 0)
        want.update(_rank_launches(stage_layers[s], s == PP_STAGES - 1, m,
                                   n))
        assert r["launches"] == want, (s, r["launches"], want)
        assert r["peak_inflight"] == peak_activation_microbatches(
            s, PP_STAGES, m, plan.schedule, plan.eager_slack,
            vpp=plan.vpp), r
        # a hop a microbatch out of each virtual stage but the last, and a
        # gradient back out of each but the first, noted by the sender
        sends = m * sum((vs < V - 1) + (vs > 0)
                        for vs in range(s, V, PP_STAGES))
        assert sum(h[0] == "isend_irecv" for h in r["notes"]) == sends * n
    assert launches == pp["launches"], (launches, pp["launches"])
    assert [tuple(h) for h in hops] == \
        [("isend_irecv", "cpu", hop_bytes)] * (2 * m * (V - 1) * n)
    summary = {
        "route": route, "plan": found.describe(), "transport": "cpu",
        "ranks": PP_STAGES, "losses": losses, "pp_losses": pp["losses"],
        "loss_diffs": diffs, "step_s": step_s, "tok_s_steady": tok_s,
        "rank_step_s": [r["step_s"] for r in res],
        "rank_peak_gb": [r["peak_gb"] for r in res],
        "rank_state_gb": [r["state_gb"] for r in res],
        "rank_params": [r["n_params"] for r in res],
        "rank_launches": [r["launches"] for r in res], "launches": launches,
        "peak_inflight": [r["peak_inflight"] for r in res],
        "order": [r["order"] for r in res],
        "isend_irecv_notes_a_step": len(hops) // n, "hop_bytes": hop_bytes,
        "run_ranks_wall_s": wall, "rank_ckpt": [r["ckpt"] for r in res],
        "after_losses": res[-1]["after_losses"],
        "rank_after_step_s": [r["after_step_s"] for r in res],
    }
    if ckpt_dir is not None:
        assert all(r["after_losses"] == res[-1]["after_losses"]
                   for r in res), [r["after_losses"] for r in res]
        assert all(map(math.isfinite, res[-1]["after_losses"]))
        for r in res:
            c = r["ckpt"]
            log(f"[ckpt] {route} rank {r['rank']} on {smi}: its part of the "
                f"step-{n} checkpoint, {c['bytes'] / 1e9:.3f} GB snapshotted "
                f"(the leaves it writes): snapshot {c['snapshot_s']:.3f} s "
                f"(blocking), write {c['write_s']:.3f} s in the background "
                f"({c['bytes'] / c['write_s'] / 1e9:.3f} GB/s; rank 0's "
                f"waits for every rank's); the step after the save "
                f"{r['after_step_s'][0]:.4f} s against {r['step_s'][-1]:.4f}"
                f" before (the timed steps overlap no save)")
        summary["replan"] = _replan_pp_ranks(res, found, smi, route)
    if not hop:
        log(f"[train] {route} report {json.dumps(summary)}")
        return summary, launches

    t0 = time.perf_counter()
    timed = run_ranks(rank_programs.hop_times, 2, device=str(dev),
                      timeout_s=RANKS_TIMEOUT_S,
                      args=((plan.tokens_per_tick, TRAIN_SEQ, cfg.d_model),
                            str(act.dtype).split(".")[-1], "cpu",
                            HOP_REPS))
    hop_s = timed[0]["hop_s"]
    mean = sum(hop_s) / len(hop_s)
    price = default_registry()["cpu_staged"].p2p_time(hop_bytes)
    log(f"[train] pp_ranks host-staged hop of {hop_bytes / 1e6:.2f} MB on "
        f"{smi}: mean {mean * 1e3:.3f} ms over {len(hop_s)} round trips "
        f"(min {min(hop_s) * 1e3:.3f}, max {max(hop_s) * 1e3:.3f}), "
        f"{hop_bytes / mean / 1e9:.3f} GB/s; cpu_staged.p2p_time "
        f"{price * 1e3:.3f} ms; bit for bit {timed[0]['exact']}; "
        f"{time.perf_counter() - t0:.1f} s")
    assert timed[0]["exact"] and timed[0]["nbytes"] == hop_bytes
    summary.update(hop_s=hop_s, hop_mean_s=mean,
                   hop_gbps=hop_bytes / mean / 1e9, cpu_staged_p2p_s=price)
    log(f"[train] {route} report {json.dumps(summary)}")
    return summary, launches


def _replan_pp_ranks(res, found, smi: str, route: str) -> dict:
    """Phase (b) of the closed loop, from ``pp_train``'s ranks ``res``:
    every rank adopted one plan, which gives REPLAN_KIND fewer layers,
    moved in memory, and received every element it compared equal bit for
    bit to the checkpoint's; the move's bytes, seconds and GB/s and each
    rank's memory after it."""
    from repro_torch.core.plan import ParallelPlan
    from repro_torch.core.cluster import cli_cluster

    degraded = cli_cluster().degrade(REPLAN_KIND, REPLAN_FACTOR)
    rp = [r["replanned"] for r in res]
    new = ParallelPlan.from_dict(rp[0]["plan_dict"])

    def on_kind(p):
        return sum(st.n_layers for st in p.stages
                   if degraded.groups[st.group].device.name == REPLAN_KIND)

    for r, x in zip(res, rp):
        mig = x["migration"]
        moved = mig["sent_bytes"] + mig["recv_bytes"]
        log(f"[replan] {route} rank {r['rank']} on {smi} (the ranks "
            f"time-slice the card, so each op's time holds the other's "
            f"slices): gathered stage ticks {x['stage_ticks']} s, bubble "
            f"{x['bubble']}, schedule_health {x['health']}, profiled source "
            f"{x['profiled']}; plan {x['plan']} (stage {x['stage']}); "
            f"search {x['search_s']:.3f} s, _adopt {x['adopt_s']:.3f} s "
            f"(move {mig['seconds']:.3f} s: sent {mig['sent_bytes'] / 1e9:.3f}"
            f" GB, received {mig['recv_bytes'] / 1e9:.3f} GB, "
            f"{moved / mig['seconds'] / 1e9:.3f} GB/s; kept "
            f"{mig['kept_bytes'] / 1e9:.3f} GB); {x['moved_boxes']} boxes "
            f"received, unequal to the checkpoint {x['unequal']} (compared "
            f"in {x['compare_s']:.3f} s); memory "
            f"after {x['mem_gb_after']} GB, peak in the move "
            f"{x['peak_gb_move']} GB; the step on the new plan "
            f"{r['after_step_s']} s, loss {r['after_losses']}")
    assert all(x["plan"] == rp[0]["plan"] for x in rp), [x["plan"] for x in rp]
    assert on_kind(new) < on_kind(found), (found.describe(), new.describe())
    assert all(x["migrations"] == {"memory": 1, "checkpoint": 0}
               for x in rp), [x["migrations"] for x in rp]
    assert all(x["unequal"] == [] for x in rp), [x["unequal"] for x in rp]
    sent = sum(x["migration"]["sent_bytes"] for x in rp)
    assert sent == sum(x["migration"]["recv_bytes"] for x in rp) > 0
    assert sum(x["moved_boxes"] for x in rp) > 0
    secs = max(x["migration"]["seconds"] for x in rp)
    log(f"[replan] {route}: {found.describe()} -> {rp[0]['plan']}, "
        f"{sent / 1e9:.3f} GB moved in {secs:.3f} s ({sent / secs / 1e9:.3f}"
        f" GB/s, host-staged over gloo)")
    return {"plan": rp[0]["plan"], "sent_bytes": sent, "seconds": secs,
            "gbps": sent / secs / 1e9,
            "ranks": [{k: v for k, v in x.items() if k != "entries"}
                      for x in rp]}


def _tp_allreduces(n_layers: int) -> int:
    """``iallreduce`` notes a step of a pp 1, dp 1 tensor-parallel rank
    whose vocab and kv heads are split: forward, the embedding (1), each
    block's attention and MLP outputs (2 L) and the CE's sum of exp and
    gold logit (1); backward, each block's recomputed forward (remat) up
    to its last saved tensor: its attention output again (L), not its
    MLP's, which follows that tensor (checkpoint's early stop); each
    block's two column-parallel inputs (2 L) and the unembedding's (1);
    then the clipping norm's squares of the split leaves (1)."""
    return 5 * n_layers + 4


def phase_train_tp_ranks(torch, dev, smi: str, ref: dict):
    """The reference cell with its model split over TP_RANKS model ranks in
    as many processes on this card (a pp 1 plan, tp 2, transport "cpu":
    NCCL cannot put two ranks on one device).  Checked against the
    reference route's losses and launches; then one host-staged
    all-reduce of an activation alone."""
    from repro_torch.core.plan import ParallelPlan, StagePlacement
    from repro_torch.models import registry
    from repro_torch.parallel import rank_programs
    from repro_torch.parallel.launch import run_ranks

    gc.collect()
    torch.cuda.empty_cache()
    cfg = registry.get_config("llama3-8b", num_layers=TRAIN_LAYERS)
    L, n = TRAIN_LAYERS, TRAIN_STEPS
    plan = ParallelPlan(
        stages=(StagePlacement(0, L, 1, TP_RANKS, True),), micro_bs=1,
        global_batch=1, seq_len=TRAIN_SEQ, transport="cpu")
    log(f"[train] tp_ranks plan: {plan.describe()}, transport 'cpu' (two "
        f"ranks on one card)")
    t0 = time.perf_counter()
    res = run_ranks(rank_programs.pp_train, TP_RANKS, device=str(dev),
                    timeout_s=RANKS_TIMEOUT_S,
                    args=(dict(arch="llama3-8b", num_layers=L),
                          plan.to_dict(), n))
    wall = time.perf_counter() - t0
    losses = res[0]["losses"]
    step_s = [max(r["step_s"][i] for r in res) for i in range(n)]
    steady = step_s[1:]
    tok_s = TRAIN_SEQ * len(steady) / sum(steady)
    diffs = [abs(a - b) for a, b in zip(losses, ref["losses"])]
    act = torch.empty((1, TRAIN_SEQ, cfg.d_model), dtype=cfg.adtype,
                      device="meta")
    act_bytes = act.numel() * act.element_size()
    launches = {k: sum(r["launches"][k] for r in res) for k in ref["launches"]}
    want_ar = _tp_allreduces(L) * n
    for r in res:
        log(f"[train] tp_ranks rank {r['rank']} (model rank "
            f"{r['model_rank']}, {r['n_params'] / 1e9:.3f} B params, state "
            f"{r['state_gb']:.2f} GB, init {r['init_s']:.1f} s): step s "
            f"{r['step_s']}, peak {r['peak_gb']:.2f} GB, launches "
            f"{r['launches']}")
    notes = [[tuple(x) for x in r["notes"]] for r in res]
    ar = [[x for x in ns if x[0] == "iallreduce"] for ns in notes]
    big = [sum(1 for x in a if x[2] == act_bytes) for a in ar]
    others = sorted({x for ns in notes for x in ns
                     if x[0] not in ("iallreduce", "iallgather")})
    log(f"[train] tp_ranks losses {losses} vs reference {ref['losses']}: "
        f"diffs {diffs}; run_ranks wall {wall:.1f} s")
    log(f"[train] tp_ranks on {smi}: step s {step_s[0]:.4f} / "
        f"{step_s[1]:.4f} / {step_s[2]:.4f}, tok/s (steps 1-2) {tok_s:.1f}, "
        f"peak GB {[round(r['peak_gb'], 2) for r in res]}; iallreduce notes "
        f"a rank {[len(a) for a in ar]} ({want_ar} expected: "
        f"{_tp_allreduces(L)} a step), of them {act_bytes / 1e6:.2f} MB "
        f"{big}, other notes {others}")
    assert all(r["losses"] == losses for r in res), [r["losses"] for r in res]
    assert all(map(math.isfinite, losses)), losses
    assert max(diffs) < TRAIN_LOSS_TOL, (losses, ref["losses"])
    for r in res:
        assert r["launches"] == ref["launches"], (r["launches"],
                                                   ref["launches"])
    assert [len(a) for a in ar] == [want_ar] * TP_RANKS, ar[0][:8]
    assert big == [(5 * L + 2) * n] * TP_RANKS, big
    assert [sum(1 for x in ns if x[0] == "iallgather") for ns in notes] == \
        [n] * TP_RANKS
    assert not others, others

    t0 = time.perf_counter()
    timed = run_ranks(rank_programs.allreduce_times, TP_RANKS,
                      device=str(dev), timeout_s=RANKS_TIMEOUT_S,
                      args=(tuple(act.shape), str(act.dtype).split(".")[-1],
                            "cpu", HOP_REPS))
    ar_s = timed[0]["s"]
    mean = sum(ar_s) / len(ar_s)
    log(f"[train] tp_ranks host-staged all-reduce of {act_bytes / 1e6:.2f} "
        f"MB over {TP_RANKS} ranks on {smi}: mean {mean * 1e3:.3f} ms over "
        f"{len(ar_s)} calls (min {min(ar_s) * 1e3:.3f}, max "
        f"{max(ar_s) * 1e3:.3f}); exact {[t['exact'] for t in timed]}; "
        f"{time.perf_counter() - t0:.1f} s")
    assert all(t["exact"] for t in timed)
    assert timed[0]["nbytes"] == act_bytes
    summary = {
        "route": "tp_ranks", "plan": plan.describe(), "transport": "cpu",
        "ranks": TP_RANKS, "losses": losses,
        "reference_losses": ref["losses"], "loss_diffs": diffs,
        "step_s": step_s, "tok_s_steady": tok_s,
        "rank_step_s": [r["step_s"] for r in res],
        "rank_peak_gb": [r["peak_gb"] for r in res],
        "rank_state_gb": [r["state_gb"] for r in res],
        "rank_params": [r["n_params"] for r in res],
        "rank_launches": [r["launches"] for r in res], "launches": launches,
        "iallreduce_notes_a_step": len(ar[0]) // n,
        "allreduce_bytes": act_bytes, "allreduce_s": ar_s,
        "allreduce_mean_s": mean, "run_ranks_wall_s": wall,
    }
    log(f"[train] tp_ranks report {json.dumps(summary)}")
    return summary, launches


def _cp_hops(n_layers: int, cp: int) -> int:
    """``isend_irecv`` notes a step of a ring rank under remat: each
    block's forward passes K and V (one message) cp - 1 hops, its
    recompute the same again, and its backward K and V cp - 1 hops with
    dK/dV (another message) cp hops, the last one home."""
    return n_layers * (4 * (cp - 1) + 1)


def phase_train_cp_ranks(torch, dev, smi: str):
    """llama3-8b at full width, CP_RANKS_LAYERS layers, one sequence of
    TRAIN_SEQ as a pp 1 plan of a CP_RANKS ring (CP_RANKS_CHUNKS), each
    ring rank in its own process on this card (transport "cpu": NCCL
    cannot put two ranks on one device).  The witness is the one-process
    cp route at the same depth, chunks and seed, run first and freed.
    Checked: step 0 within RANKS_LOSS0_TOL of the witness's loss, steps
    1-2 within TRAIN_LOSS_TOL; each rank's launches equal to the
    witness's (a rank runs every kernel of the witness's path on its own
    chunk: the cp ring_step launches of a block's forward, one hop of one
    rank each, where the witness's each fold every rank), so they sum to
    CP_RANKS times the witness's; ``_cp_hops`` isend_irecv notes and an
    iallreduce a gradient leaf and the loss's a step on each rank."""
    from repro_torch.parallel import rank_programs
    from repro_torch.parallel.launch import run_ranks

    chunks, L, n = CP_RANKS_CHUNKS, CP_RANKS_LAYERS, TRAIN_STEPS
    witness, wl = phase_train(torch, dev, "cp", layers=L, chunks=chunks)
    gc.collect()
    torch.cuda.empty_cache()
    plan = dataclasses.replace(_cp_plan(chunks, 1, L), transport="cpu")
    log(f"[train] cp_ranks plan: {plan.describe()}, chunks {chunks}, "
        f"transport 'cpu' ({CP_RANKS} ranks on one card)")
    t0 = time.perf_counter()
    res = run_ranks(rank_programs.pp_train, CP_RANKS, device=str(dev),
                    timeout_s=RANKS_TIMEOUT_S,
                    args=(dict(arch="llama3-8b", num_layers=L),
                          plan.to_dict(), n))
    wall = time.perf_counter() - t0
    losses = res[0]["losses"]
    step_s = [max(r["step_s"][i] for r in res) for i in range(n)]
    steady = step_s[1:]
    tok_s = TRAIN_SEQ * len(steady) / sum(steady)
    diffs = [abs(a - b) for a, b in zip(losses, witness["losses"])]
    launches = {k: sum(r["launches"][k] for r in res) for k in wl}
    notes = [[tuple(x) for x in r["notes"]] for r in res]
    hops = [sum(1 for x in ns if x[0] == "isend_irecv") for ns in notes]
    ars = [sum(1 for x in ns if x[0] == "iallreduce") for ns in notes]
    others = sorted({x[0] for ns in notes for x in ns
                     if x[0] not in ("isend_irecv", "iallreduce")})
    for r in res:
        log(f"[train] cp_ranks rank {r['rank']} (ring rank {r['ring']}, "
            f"chunk {chunks[r['ring']]}, {r['n_params'] / 1e9:.3f} B "
            f"params, state {r['state_gb']:.2f} GB, init "
            f"{r['init_s']:.1f} s): step s {r['step_s']}, peak "
            f"{r['peak_gb']:.2f} GB, launches {r['launches']}")
    log(f"[train] cp_ranks losses {losses} vs the one-process cp route "
        f"{witness['losses']}: diffs {diffs}; run_ranks wall {wall:.1f} s")
    log(f"[train] cp_ranks on {smi}: step s {step_s[0]:.4f} / "
        f"{step_s[1]:.4f} / {step_s[2]:.4f}, tok/s (steps 1-2) {tok_s:.1f} "
        f"(witness {witness['tok_s_steady']:.1f}), peak GB "
        f"{[round(r['peak_gb'], 2) for r in res]} (witness "
        f"{witness['peak_mem_gb']:.2f}); isend_irecv notes a rank {hops} "
        f"({_cp_hops(L, CP_RANKS) * n} expected), iallreduce {ars} "
        f"({(res[0]['n_leaves'] + 1) * n} expected), others {others}")
    assert all(r["losses"] == losses for r in res), [r["losses"] for r in res]
    assert all(map(math.isfinite, losses)), losses
    assert diffs[0] < RANKS_LOSS0_TOL, (losses, witness["losses"])
    assert max(diffs) < TRAIN_LOSS_TOL, (losses, witness["losses"])
    assert [r["ring"] for r in res] == list(range(CP_RANKS))
    assert all(r["ring_equal"] for r in res)
    for r in res:
        assert r["launches"] == wl, (r["launches"], wl)
    assert launches == {k: CP_RANKS * v for k, v in wl.items()}
    assert hops == [_cp_hops(L, CP_RANKS) * n] * CP_RANKS, hops
    assert ars == [(r["n_leaves"] + 1) * n for r in res], ars
    assert not others, others
    summary = {
        "route": "cp_ranks", "plan": plan.describe(), "chunks": chunks,
        "transport": "cpu", "ranks": CP_RANKS, "layers": L,
        "losses": losses, "witness_losses": witness["losses"],
        "loss_diffs": diffs, "step_s": step_s, "tok_s_steady": tok_s,
        "witness_step_s": witness["step_s"],
        "witness_tok_s_steady": witness["tok_s_steady"],
        "witness_peak_gb": witness["peak_mem_gb"],
        "rank_step_s": [r["step_s"] for r in res],
        "rank_peak_gb": [r["peak_gb"] for r in res],
        "rank_state_gb": [r["state_gb"] for r in res],
        "rank_launches": [r["launches"] for r in res],
        "witness_launches": wl, "isend_irecv_notes_a_step": hops[0] // n,
        "run_ranks_wall_s": wall,
    }
    log(f"[train] cp_ranks report {json.dumps(summary)}")
    return summary, {k: launches[k] + wl[k] for k in wl}


def phase_train_dp_ranks(torch, dev, smi: str, ref: dict):
    """The reference cell at DP_RANKS sequences as a pp 1 plan of DP_RANKS
    replicas, one sequence each, in as many processes on this card
    (transport "cpu": NCCL cannot put two ranks on one device), ZeRO-1
    over ``data``.  Checked against ``ref``, the reference route at the
    same global batch, batches and seed: losses, launches, the ICCL notes
    and each rank's optimizer bytes."""
    from repro_torch.core.plan import ParallelPlan, StagePlacement
    from repro_torch.parallel import rank_programs
    from repro_torch.parallel.launch import run_ranks

    gc.collect()
    torch.cuda.empty_cache()
    L, n, dp = TRAIN_LAYERS, TRAIN_STEPS, DP_RANKS
    plan = ParallelPlan(
        stages=(StagePlacement(0, L, dp, 1, True),), micro_bs=1,
        global_batch=dp, seq_len=TRAIN_SEQ, transport="cpu")
    log(f"[train] dp_ranks plan: {plan.describe()}, transport 'cpu' (two "
        f"replicas on one card), ZeRO-1 over data")
    t0 = time.perf_counter()
    res = run_ranks(rank_programs.pp_train, dp, device=str(dev),
                    timeout_s=RANKS_TIMEOUT_S,
                    args=(dict(arch="llama3-8b", num_layers=L),
                          plan.to_dict(), n, None, True))
    wall = time.perf_counter() - t0
    losses = res[0]["losses"]
    norms = res[0]["grad_norms"]
    norm_err = [abs(a - b) / b for a, b in zip(norms, ref["grad_norms"])]
    # each leaf's master move, the replicas' slices together, against the
    # whole leaf's: the worst leaf's relative difference a step
    move_err = [max(abs(math.sqrt(sum(r["master_moves"][i][k] for r in res))
                        - math.sqrt(want)) / math.sqrt(want)
                    for k, want in enumerate(ref["master_moves"][i]))
                for i in range(n)]
    step_s = [max(r["step_s"][i] for r in res) for i in range(n)]
    steady = step_s[1:]
    tok_s = dp * TRAIN_SEQ * len(steady) / sum(steady)
    diffs = [abs(a - b) for a, b in zip(losses, ref["losses"])]
    launches = {k: sum(r["launches"][k] for r in res) for k in ref["launches"]}
    for r in res:
        log(f"[train] dp_ranks rank {r['rank']} (replica {r['replica']}, "
            f"{r['n_params'] / 1e9:.3f} B params: {r['param_bytes'] / 1e9:.3f}"
            f" GB of parameters, {r['opt_bytes'] / 1e9:.3f} GB of "
            f"{'/'.join(r['opt_trees'])} ({r['opt_whole_bytes'] / 1e9:.3f} "
            f"GB of it in leaves kept whole, "
            f"{4 * r['n_params'] * len(r['opt_trees']) / 1e9:.3f} GB "
            f"unsplit), {r['n_zero_split']} of {r['n_leaves']} leaves "
            f"split; state {r['state_gb']:.2f} GB, init {r['init_s']:.1f} "
            f"s): step s {r['step_s']}, peak {r['peak_gb']:.2f} GB, "
            f"launches {r['launches']}")
    notes = [[tuple(x) for x in r["notes"]] for r in res]
    count = [{op: sum(x[0] == op for x in ns)
              for op in ("iallreduce", "iallgather")} for ns in notes]
    others = sorted({x for ns in notes for x in ns
                     if x[0] not in ("iallreduce", "iallgather")})
    log(f"[train] dp_ranks losses {losses} vs reference b{dp} "
        f"{ref['losses']}: diffs {diffs} (step 0 {diffs[0]:.3e}); run_ranks "
        f"wall {wall:.1f} s")
    log(f"[train] dp_ranks on {smi}: step s {step_s[0]:.4f} / "
        f"{step_s[1]:.4f} / {step_s[2]:.4f}, tok/s (steps 1-2) {tok_s:.1f}, "
        f"peak GB {[round(r['peak_gb'], 2) for r in res]}; notes a rank "
        f"{count}, other notes {others}")
    log(f"[train] dp_ranks grad norms {norms} vs reference b{dp} "
        f"{ref['grad_norms']}: relative {norm_err}; the worst leaf's master "
        f"move a step, relative to reference b{dp}'s: {move_err} (tol "
        f"{DP_NORM_TOL}); replicas equal bit for bit: "
        f"{[r['replicas_equal'] for r in res]}")
    assert all(r["losses"] == losses for r in res), [r["losses"] for r in res]
    assert all(r["grad_norms"] == norms for r in res), \
        [r["grad_norms"] for r in res]
    assert all(r["replicas_equal"] for r in res), \
        [r["replicas_equal"] for r in res]
    assert max(norm_err) < DP_NORM_TOL, (norms, ref["grad_norms"])
    assert max(move_err) < DP_NORM_TOL, move_err
    assert all(map(math.isfinite, losses)), losses
    assert max(diffs) < TRAIN_LOSS_TOL, (losses, ref["losses"])
    for r, c in zip(res, count):
        # each replica runs the reference route's kernels on its sequence
        assert r["launches"] == ref["launches"], (r["launches"],
                                                   ref["launches"])
        # a gradient all-reduce a leaf and the loss's; a parameter
        # all-gather a ZeRO-1 split leaf
        assert c == {"iallreduce": (r["n_leaves"] + 1) * n,
                     "iallgather": r["n_zero_split"] * n}, c
        # ZeRO-1: of the fp32 master, m and v (4 bytes a parameter each)
        # each replica holds 1/dp of every split leaf
        whole = 4 * r["n_params"] * len(r["opt_trees"])
        assert r["opt_bytes"] - r["opt_whole_bytes"] == \
            (whole - r["opt_whole_bytes"]) // dp, r
    assert not others, others
    summary = {
        "route": "dp_ranks", "plan": plan.describe(), "transport": "cpu",
        "ranks": dp, "losses": losses, "reference_losses": ref["losses"],
        "loss_diffs": diffs, "grad_norm_rel_diffs": norm_err,
        "worst_master_move_rel_diffs": move_err,
        "step_s": step_s, "tok_s_steady": tok_s,
        "rank_step_s": [r["step_s"] for r in res],
        "rank_peak_gb": [r["peak_gb"] for r in res],
        "rank_state_gb": [r["state_gb"] for r in res],
        "rank_param_bytes": [r["param_bytes"] for r in res],
        "rank_opt_bytes": [r["opt_bytes"] for r in res],
        "rank_opt_whole_bytes": [r["opt_whole_bytes"] for r in res],
        "rank_launches": [r["launches"] for r in res], "launches": launches,
        "notes_a_step": {k: v // n for k, v in count[0].items()},
        "run_ranks_wall_s": wall,
    }
    log(f"[train] dp_ranks report {json.dumps(summary)}")
    return summary, launches


# ------------------------------------------------------------ phase 6c ---
def _proc_kb(path: str, field: str) -> int:
    """``field`` of a /proc file in kB: MemAvailable of /proc/meminfo,
    VmRSS of /proc/self/status."""
    for line in Path(path).read_text().splitlines():
        if line.startswith(field + ":"):
            return int(line.split()[1])
    raise KeyError(field)


def _ckpt_dir(parent: Path, what: str, host_copies: int = 0,
              name: str = ""):
    """A fresh directory under ``parent`` for ``what``, a checkpoint of the
    4-layer state: its filesystem must have CKPT_BYTES free, and the host
    ``host_copies`` times that available beside it; with df's line.
    ``name``: the directory's name, removed first if a killed run left
    it (default: a new temporary name)."""
    if not parent.is_dir():
        raise RuntimeError(f"checkpoint phase: no {parent} for {what}")
    if name and (parent / name).exists():
        log(f"[ckpt] removing {parent / name}, left by a run that was "
            "killed")
        shutil.rmtree(parent / name)
    fs = " ".join(subprocess.run(
        ["df", "-PT", str(parent)], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[-1].split())
    free = shutil.disk_usage(parent).free
    avail = _proc_kb("/proc/meminfo", "MemAvailable") * 1e3
    log(f"[ckpt] {what}: {parent} ({fs}), {free / 1e9:.1f} GB free, host "
        f"memory available {avail / 1e9:.1f} GB")
    if free < 1.1 * CKPT_BYTES:
        raise RuntimeError(f"checkpoint phase: {parent} has {free / 1e9:.1f}"
                           f" GB free; {what} needs {CKPT_BYTES / 1e9:.1f}")
    if avail < host_copies * 1.1 * CKPT_BYTES:
        raise RuntimeError(
            f"checkpoint phase: {avail / 1e9:.1f} GB of host memory "
            f"available; {what} needs {host_copies} x "
            f"{CKPT_BYTES / 1e9:.1f} GB")
    if not name:
        return Path(tempfile.mkdtemp(prefix="repro-ckpt-", dir=parent)), fs
    (parent / name).mkdir(mode=0o700)
    return parent / name, fs


def _shm_name() -> str:
    """A /dev/shm directory's name, this checkout's and its temporary
    directory's: a second checkout on the host never shares it, and a
    killed run's is found again by the next run of this checkout."""
    key = f"{ROOT}\0{tempfile.gettempdir()}".encode()
    return f"repro-ckpt-{hashlib.sha1(key).hexdigest()[:16]}"


def _stop(signum, frame):
    """SIGTERM and SIGHUP end the run through its ``finally`` blocks, which
    remove the checkpoints and stop the rank processes."""
    raise SystemExit(128 + signum)


def _dir_bytes(d: Path) -> int:
    return sum(f.stat().st_size for f in d.rglob("*") if f.is_file())


def _ssm_launches(n_layers: int, steps: int, m: int = 1) -> dict:
    """The ssm stack's launches over ``steps`` steps of ``m`` microbatches
    under remat: each block's norm and scan forward twice, their
    backwards once, the final norm once each way."""
    return {"rmsnorm": m * (2 * n_layers + 1) * steps,
            "rmsnorm_bwd": m * (n_layers + 1) * steps,
            "ssm_scan": 2 * m * n_layers * steps,
            "ssm_scan_bwd": m * n_layers * steps}


def _reference_launches(n_layers: int, steps: int, qk_norm: bool = False,
                        remat: bool = True) -> dict:
    """The reference route's launches over ``steps`` steps (phase_train):
    under remat each block's forward kernels twice (its two norms, and
    qk_norm's two where the arch has them, flash and swiglu; without it
    once), its backward kernels once, the final norm once each way."""
    qk = 2 * n_layers if qk_norm else 0
    f = 2 if remat else 1
    return {"rmsnorm": (f * (2 * n_layers + qk) + 1) * steps,
            "rmsnorm_bwd": (2 * n_layers + qk + 1) * steps,
            "swiglu": f * n_layers * steps, "swiglu_bwd": n_layers * steps,
            "flash_attention": f * n_layers * steps,
            "ring_step_bwd": n_layers * steps}


def _hybrid_launches(cfg, steps: int, remat: bool = True) -> dict:
    """The hybrid stack's launches on the reference route over ``steps``
    steps: under remat each group's and tail block's forward kernels
    twice (two norms a block, flash in its attn blocks), the backward
    kernels once, the final norm once each way."""
    L, n_attn = cfg.num_layers, cfg.layer_kinds().count("attn")
    f = 2 if remat else 1
    return {"rmsnorm": (f * 2 * L + 1) * steps,
            "rmsnorm_bwd": (2 * L + 1) * steps,
            "flash_attention": f * n_attn * steps,
            "ring_step_bwd": n_attn * steps}


def phase_ckpt(torch, dev, smi: str, d: Path, fs: str):
    """Checkpoints on the card: the reference cell (batch 1, 4 layers),
    trainer A taking TRAIN_STEPS steps saving every CKPT_EVERY into ``d``,
    so the step-2 save is written while step 3 runs; a new trainer B
    restores step 2, its state equal bit for bit to the snapshot A's save
    wrote (leaf by leaf on the host), and its step's loss equal bit for
    bit to A's third (the forward kernels use no atomics).  Exact launch
    counts over the 4 steps; the save's snapshot (blocking), its
    background write and B's init with the restore timed, with the bytes
    and the host memory the snapshot took."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.core.plan import ParallelPlan
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.parallel.sharding import map_with_path
    from repro_torch.train.trainer import Trainer, TrainerConfig

    gc.collect()
    torch.cuda.empty_cache()
    L = TRAIN_LAYERS
    b = registry.get_bundle("llama3-8b", num_layers=L)
    cfg = TrainerConfig(global_batch=1, seq_len=TRAIN_SEQ, ckpt_dir=str(d),
                        ckpt_every=CKPT_EVERY)
    kept = {}
    save = ckpt.save

    def keep(ckpt_dir, step, host_state, extra=None):
        # the snapshot this background save writes, held for the comparison
        kept["state"] = host_state
        kept["rss_kb"] = _proc_kb("/proc/self/status", "VmRSS")
        return save(ckpt_dir, step, host_state, extra)

    ckpt.save = keep
    try:
        a = Trainer(b, cfg, device=dev)
        assert a.step == 0, a.step
        rss0 = _proc_kb("/proc/self/status", "VmRSS")
        ops.reset_launch_counts()
        ran = a.run(TRAIN_STEPS)
        launches = ops.launch_counts()
        snap = dict(a.ckpt.timings)
        assert ckpt.all_steps(str(d)) == [CKPT_EVERY], ckpt.all_steps(str(d))
        del a
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        ckpt.save = save
    nbytes = _dir_bytes(d / f"step_{CKPT_EVERY:08d}")
    t0 = time.perf_counter()
    resumed = Trainer(b, cfg, device=dev)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    assert resumed.step == resumed.data.state.step == CKPT_EVERY
    assert resumed.migrations == {"memory": 0, "checkpoint": 0}
    diff = []

    def same(path, t):
        want = kept["state"]
        for k in path:
            want = want[k]
        if not (t.dtype == want.dtype and torch.equal(t.cpu(), want)):
            diff.append("/".join(path))
        return t.numel()

    n_el = sum(_leaves(map_with_path(same, resumed.state)))
    del kept["state"]
    gc.collect()
    ops.reset_launch_counts()
    after = resumed.run(1)
    for k, n in ops.launch_counts().items():
        launches[k] += n
    del resumed
    gc.collect()
    torch.cuda.empty_cache()
    expect = dict.fromkeys(launches, 0)
    expect.update(_reference_launches(L, TRAIN_STEPS + 1))
    losses, step_s = ran["losses"], ran["step_s"]
    snap_gb = snap["bytes"] / 1e9
    log(f"[ckpt] reference route, llama3-8b {L} layers, on {smi}: "
        f"checkpoint of step {CKPT_EVERY} {nbytes / 1e9:.3f} GB on disk; "
        f"snapshot {snap['snapshot_s']:.3f} s (blocking, "
        f"{snap_gb / snap['snapshot_s']:.3f} GB/s), write "
        f"{snap['write_s']:.3f} s in the background "
        f"({nbytes / snap['write_s'] / 1e9:.3f} GB/s); trainer init "
        f"with the restore {init_s:.3f} s ({nbytes / init_s / 1e9:.3f} "
        f"GB/s)")
    log(f"[ckpt] reference route on {smi}: step s {step_s} (step 3 with the "
        f"save in flight {step_s[2]:.4f} against {step_s[1]:.4f} before); "
        f"host memory: snapshot {snap_gb:.3f} GB, VmRSS "
        f"{rss0 / 1e6:.3f} -> {kept['rss_kb'] / 1e6:.3f} GB at the write; "
        f"filesystem {' '.join(fs.split()[:2])}")
    log(f"[ckpt] reference route: losses {losses}, resumed at step "
        f"{CKPT_EVERY}: {after['losses']}; restored state {n_el} elements, "
        f"leaves unequal {diff}; launches {launches} expected {expect}")
    assert not diff, diff
    assert after["losses"][0] == losses[2], (after["losses"], losses)
    assert launches == expect, (launches, expect)
    assert all(map(math.isfinite, losses + after["losses"]))

    summary = {
        "filesystem": fs, "ckpt_every": CKPT_EVERY, "bytes": nbytes,
        "snapshot_bytes": snap["bytes"], "snapshot_s": snap["snapshot_s"],
        "write_s": snap["write_s"], "init_s": init_s,
        "step_s": step_s, "losses": losses,
        "resumed_losses": after["losses"],
        "vmrss_kb": [rss0, kept["rss_kb"]], "restored_elements": n_el,
        "launches": launches,
    }
    log(f"[ckpt] report {json.dumps(summary)}")
    return summary, launches


def phase_ckpt_pp(torch, dev, smi: str, d: Path, fs: str, pp: dict,
                  pp_ranks: dict):
    """The pp route of the pp cell's plan (``pp``: its summary) restores
    the checkpoint pp_ranks' two processes wrote into ``d`` after their
    TRAIN_STEPS timed steps (``pp_ranks``: its summary), timed; its step's
    loss lies within RANKS_LOSS0_TOL of pp_ranks' next step's; exact launch
    counts."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.core.plan import ParallelPlan
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.train.trainer import Trainer, TrainerConfig

    gc.collect()
    torch.cuda.empty_cache()
    saved = TRAIN_STEPS
    assert ckpt.all_steps(str(d)) == [saved], ckpt.all_steps(str(d))
    nbytes = _dir_bytes(d / f"step_{saved:08d}")
    plan = ParallelPlan.from_dict(pp["plan_dict"])
    b = registry.get_bundle("llama3-8b", num_layers=pp["layers"])
    t0 = time.perf_counter()
    # ckpt_every: no save in its one step
    t = Trainer(b, TrainerConfig(global_batch=PP_BATCH, seq_len=TRAIN_SEQ,
                                 ckpt_dir=str(d), ckpt_every=10 * saved),
                plan=plan, device=dev)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    assert t._pipeline_active() and t.step == saved, t.step
    ops.reset_launch_counts()
    got = t.run(1)["losses"][0]
    launches = ops.launch_counts()
    del t
    gc.collect()
    torch.cuda.empty_cache()
    m, L = pp["micro_batches"], pp["layers"]
    want = dict.fromkeys(launches, 0)
    want.update(_pp_launches(m, L, 1))
    ref = pp_ranks["after_losses"][0]
    log(f"[ckpt] pp route restores pp_ranks' step-{saved} checkpoint "
        f"({nbytes / 1e9:.3f} GB on {' '.join(fs.split()[:2])}, written by "
        f"{len(pp_ranks['rank_ckpt'])} processes) on {smi}: trainer init "
        f"with the restore {init_s:.3f} s ({nbytes / init_s / 1e9:.3f} "
        f"GB/s); loss {got} vs pp_ranks' step after the save {ref}: diff "
        f"{abs(got - ref):.3e} (tol {RANKS_LOSS0_TOL}); launches "
        f"{launches} expected {want}")
    assert abs(got - ref) < RANKS_LOSS0_TOL, (got, ref)
    assert launches == want, (launches, want)
    summary = {"filesystem": fs, "bytes": nbytes, "init_s": init_s,
               "loss": got, "pp_ranks_loss": ref,
               "rank_ckpt": pp_ranks["rank_ckpt"], "launches": launches}
    log(f"[ckpt] pp report {json.dumps(summary)}")
    return summary, launches


# ------------------------------------------------------------ phase 6c ---
# the autonomous controller, elastic membership and observability, through
# the train CLI on the pp cell at CTL_BATCH sequences: a plan the controller
# may move to pp 1 runs the reference route, whose batch 4 would not fit
# the card beside the state (reference b2 peaks at ~53 GB)
CTL_BATCH = 2
CTL_STEPS = 8
CTL_DEGRADE = "gpu-a:4@4"       # the controller sees it two steps later
CTL_LOSE, CTL_JOIN = 3, 5       # --lose gpu-a@3 --join gpu-a@5
# two runs of one plan agree bit for bit at step 0, and after an update only
# to rounding: ring_step_bwd adds dq with float atomics in no fixed order
CTL_REPEAT_TOL = 5e-3
OBS_FLAGS = ("trace-out", "metrics-out", "events-out", "prom-out",
             "flight-out")
OBS_FILES = dict(zip(OBS_FLAGS, ("trace.json", "metrics.jsonl",
                                 "events.jsonl", "prom.txt", "flight.json")))


def _plan_shape(described: str):
    """(pp, m) of a ``ParallelPlan.describe()`` string."""
    fields = dict(f.split("=", 1) for f in described.split() if "=" in f)
    return int(fields["pp"]), int(fields["m"])


def _segment_launches(n_layers: int, plans, n_steps: int) -> dict:
    """The launches of ``n_steps`` CLI steps that ran ``plans``: ``[(first
    step, plan description)]``, each from its step on (pp > 1: the pp
    route, with remat; pp 1: the reference route)."""
    out: dict = {}
    bounds = [s for s, _ in plans[1:]] + [n_steps]
    for (start, described), end in zip(plans, bounds):
        pp, m = _plan_shape(described)
        seg = (_pp_launches(m, n_layers, end - start) if pp > 1
               else _reference_launches(n_layers, end - start))
        for k, v in seg.items():
            out[k] = out.get(k, 0) + v
    return out


def _cli_run(tag: str, d: Path, flags) -> dict:
    """The train CLI on the pp cell in a child process on this card
    (``--layers TRAIN_LAYERS --seq TRAIN_SEQ --global-batch CTL_BATCH
    --pp PP_STAGES --ckpt-dir ''``, then ``flags``): its JSON summary, its
    stdout kept as ``<tag>.log`` in ``d``."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--layers",
           str(TRAIN_LAYERS), "--seq", str(TRAIN_SEQ), "--global-batch",
           str(CTL_BATCH), "--pp", str(PP_STAGES), "--ckpt-dir", "",
           *flags]
    env = dict(os.environ, PYTHONPATH=str(SRC), TMPDIR=str(d))
    t0 = time.perf_counter()
    r = subprocess.run(cmd, env=env, cwd=str(ROOT), capture_output=True,
                       text=True, timeout=600)
    (d / f"{tag}.log").write_text(r.stdout)
    if r.returncode != 0:
        raise RuntimeError(f"{tag}: the train CLI exited {r.returncode}:\n"
                           f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    summary = json.loads(r.stdout.strip().splitlines()[-1])
    summary["wall_s"] = time.perf_counter() - t0
    for line in r.stdout.splitlines():
        if line.startswith(("[adapt]", "[train] plan", "[train] injected",
                            "[train] membership")):
            log(f"[ctl] {tag}: {line[:300]}")
    return summary


def _validate(tool: str, *args) -> str:
    """``tools/<tool>`` (unchanged) in a child process; raises unless it
    passes."""
    r = subprocess.run([sys.executable, str(ROOT / "tools" / tool), *args],
                       capture_output=True, text=True, timeout=120)
    out = (r.stdout + r.stderr).strip()
    if r.returncode != 0:
        raise RuntimeError(f"{tool} failed: {out}")
    return out


def phase_controller(torch, smi: str):
    """The train CLI's autonomous controller, elastic membership and
    observability on the pp cell (llama3-8b, full width, TRAIN_LAYERS
    layers, CTL_BATCH sequences of TRAIN_SEQ) on this card, each run a
    child process: (a) ``--adapt`` with every obs flag and ``--degrade
    CTL_DEGRADE``: the controller must trigger, replan and migrate by
    itself (the steps from the injection to its ``migrate`` event are
    printed), the artifacts pass ``tools/validate_obs.py
    --expect-replan``; (b) the same run without the obs flags and the
    degrade, for the step time with every obs output off against on;
    (c) ``--lose gpu-a@CTL_LOSE --join gpu-a@CTL_JOIN`` with every obs
    flag: pp 2 -> pp 1 -> pp 2, each move's bytes and seconds, the events
    and run log passing ``tools/validate_elastic.py`` and the artifacts
    ``validate_obs.py --expect-replan``.  Every run's launches equal the
    sum over the plans it ran of each plan's launches times its steps.
    The degrade only skews telemetry, so (a)'s losses before its migrate
    event are the yardstick: (b)'s and (c)'s step 0 equal (a)'s bit for
    bit, their later steps on (a)'s plan lie within CTL_REPEAT_TOL of
    (a)'s, and (c)'s pp 1 steps within TRAIN_LOSS_TOL (bf16, another
    route).  Returns (its summary, the launches)."""
    gc.collect()
    torch.cuda.empty_cache()
    d = Path(tempfile.mkdtemp(prefix="repro-ctl-"))
    try:
        return _phase_controller(smi, d)
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _obs_args(d: Path, tag: str):
    return [a for f in OBS_FLAGS
            for a in (f"--{f}", str(d / f"{tag}.{OBS_FILES[f]}"))]


def _phase_controller(smi: str, d: Path):
    L, n = TRAIN_LAYERS, CTL_STEPS
    kind, inject = CTL_DEGRADE.split(":")[0], int(
        CTL_DEGRADE.partition("@")[2])
    launches: dict = {}

    def tally(tag, summary, plans):
        got = summary["kernel_launches"]
        want = dict.fromkeys(got, 0)
        want.update(_segment_launches(L, plans, n))
        log(f"[ctl] {tag} launches {got} expected {want} (plans "
            f"{plans})")
        assert got == want, (tag, got, want)
        assert all(map(math.isfinite, summary["rank_losses"][0])), summary
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    # (a) the controller on its own, every obs output on
    a = _cli_run("adapt", d, ["--steps", str(n), "--adapt", "--degrade",
                              CTL_DEGRADE] + _obs_args(d, "adapt"))
    first = a["adapt_events"]
    acts = [e["action"] for e in first]
    assert "trigger" in acts and "migrate" in acts, acts
    mig = next(e for e in first if e["action"] == "migrate")
    trig = next(e for e in first if e["action"] == "trigger")
    detect = mig["step"] - inject
    log(f"[ctl] adapt on {smi}: injected {CTL_DEGRADE} at step {inject}, "
        f"trigger at step {trig['step']} ({trig['detail']}), migrate at "
        f"step {mig['step']}: {detect} steps from the injection to the "
        f"controller's migrate event; plan {mig['detail']['plan']}; "
        f"moves {a['moves']}; step s {a['step_s']}")
    assert detect > 0, (inject, mig)
    start_plan = _first_plan(d / "adapt.log")
    tally("adapt", a, [(0, start_plan), (mig["step"],
                                         mig["detail"]["plan"])])
    out = _validate("validate_obs.py", "--expect-replan", "--trace",
                    str(d / "adapt.trace.json"), "--metrics",
                    str(d / "adapt.metrics.jsonl"), "--events",
                    str(d / "adapt.events.jsonl"))
    log(f"[ctl] adapt artifacts: {out}")
    # (b) the same steps with every obs output off
    b = _cli_run("adapt-no-obs", d, ["--steps", str(inject), "--adapt"])
    on, off = a["step_s"][1:inject], b["step_s"][1:inject]
    on_s, off_s = sorted(on)[len(on) // 2], sorted(off)[len(off) // 2]
    log(f"[ctl] obs overhead on {smi}: pp step s (steps 1-{inject - 1}, "
        f"median) with every obs output {on_s:.4f} ({on}) against none "
        f"{off_s:.4f} ({off}): {100 * (on_s / off_s - 1):+.2f}%")
    ref = a["rank_losses"][0]
    _hold_losses("adapt-no-obs", b["rank_losses"][0], ref,
                 [(inject, CTL_REPEAT_TOL)])
    got = b["kernel_launches"]
    want = dict.fromkeys(got, 0)
    want.update(_segment_launches(L, [(0, start_plan)], inject))
    assert got == want, ("adapt-no-obs", got, want)
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    # (c) an island leaves and comes back
    c = _cli_run("elastic", d, [
        "--steps", str(n), "--lose", f"{kind}@{CTL_LOSE}", "--join",
        f"{kind}@{CTL_JOIN}"] + _obs_args(d, "elastic"))
    migs = [e for e in c["adapt_events"] if e["action"] == "migrate"]
    shapes = [_plan_shape(start_plan)[0]] + [
        _plan_shape(e["detail"]["plan"])[0] for e in migs]
    log(f"[ctl] elastic on {smi}: pp {' -> '.join(map(str, shapes))} at "
        f"steps {[e['step'] for e in migs]}; moves "
        + "; ".join(f"{m.get('sent_bytes', 0) / 1e9:.3f} GB sent, "
                    f"{m['move_s']:.4f} s (checkpoint {m['ckpt_s']:.4f} s)"
                    for m in c["moves"])
        + f"; step s {c['step_s']}")
    assert shapes == [2, 1, 2], shapes
    lost, joined = (e["step"] for e in migs)
    assert joined <= mig["step"], (joined, mig)   # (a) still on start_plan
    _hold_losses("elastic", c["rank_losses"][0], ref,
                 [(lost, CTL_REPEAT_TOL), (joined, TRAIN_LOSS_TOL)])
    tally("elastic", c, [(0, start_plan)] + [
        (e["step"], e["detail"]["plan"]) for e in migs])
    out = _validate("validate_elastic.py", "--events",
                    str(d / "elastic.events.jsonl"), "--run-log",
                    str(d / "elastic.log"))
    log(f"[ctl] elastic: {out}")
    out = _validate("validate_obs.py", "--expect-replan", "--trace",
                    str(d / "elastic.trace.json"), "--metrics",
                    str(d / "elastic.metrics.jsonl"), "--events",
                    str(d / "elastic.events.jsonl"))
    log(f"[ctl] elastic artifacts: {out}")
    summary = {"batch": CTL_BATCH, "layers": L, "steps": n,
               "adapt": {"inject_step": inject, "trigger_step": trig["step"],
                         "migrate_step": mig["step"],
                         "steps_to_migrate": detect,
                         "plan": mig["detail"]["plan"],
                         "step_s": a["step_s"], "moves": a["moves"],
                         "peak_mem_gb": a["peak_mem_gb"],
                         "losses": a["rank_losses"][0]},
               "obs_overhead": {"on_step_s": on, "off_step_s": off,
                                "on_median_s": on_s, "off_median_s": off_s},
               "elastic": {"pp": shapes, "steps": [e["step"] for e in migs],
                           "moves": c["moves"], "step_s": c["step_s"],
                           "peak_mem_gb": c["peak_mem_gb"],
                           "losses": c["rank_losses"][0]},
               "start_plan": start_plan}
    log(f"[ctl] report {json.dumps(summary)}")
    return summary, launches


def _hold_losses(tag: str, losses, ref, spans) -> None:
    """Step 0 of ``losses`` equal to ``ref``'s bit for bit, and every later
    step before ``end`` within ``tol`` of ``ref``'s, for each ``(end, tol)``
    of ``spans`` in order, each span starting where the last ended."""
    assert all(map(math.isfinite, losses)), (tag, losses)
    assert losses[0] == ref[0], (tag, losses[0], ref[0])
    start = 1
    for end, tol in spans:
        diffs = [abs(a - b) for a, b in zip(losses[start:end],
                                            ref[start:end])]
        log(f"[ctl] {tag} losses {losses[start:end]} vs adapt's "
            f"{ref[start:end]} (steps {start}-{end - 1}): diffs {diffs} "
            f"(tol {tol})")
        assert len(diffs) == end - start, (tag, losses, ref)
        assert max(diffs, default=0.0) < tol, (tag, diffs)
        start = end


def _first_plan(log_path: Path) -> str:
    """The plan a CLI run started on, from its ``[train] plan:`` line."""
    for line in log_path.read_text().splitlines():
        if line.startswith("[train] plan: "):
            return line[len("[train] plan: "):]
    raise RuntimeError(f"{log_path}: no [train] plan line")


# ------------------------------------------------------------ phase 6b ---
PROFILE_SEQS, PROFILE_MBS = (TRAIN_SEQ,), (1,)
PROFILE_WARMUP, PROFILE_REPS = 2, 5
KERNEL_SEQS, KERNEL_MBS = (128,), (1, 2)   # the runner's --quick shapes


def _probe_launches(depths, calls: int) -> dict:
    """Launches of ``calls`` forward calls and ``calls`` step calls of the
    reference loss at each depth: a forward launches rmsnorm 2L+1, swiglu
    L and flash L times; a step runs each block's forward twice (remat),
    rmsnorm 4L+1, swiglu and flash 2L times, and the backward kernels."""
    out = {}
    for L in depths:
        for k, n in (("rmsnorm", (2 * L + 1) + (4 * L + 1)),
                     ("swiglu", 3 * L), ("flash_attention", 3 * L),
                     ("rmsnorm_bwd", 2 * L + 1), ("swiglu_bwd", L),
                     ("ring_step_bwd", L)):
            out[k] = out.get(k, 0) + n * calls
    return out


def phase_plan(torch, dev, ref: dict):
    """The port's profile runner, predictor and planner on the card,
    against phase 6's measured reference step ``ref``."""
    from repro_torch.core import cluster as C
    from repro_torch.core import planner
    from repro_torch.core.plan import ParallelPlan, StagePlacement
    from repro_torch.core.predictor import PerformancePredictor
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.profile import (PROFILE_DIR, ProfiledCostModel,
                                     ProfileStore, runner)

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kind = runner.device_kind(dev)
    store = ProfileStore()
    calls = PROFILE_WARMUP + PROFILE_REPS
    ops.reset_launch_counts()
    runner.bench_layers(store, kind, "llama3-8b", seqs=PROFILE_SEQS,
                        micro_bss=PROFILE_MBS, tp=1, warmup=PROFILE_WARMUP,
                        reps=PROFILE_REPS, verbose=False, smoke=False,
                        device=dev)
    launches = ops.launch_counts()
    expect = dict.fromkeys(launches, 0)
    expect.update(_probe_launches((1, 2), calls * len(PROFILE_SEQS)
                                  * len(PROFILE_MBS)))
    log(f"[plan] bench_layers launches {launches} expected {expect}")
    assert launches == expect, (launches, expect)
    ops.reset_launch_counts()
    runner.bench_kernels(store, kind, KERNEL_SEQS, KERNEL_MBS, warmup=1,
                         reps=3, verbose=False, device=dev)
    k_launches = ops.launch_counts()
    k_expect = dict.fromkeys(k_launches, 0)
    n = 4 * len(KERNEL_SEQS) * len(KERNEL_MBS)   # (1 + 3) fwd, then grad
    k_expect.update(rmsnorm=2 * n, rmsnorm_bwd=n, swiglu=2 * n,
                    swiglu_bwd=n, flash_attention=2 * n, ring_step_bwd=n)
    log(f"[plan] bench_kernels launches {k_launches} expected {k_expect}")
    assert k_launches == k_expect, (k_launches, k_expect)
    path = store.save(PROFILE_DIR / f"{kind}.json")
    shape = {"arch": "llama3-8b", "seq_len": TRAIN_SEQ, "micro_bs": 1,
             "tp": 1}
    step = store.get(kind, "layer_step", shape).value
    probes = {e.shape["n_layers"]: e.value
              for e in store.entries(kind, "loss_probe")}
    log(f"[plan] {kind} layer_step S{TRAIN_SEQ}: fwd_s {step['fwd_s']!r} "
        f"bwd_s {step['bwd_s']!r}; loss probes {json.dumps(probes)}; "
        f"{len(store)} entries -> {path}")
    assert step["fwd_s"] > 0 and step["bwd_s"] > 0, step

    cfg = registry.get_config("llama3-8b", num_layers=TRAIN_LAYERS)
    card = C.ClusterSpec(groups=(C.NodeGroup(C.H100, 1, accel_per_node=1),))
    src = ProfiledCostModel(store, device_map={C.H100.name: kind})
    plan = ParallelPlan(
        stages=(StagePlacement(0, TRAIN_LAYERS, 1, 1, True),), micro_bs=1,
        global_batch=1, seq_len=TRAIN_SEQ)
    prof = PerformancePredictor(card, cfg, cost_source=src).predict(plan)
    ana = PerformancePredictor(card, cfg).predict(plan)
    steady = ref["step_s"][1:]
    measured = sum(steady) / len(steady)
    for name, pr in (("profiled", prof), ("analytic", ana)):
        log(f"[plan] {name} prediction {plan.describe()}: iter_time "
            f"{pr.iter_time!r} s vs measured {measured!r} s (ratio "
            f"{pr.iter_time / measured!r}); peak_mem_gb "
            f"{pr.peak_mem_gb[0]!r} vs measured {ref['peak_mem_gb']!r}; "
            f"mfu {pr.mfu!r}; fits {pr.fits}")
        assert math.isfinite(pr.iter_time) and pr.iter_time > 0, pr
        assert pr.fits, pr
    assert src.hits > 0, "the profile served no layer time"
    res = planner.search(card, cfg, global_batch=1, seq_len=TRAIN_SEQ,
                         tp_options=[1], pp_options=[1], cost_source=src)
    got = (res.plan.pp, res.plan.stages[0].tp, res.plan.dp, res.plan.cp)
    log(f"[plan] planner on one H100: {res.plan.describe()}, iter_time "
        f"{res.prediction.iter_time!r} s, mfu {res.prediction.mfu!r}, "
        f"{res.evaluated} evaluated")
    assert got == (1, 1, 1, 1), got
    mfu = (cfg.flops_per_token(TRAIN_SEQ) * 3 * TRAIN_SEQ
           / (measured * C.H100.peak_tflops * 1e12))
    log(f"[plan] measured Eq. 2 MFU {mfu!r} (H100 preset {C.H100.mfu})")
    secs = time.perf_counter() - t0
    log(f"[plan] phase took {secs:.1f} s")
    summary = {
        "device_kind": kind, "layer_step": step, "loss_probe": probes,
        "measured_step_s": measured, "measured_peak_gb": ref["peak_mem_gb"],
        "profiled": {"iter_time": prof.iter_time, "mfu": prof.mfu,
                     "peak_mem_gb": prof.peak_mem_gb[0]},
        "analytic": {"iter_time": ana.iter_time, "mfu": ana.mfu,
                     "peak_mem_gb": ana.peak_mem_gb[0]},
        "search": {"plan": res.plan.describe(),
                   "iter_time": res.prediction.iter_time,
                   "mfu": res.prediction.mfu},
        "measured_mfu": mfu, "seconds": secs,
    }
    total = {k: launches[k] + k_launches[k] for k in launches}
    return summary, total


# ------------------------------------------------------------- phase 7 ---
def phase_device_times(torch):
    """Each timed row's device time from a torch.profiler trace, taken in
    a child process (``--device-times``): once CUPTI has traced a process
    its later kernel launches stay slower, so the profiler never runs in
    this one, whose serve and train phases are bound by the host."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--device-times"], capture_output=True, text=True,
                       timeout=900)
    if r.returncode != 0:
        print(r.stdout[-8000:], r.stderr[-8000:], sep="\n", file=sys.stderr)
        raise RuntimeError(f"device-time child exited {r.returncode}")
    times = json.loads(r.stdout.strip().splitlines()[-1])
    log(f"[device] profiler child: {time.perf_counter() - t0:.1f} s")
    return times


def device_times_main(torch, dev) -> int:
    """The child of phase 7: phase 3's checks and rows again, each row's
    profiler device time alone, as one JSON line."""
    from repro_torch.utils.timing import device_ms
    name = torch.cuda.get_device_name(dev)
    _, timed, extra = phase_kernels(torch, dev, name, device_only=True)
    _, train_timed, train_extra = phase_train_kernels(torch, dev, name,
                                                      device_only=True)
    timed.update(train_timed)
    timed.update(phase_griffin_kernels(torch, dev, name,
                                       device_only=True)[1])
    timed.update(phase_encdec_kernels(torch, dev, name,
                                      device_only=True)[1])
    timed.update(phase_vlm_kernels(torch, dev, name, device_only=True)[1])
    times = dict(timed, flash_attention_S4096=extra["flash_attention_S4096"],
                 **train_extra)
    one = torch.zeros(1, device=dev)
    times["floor_ms"] = device_ms(lambda: one.zero_(), iters=100)
    print(json.dumps(times))
    return 0


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    elif isinstance(node, list):
        for v in node:
            yield from _leaves(v)
    else:
        yield node


# ---------------------------------------------------------------- main ---
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", type=Path, default=None,
                    help="also write the checks and timings here as JSON")
    ap.add_argument("--device-times", action="store_true",
                    help="phase 7's child: print the rows' profiler device "
                         "times as one JSON line, and nothing else runs")
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
    t_start = time.perf_counter()
    global CP_CHUNKS
    from repro_torch.core.segmentation import cp_split
    CP_CHUNKS = tuple(cp_split(TRAIN_SEQ, TRAIN_CP, **CP_SPLIT))
    assert sum(CP_CHUNKS) == TRAIN_SEQ, CP_CHUNKS
    global CP_RANKS_CHUNKS
    CP_RANKS_CHUNKS = tuple(cp_split(TRAIN_SEQ, CP_RANKS, **CP_SPLIT))
    assert sum(CP_RANKS_CHUNKS) == TRAIN_SEQ, CP_RANKS_CHUNKS
    # fp32 references in full fp32 (no TF32) on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    if args.device_times:
        return device_times_main(torch, dev)
    for sig in (signal.SIGTERM, signal.SIGHUP):
        signal.signal(sig, _stop)
    from repro_torch.kernels.ops import LAUNCH_COUNTERS

    smi, name = phase_card(torch)
    log(f"[plan] cp chunks from cp_split({TRAIN_SEQ}, {TRAIN_CP}, "
        f"{CP_SPLIT}): {CP_CHUNKS}")
    build_s, build_info = phase_build()
    checks, timed, extra = phase_kernels(torch, dev, name)
    train_checks, train_timed, train_extra = phase_train_kernels(
        torch, dev, name)
    checks += train_checks
    timed.update(train_timed)
    extra["rel_readings"] += train_extra.pop("rel_readings")
    extra.update(train_extra)
    t_griffin = time.perf_counter()
    g_checks, g_timed, g_extra = phase_griffin_kernels(torch, dev, name)
    checks += g_checks
    timed.update(g_timed)
    extra["rel_readings"] += g_extra.pop("rel_readings")
    extra.update(g_extra)
    log(f"[kernels] recurrentgemma-9b's kernels and the RG-LRU: "
        f"{time.perf_counter() - t_griffin:.1f} s")
    t_new = time.perf_counter()
    e_checks, e_timed, e_extra = phase_encdec_kernels(torch, dev, name)
    checks += e_checks
    timed.update(e_timed)
    extra["rel_readings"] += e_extra.pop("rel_readings")
    log(f"[kernels] whisper-tiny's attention without causality: "
        f"{time.perf_counter() - t_new:.1f} s")
    t_new = time.perf_counter()
    v_checks, v_timed, _ = phase_vlm_kernels(torch, dev, name)
    checks += v_checks
    timed.update(v_timed)
    log(f"[kernels] phi-3-vision-4.2b's attention at hd 96: "
        f"{time.perf_counter() - t_new:.1f} s")
    t_new = time.perf_counter()
    model_err = {arch: phase_model(torch, dev, arch)
                 for arch in SERVE_ARCHS + MODEL_ARCHS}
    log(f"[model] phase 4 ({len(model_err)} archs): "
        f"{time.perf_counter() - t_new:.1f} s")
    serve, launches = {}, dict.fromkeys(LAUNCH_COUNTERS, 0)
    for arch in SERVE_ARCHS:
        t_cell = time.perf_counter()
        serve[arch], counts = phase_serve(torch, dev, arch)
        for kname, n in counts.items():
            launches[kname] += n
        if arch in SERVE_LAYERS or arch == GRIFFIN_ARCH:
            r = serve[arch]
            log(f"[serve] {arch} ({r['layers']} layers) on {smi}: TTFT s "
                f"{r['ttft_s']}, TPOT s {r['tpot_s']}, decode tok/s "
                f"{r['decode_tok_per_s']:.1f}, peak {r['peak_mem_gb']:.2f} "
                f"GB; cell {time.perf_counter() - t_cell:.1f} s")
    # the enc-dec and VLM cells, driven through their bundles
    t_new = time.perf_counter()
    serve[ED_ARCH], counts, ed_rows = phase_serve_encdec(torch, dev, smi)
    for kname, n in counts.items():
        launches[kname] += n
    log(f"[serve] {ED_ARCH} cell: {time.perf_counter() - t_new:.1f} s")
    t_new = time.perf_counter()
    serve[VLM_ARCH], counts = phase_serve_vlm(torch, dev, smi)
    for kname, n in counts.items():
        launches[kname] += n
    log(f"[serve] {VLM_ARCH} cell: {time.perf_counter() - t_new:.1f} s")
    # rmsnorm's and swiglu's two rows: their launches inside decode steps
    # (8 rows or fewer), and the rest (prefills and training)
    decode = {k: sum(serve[a]["decode_launches"][k]
                     for a in SERVE_ARCHS + MODEL_ARCHS)
              for k in ("rmsnorm", "swiglu")}
    # flash's row at danube's prefill shape takes that cell's launches,
    # its hd-256 row at recurrentgemma-9b's prefill shape that cell's
    swa_flash = serve["h2o-danube-3-4b"]["launches"]["flash_attention"]
    griffin_flash = serve[GRIFFIN_ARCH]["launches"]["flash_attention"]
    serve_cli = phase_serve_cli(torch)
    train_parity = phase_train_parity(torch, dev)
    train = {}
    for route in ("cp", "reference"):
        train[route], counts = phase_train(torch, dev, route)
        for kname, n in counts.items():
            launches[kname] += n
    # the reference cell with every block's activations kept (the route
    # before remat): the same forward, so step 0's loss bit for bit; later
    # steps part by the dq atomics' order (CTL_REPEAT_TOL)
    kept, counts = phase_train(torch, dev, "reference", remat=False)
    for kname, n in counts.items():
        launches[kname] += n
    train["reference no-remat"] = kept
    rem = train["reference"]
    log(f"[train] reference cell, remat off / on: step s {kept['step_s']} / "
        f"{rem['step_s']}, tok/s {kept['tok_s_steady']:.1f} / "
        f"{rem['tok_s_steady']:.1f}, peak GB {kept['peak_mem_gb']:.2f} / "
        f"{rem['peak_mem_gb']:.2f}, losses {kept['losses']} / "
        f"{rem['losses']}")
    assert kept["losses"][0] == rem["losses"][0], (kept["losses"],
                                                   rem["losses"])
    assert max(abs(a - b) for a, b in zip(kept["losses"], rem["losses"])) \
        < CTL_REPEAT_TOL, (kept["losses"], rem["losses"])
    for arch, seq in NEW_TRAIN:
        train[arch], counts = phase_train(torch, dev, "reference",
                                          arch=arch, seq=seq)
        for kname, n in counts.items():
            launches[kname] += n
    # the ssm stack and MoE: falcon-mamba-7b on the reference route and
    # through a pp 2 plan, mixtral-8x7b on the reference route
    t_new = time.perf_counter()
    train[SSM_ARCH], counts = phase_train(
        torch, dev, "reference", arch=SSM_ARCH, layers=SSM_TRAIN_LAYERS,
        hold_loss0=True)
    for kname, n in counts.items():
        launches[kname] += n
    train[f"{SSM_ARCH} pp"], counts = phase_train_ssm_pp(torch, dev, smi,
                                                         train[SSM_ARCH])
    for kname, n in counts.items():
        launches[kname] += n
    train[MOE_TRAIN_ARCH], counts = phase_train(
        torch, dev, "reference", arch=MOE_TRAIN_ARCH,
        layers=MOE_TRAIN_LAYERS, hold_loss0=True)
    for kname, n in counts.items():
        launches[kname] += n
    log(f"[train] falcon-mamba-7b and mixtral-8x7b cells: "
        f"{time.perf_counter() - t_new:.1f} s")
    # the hybrid stack: recurrentgemma-9b at 5 layers on the reference
    # route, its flash forward and backward at hd 256 over one KV head
    t_new = time.perf_counter()
    train[GRIFFIN_ARCH], counts = phase_train(
        torch, dev, "reference", arch=GRIFFIN_ARCH,
        layers=GRIFFIN_TRAIN_LAYERS, hold_loss0=True)
    for kname, n in counts.items():
        launches[kname] += n
    log(f"[train] recurrentgemma-9b cell: {time.perf_counter() - t_new:.1f}"
        f" s")
    griffin_train = train[GRIFFIN_ARCH]["launches"]
    # the enc-dec stack and the VLM: whisper-tiny at full depth, then
    # phi-3-vision at full depth and through a pp 2 plan
    t_new = time.perf_counter()
    train[ED_ARCH], counts, rows = phase_train_encdec(torch, dev, smi)
    for kname, n in counts.items():
        launches[kname] += n
    ed_rows = {k: n + rows[k] for k, n in ed_rows.items()}
    log(f"[train] {ED_ARCH} cell: {time.perf_counter() - t_new:.1f} s")
    t_new = time.perf_counter()
    train[VLM_ARCH], counts = phase_train_vlm(torch, dev, smi)
    for kname, n in counts.items():
        launches[kname] += n
    train[f"{VLM_ARCH} pp"], counts = phase_train_vlm_pp(torch, dev, smi)
    for kname, n in counts.items():
        launches[kname] += n
    log(f"[train] {VLM_ARCH} cells: {time.perf_counter() - t_new:.1f} s")
    # danube's flash forward and backward run at hd 120: their rows
    swa_train = train["h2o-danube-3-4b"]["launches"]
    train["pp"], counts = phase_train_pp(torch, dev, smi)
    for kname, n in counts.items():
        launches[kname] += n
    d, fs = _ckpt_dir(Path("/dev/shm"), "pp_ranks' checkpoint",
                      host_copies=2, name=_shm_name())
    try:
        train["pp_ranks"], counts = phase_train_pp_ranks(
            torch, dev, smi, train["pp"], ckpt_dir=d)
        for kname, n in counts.items():
            launches[kname] += n
        train["ckpt pp"], counts = phase_ckpt_pp(
            torch, dev, smi, d, fs, train["pp"], train["pp_ranks"])
        for kname, n in counts.items():
            launches[kname] += n
    finally:
        shutil.rmtree(d, ignore_errors=True)
    d, fs = _ckpt_dir(Path(tempfile.gettempdir()),
                      "the reference cell's checkpoint", host_copies=2)
    try:
        train["ckpt"], counts = phase_ckpt(torch, dev, smi, d, fs)
        for kname, n in counts.items():
            launches[kname] += n
    finally:
        shutil.rmtree(d, ignore_errors=True)
    train["tp_ranks"], counts = phase_train_tp_ranks(torch, dev, smi,
                                                     train["reference"])
    for kname, n in counts.items():
        launches[kname] += n
    train["cp_ranks"], counts = phase_train_cp_ranks(torch, dev, smi)
    for kname, n in counts.items():
        launches[kname] += n
    train["pp vpp"], counts = phase_train_pp(torch, dev, smi, vpp=2)
    for kname, n in counts.items():
        launches[kname] += n
    train["pp_ranks vpp"], counts = phase_train_pp_ranks(
        torch, dev, smi, train["pp vpp"], hop=False)
    for kname, n in counts.items():
        launches[kname] += n
    train[f"reference b{DP_RANKS}"], counts = phase_train(
        torch, dev, "reference", global_batch=DP_RANKS, moves=True)
    for kname, n in counts.items():
        launches[kname] += n
    train["dp_ranks"], counts = phase_train_dp_ranks(
        torch, dev, smi, train[f"reference b{DP_RANKS}"])
    for kname, n in counts.items():
        launches[kname] += n
    train["controller"], counts = phase_controller(torch, smi)
    for kname, n in counts.items():
        launches[kname] += n
    l_cp, l_ref = train["cp"]["losses"][0], train["reference"]["losses"][0]
    log(f"[train] step-0 loss cp {l_cp} vs reference {l_ref}: "
        f"diff {abs(l_cp - l_ref):.3e} (tol {TRAIN_LOSS_TOL})")
    assert abs(l_cp - l_ref) < TRAIN_LOSS_TOL, (l_cp, l_ref)
    plan, counts = phase_plan(torch, dev, train["reference"])
    for kname, n in counts.items():
        launches[kname] += n
    device = phase_device_times(torch)
    floor = device["floor_ms"]
    log(f"[device] launch floor (zero_ of a one-element tensor): "
        f"{floor:.4f} ms")
    for kname, t in list(timed.items()) + [
            ("flash_attention_S4096", extra["flash_attention_S4096"])]:
        t.update(device[kname])
        t["floors"] = t["device_ms"] / floor
        lib = t["library_device_ms"]
        log(f"[device] {kname:15s} {t['shape']}: device "
            f"{t['device_ms']:.4f} ms (events {t['ms']:.4f} ms), "
            f"{t['floors']:.2f} floors"
            + (" (at its floor)" if t["floors"] <= AT_FLOOR else "")
            + (f"; library device {lib:.4f} ms (events "
               f"{t['library_ms']:.4f} ms)" if lib is not None else ""))
    runs = timed["rmsnorm_bwd"]["runs_a_call"]
    log(f"[device] rmsnorm_bwd runs a call: {runs}")
    assert (sum(runs.values()) == 1
            and all("rmsnorm_bwd_ring_kernel" in k for k in runs)), runs
    extra["ring_step_bwd_cp4_per_launch_device_ms"] = device[
        "ring_step_bwd_cp4_per_launch_device_ms"]
    hd120_flash = swa_flash + swa_train["flash_attention"]
    row_launches = {
        "flash_attention": (launches["flash_attention"] - hd120_flash
                            - griffin_flash
                            - griffin_train["flash_attention"]),
        "flash_attention hd120": hd120_flash,
        "flash_attention hd256": griffin_flash,
        "flash_attention hd256 lse": griffin_train["flash_attention"],
        "ring_step_bwd": (launches["ring_step_bwd"]
                          - swa_train["ring_step_bwd"]
                          - griffin_train["ring_step_bwd"]),
        "ring_step_bwd hd120": swa_train["ring_step_bwd"],
        "ring_step_bwd hd256": griffin_train["ring_step_bwd"]}
    # whisper-tiny's non-causal rows (its causal self-attention and its
    # other backwards stay in the general rows)
    for kname, n in ed_rows.items():
        row_launches[kname.split()[0]] -= n
    row_launches.update(ed_rows)
    # phi-3-vision-4.2b's hd-96 rows: its serve cell's prefills, its
    # reference train run (its pp route's S1024 stays in the general rows)
    vlm_train = train[VLM_ARCH]["launches"]
    vlm_rows = {
        "flash_attention hd96": serve[VLM_ARCH]["launches"]["flash_attention"],
        "flash_attention hd96 lse": vlm_train["flash_attention"],
        "ring_step_bwd hd96": vlm_train["ring_step_bwd"]}
    for kname, n in vlm_rows.items():
        row_launches[kname.split()[0]] -= n
    row_launches.update(vlm_rows)
    for k, n in decode.items():
        row_launches[k], row_launches[f"{k} decode"] = launches[k] - n, n

    worst = {}
    for c in checks:
        worst[c["kernel"]] = max(worst.get(c["kernel"], 0.0),
                                 c["max_abs_err"])
    line = []
    for kname, t in timed.items():
        if not t["line"]:
            continue
        line.append({k: t[k] for k in (
            "name", "route", "source", "replaces", "shape")}
            | {"launches": row_launches.get(kname, launches[t["name"]]),
               "max_abs_err": t["max_abs_err"], "device_ms": t["device_ms"],
               "ms": t["ms"], "plain_ms": t["plain_ms"],
               "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
               "library_ms": t["library_ms"],
               "library_device_ms": t["library_device_ms"],
               "floor_ms": floor})
    report = {"card": smi, "device_name": name, "build_s": build_s,
              "build": build_info,
              "checks": checks, "worst_err_by_kernel": worst,
              "timed": timed, "timed_extra": extra,
              "model_max_abs_err": model_err, "serve": serve,
              "serve_cli": serve_cli,
              "train_parity": train_parity, "train": train, "plan": plan,
              "launches": launches}
    report["wall_s"] = time.perf_counter() - t_start
    log(f"[done] chip_smoke.py in {report['wall_s']:.1f} s")
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
