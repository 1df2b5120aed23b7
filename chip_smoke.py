#!/usr/bin/env python3
"""Smoke test of the PyTorch port of SPIN on one NVIDIA card.

    python3 chip_smoke.py [--report PATH]

Run from the root of a checkout.  Every phase that fails raises, and the
script then exits non-zero without its last line.  Phases:

1. the card (name, power limit, torch and CUDA versions);
2. the build of every CUDA kernel under src/repro_torch/kernels/csrc (one
   nvcc per source, in parallel), with ptxas' registers and spills of
   every kernel entry;
3. kernel checks: each kernel against its plain PyTorch version on the
   card, at the head geometries of the serving path (LLaMA-7B verify
   H=Kh=32 D=128; SSM decode H=12 D=64 and H=16 D=96), with bf16, int8, fp8
   and float32 pools, linear and tree masks, and edge cases (idle rows,
   padding queries, trailing padding entries, ancestor bit 31; for the
   dense kernels interleaved packed segments with contexts up to 230
   tokens, ~2000-slot buffers in the dense plan's 128-cell rows (split-KV
   over 16 runs), padding cells, rows of length 0, cache lengths not a
   multiple of 32; for fused_paged_decode's split layout draft steps at B
   = 1 and 6 over rows of 0 to 64 blocks and block sizes 8 and 32; for
   fused_paged_verify and paged_verify_attention block lists in no order,
   of 1, 17 and 64 entries, block sizes 8 and 32, and fused_paged_verify
   at dbrx's GQA group 6, both at the benchmark cells' verify shapes
   (``CELL_VERIFY``) and on the 4096-entry long-context list; for
   decode_attention rows of 2048 to 8190 slots
   at B = 1 and 4, split over runs of tiles and merged; for
   paged_decode_attention the same long rows read through a block table,
   unequal int8 rows, block sizes 8 (fp8) and 64 (bf16) with rows ending
   mid-block and mid-tile, and LLaMA-616M's draft rows);
4. the paged main path: the port's SpinEngine serving the mix workload with
   LLaMA-7B (32 layers, full width) and the SSMs LLaMA-68M/265M/616M at
   full width, random bf16 weights, paged bf16 KV, fused kernels on.  An
   untimed pass warms every shape up and keeps the kernels' largest
   inputs; then ``TIMED_RUNS`` timed runs, the kernels' launch counts set
   to 0 before and read after each (the first is the main path's run);
   then one run under ``torch.profiler`` for the device's busy time, read
   against the timed runs' wall time; then layer 0's q/k/v of one seeded
   2048-token prompt for phase 12;
5. the dense main path: the same zoo and workload on the dense KV layout
   (``kv_layout="dense"``, packed verify through ``verify_attention``, 32
   launches per slot); one untimed pass keeping the kernel's largest
   input, three timed runs (launch counts as in phase 4);
6. losslessness in float32 with the LLM cut to 4 layers.  With the
   reference initializer, the fused and the gather (``fused_kernels
   off``) paths are both held against plain greedy decoding and their
   first divergences reported; with the q/k projections at fan_in =
   d_model (see ``unit_attention``) the fused path's tokens, and then the
   dense layout's, must equal greedy decoding (a mismatch passes only
   where the reference's top-2 logit gap is below 1e-4);
7. chunked prefill (64-token chunks) with int8 KV and tree speculation at
   reduced LLM depth, so that chunk appends (T > W + 1), the dequant path
   and the tree-masked verify launch;
8. the ops path: the public kernel API (``kernels/ops.py``) of the three
   kernels no serving path runs, on the main paths' data: the paged main
   path's largest verify call (``paged_verify_attention``, the same inputs
   as ``fused_paged_verify``), the first query of its largest decode call
   (``paged_decode_attention``) and the last layer of LLaMA-7B's dense K/V
   grid as phase 5's untimed pass left it, each row at its last request's
   length, with a seeded random query (``decode_attention``), launch counts
   as in phase 4;
9. the MoE window path: mixtral-8x22b at published widths (d 6144, 48/8
   heads, 8 experts top-2, window 4096, vocab 32768), depth cut to 4 of 56
   layers, with the SSM zoo at the LLM's vocabulary, random bf16 weights;
   its window sends the engine to the dense layout (plain windowed
   attention, as the reference), its experts run dropless through
   ``ops.moe_experts``; one untimed run keeping that kernel's largest
   input and three timed runs (launch counts as in phase 4, the kernel
   required); ``moe_experts`` held against its plain version on that
   input; then layer 0's q/k/v of one seeded 6144-token prompt (longer
   than the window) for phase 12;
10. the MoE paged path: dbrx-132b at published widths (16 experts top-4,
   vocab 100352), 2 of 40 layers, paged bf16 KV, fused kernels (GQA group
   6); one untimed pass keeping the kernels' largest inputs, three timed
   runs (launch counts as in phase 4, ``moe_experts`` required), then
   ``fused_paged_verify``, ``fused_paged_decode`` and ``moe_experts`` held
   against their plain versions on those inputs;
11. losslessness of mixtral-8x22b in float32 (1 layer, dense fallback,
   unit-scale attention; its experts on ``moe_experts``' float32 kernel),
   against plain greedy decoding as in phase 6; then ``moe_experts`` at
   Trinity-Mini's widths (d 2048, ff 1024, 128 experts, top-8; 1, 95 and
   640 tokens in bf16, 95 in float32) against its plain version, timed
   beside its bound;
12. ``flash_attention``: check shapes (bf16 on the tensor-core kernel,
   float32 on the CUDA-core one; D 64/96/128, GQA groups 1/6/7/8, B 1 and
   2, windows of 7 and 32 keys and wider, S below one 64-key tile and not
   a multiple of it) against its plain version; then
   ``ops.flash_attention`` on layer 0 of mixtral (S = 6144, window 4096)
   and of LLaMA-7B (S = 2048, phase 4's model), launch counts as in phase
   4, each also held against ``layers.attention`` and timed;
13. timing of each kernel on the largest call its path made (its own
   inputs, kept in phases 4, 5, 8 and 12; this timing runs last):
   kernel, plain version and one PyTorch library call
   (scaled_dot_product_attention, a yardstick the port never calls), each
   the median of individually timed launches with the L2 cache flushed
   before each; and the bound, the larger of the
   bytes over 3.35 TB/s and the operations over the peak rate of the input
   type.  ``fused_paged_verify`` and ``paged_verify_attention`` (the same
   function) are timed on the same input, the paged path's largest
   verify call, and printed side by side; ``paged_decode_attention`` is
   timed on its GQA 6, 8190-slot check beside ``decode_attention`` on the
   same K/V content as a dense cache, on one ``same content`` line;
14. the fleet path (right after phase 4, on its zoo): the router
   (``serving/router.py``) over two paged replicas sharing LLaMA-7B and
   the SSMs, built by the serve launcher's ``build_fleet``, aggregate
   capacity 6 split 3/3, fused kernels on, 8 requests of the mix
   workload at scale 0.3 with Poisson arrivals; policy lot, then p2c
   with work stealing and the classes prefill,decode.  Each fleet serves
   an untimed pass that keeps both fused kernels' largest calls, then a
   timed run: per replica requests, slots and wall ms per slot, fleet
   tokens/s and the launches of ``fused_paged_verify`` and
   ``fused_paged_decode`` per fleet slot (counts set to 0 before the run
   and read after); then each kept call against its plain version, timed
   as in phase 13;
15. the fleet's losslessness (after phase 6): LLaMA-7B at 4 layers,
   float32, unit-scale attention, two replicas, p2c with stealing; every
   request's tokens against plain greedy decoding (phase 6's gap rule);
16. the engine-free speculation API: ``spec_iteration`` over dense
   caches with phase 15's LLM and LLaMA-68M at full width as the SSM,
   three prompts; the emitted tokens against plain greedy decoding;
17. training (after phase 12): ``launch/train.py`` on qwen2-0.5b at
   published widths and depth, float32, batch 8, sequence 128, 30 steps
   uninterrupted, then 30 with a checkpoint every 10 and a failure
   injected at step 15 that resumes from step 9's checkpoint (losses
   held to the uninterrupted run's at ``TRAIN_RTOL``); the global
   gradient norm at the launcher's init and at unit-scale attention; at
   unit-scale attention, 30 steps of the launcher's step function,
   optimizer and schedule, the loss on held-out batches falling by
   ``TRAIN_DROP_SE`` standard errors; then each ``remat`` mode: its
   gradients at the init against none's, and two steps from the init
   whose second loss (it reads the first step's update) is held to
   none's; ms of the second step and peak memory;
18. tile configs (after phase 14, on phase 4's zoo): ``kernels/autotune``
   tunes every key of ``TUNE_KEYS`` (LLaMA-7B verify and decode, the three
   SSMs' decode, bf16 KV, and LLaMA-7B in int8) on the card into this
   run's cache (``TUNE_CACHE``; every other phase runs with it empty, on
   the kernels' own plans), each on two calls: phase 4's largest call
   where the key is its geometry, else the synthetic pool, and a
   long-context call (``LONG_VERIFY_LENS``: a list of 4096 entries;
   ``LONG_DECODE_LENS``: rows of 32k and 4k tokens); every candidate held
   to the plain version on both before it may win; kept: a candidate that
   beats the default on both calls by more than its spread, else the
   default; one ``autotune`` line a key (every candidate's times and
   error, the fastest, the config kept); the configs kept for #1 and #2
   beside the default on phase 4's largest calls (``tuned on the path's
   largest call`` lines) and on the long-context calls (``tile configs on
   a long-context call`` lines: error and time of each); a paged serving
   pass whose engine reads the tuned cache (its configs, cache hits,
   launches, wall ms per slot); float32 losslessness at 4 layers on the
   tuned cache;
19. the sharded fleet (after phase 15, on its zoo): a lot fleet without
   meshes, then with each replica under ``use_rules`` on its 1x1 CUDA
   sub-mesh (``launch.mesh``, a world-1 process group) and
   ``serve_rules()``: tokens and router stats must be equal, #1 and #2
   launched;
20. the dry-run (host only; started after the build, each cell list in a
   process of its own beside the card's phases, read after phase 17):
   ``launch/dryrun.py`` on ``DRYRUN_CELLS`` (qwen2-0.5b x decode_32k on
   the 16x16 and 2x16x16 fake meshes, and x prefill_32k on 2x16x16, a
   cell whose last-token gather has the batch on two mesh dims and whose
   14 query heads the model dim does not divide; mixtral-8x22b x
   train_4k and x decode_32k on 16x16, its MoE grid and gathers); each
   record and its seconds; every cell ``ok`` and its per-device counts
   under ``DRYRUN_BOUNDS``;
21. the trained zoo (before phase 17): ``examples/train_distill_ssm_torch``
   trains the LLM and the five SSMs of its capacity ladder (4 heads of D
   = d_model / 4 = 4 .. 32, float32) on the card, each model's steps,
   final loss and seconds; the mix workload (``ZOO_REQUESTS`` requests)
   served through the paged engine, fused kernels on, LBSS over all five
   SSMs, with the trained zoo and with the same configs at random init:
   per SSM, LBSS's selections and the acceptance on easy and on hard
   requests (a first reading, not held to a limit); every request
   finishes and #1 and #2 launch; the trained zoo's tokens against its
   LLM's greedy decoding (phase 6's gap rule); the serving launcher
   (``launch/serve.main(..., zoo=...)``) on it.  Phase 3 also checks #1
   and #2 at the zoo's geometries (``ZOO_HEAD_DIMS``, bf16 and float32
   K/V; bf16 at D 4 and 12 on the scalar path).

The last three lines are the kernels JSON, the card line of
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import dataclasses
import inspect
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
# imported here, not at the sharded fleet's first constrain call, so that
# no timed run pays for the import
import torch.distributed.tensor  # noqa: E402,F401
import torch.nn.functional as F  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import registry, spin_llama  # noqa: E402
from repro_torch.core import spec_decode as sd  # noqa: E402
from repro_torch.data.pipeline import TokenStream  # noqa: E402
from repro_torch.data.workloads import make_workload  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.kernels import (autotune, build, cases,  # noqa: E402
                                 decode_attention, flash_attention,
                                 fused_decode, fused_verify, ops,
                                 moe_experts, paged_attention, quant,
                                 verify_attention)
from repro_torch.kernels.ref import tree_mask_term  # noqa: E402
from repro_torch.launch import mesh, train  # noqa: E402
from repro_torch.launch.serve import build_fleet, make_engine  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.layers import (attention, embed,  # noqa: E402
                                       rms_norm)
from repro_torch.models.params import tensor_leaves  # noqa: E402
from repro_torch.optim import AdamW, cosine_schedule  # noqa: E402
from repro_torch.serving.engine import EngineConfig  # noqa: E402
from repro_torch.serving.pool import DenseCachePool  # noqa: E402
from repro_torch.serving.router import Router, RouterConfig  # noqa: E402

HBM_BYTES_PER_S = 3.35e12                      # H100 SXM data sheet
TIMED_RUNS = 3
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
CSRC = "src/repro_torch/kernels/csrc/"
# name -> (source, the TPU kernel it replaces, the path that launches it)
SOURCES = {
    "fused_paged_verify": (CSRC + "fused_verify.cu",
                           "src/repro/kernels/fused_verify.py:43", "paged"),
    "fused_paged_decode": (CSRC + "fused_decode.cu",
                           "src/repro/kernels/fused_decode.py:41", "paged"),
    "verify_attention": (CSRC + "verify_attention.cu",
                         "src/repro/kernels/verify_attention.py:37", "dense"),
    "decode_attention": (CSRC + "decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:25", "ops"),
    "paged_decode_attention": (CSRC + "paged_attention.cu",
                               "src/repro/kernels/paged_attention.py:56",
                               "ops"),
    "paged_verify_attention": (CSRC + "paged_attention.cu",
                               "src/repro/kernels/paged_attention.py:178",
                               "ops"),
    "flash_attention": (CSRC + "flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:23", "flash"),
}
# paged_decode_attention's checks of runs of tiles: (kv, lengths, H, Kh,
# D, block size, label)
PAGED_DECODE_ROWS = (
    ("bf16", [4001], 32, 32, 128, 16, "llama-7b B=1 4001 slots"),
    ("bf16", [8190], 48, 8, 128, 16, "GQA 6 Kh 8 B=1 8190 slots"),
    ("f32", [1999], 32, 32, 128, 16, "llama-7b B=1 1999 slots"),
    ("int8", [0, 1, 700, 2048], 32, 32, 128, 16,
     "llama-7b B=4 rows 0/1/700/2048"),
    ("fp8", [0, 37, 700, 2047], 32, 32, 128, 8,
     "llama-7b bs=8 rows 0/37/700/2047"),
    ("bf16", [63, 0, 700, 4095], 48, 8, 128, 64,
     "GQA 6 Kh 8 bs=64 rows 63/0/700/4095"),
    ("bf16", [0, 15, 47, 79, 1023, 20], 16, 16, 96, 16,
     "llama-616m B=6 rows 0/15/47/79/1023/20"))
# the check phase 13 also times beside decode_attention on the same K/V
# content as a dense cache
SAME_CONTENT = ("paged_decode_attention", "GQA 6 Kh 8 B=1 8190 slots bf16")
# the MoE paths' depth cuts: layers of the published 56 (mixtral) and 40
# (dbrx) that one card holds beside the SSMs, in bf16
MIXTRAL_LAYERS, DBRX_LAYERS = 4, 2
# the fleet paths: requests of the mix workload (scale 0.3) with Poisson
# arrivals at this rate (requests per sim-clock second), over two replicas
# splitting an aggregate capacity of 6
FLEET_REQUESTS, FLEET_RATE, FLEET_CAPACITY = 8, 300.0, 6
# the train phase: qwen2-0.5b at published widths and depth, float32;
# steps, checkpoint interval, the injected failure's step, and the
# relative tolerance of the resumed run's losses against an uninterrupted
# run's (backward kernels on a GPU need not be bitwise deterministic);
# peak learning rate (the launcher's default) and warmup (sized for 30
# steps); the held-out batches (stream steps from TRAIN_EVAL_FROM on) and
# the standard errors of their mean by which training must lower their
# loss; the remat modes' tolerances against none: gradients (max
# |g - g_none| over max(1, max |g_none|), per leaf) and the second step's
# loss (relative)
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAIL_AT, TRAIN_RTOL = 30, 10, 15, 1e-3
TRAIN_LR, TRAIN_WARMUP = 3e-4, 5
TRAIN_EVAL, TRAIN_EVAL_FROM, TRAIN_DROP_SE = 16, 1000, 5.0
REMAT_GRAD_TOL, REMAT_RTOL = 1e-4, 1e-5
PAGED = [n for n, (_, _, path) in SOURCES.items() if path == "paged"]
# the tile configs' cache of this run (the engines read it through
# autotune.CACHE_PATH): empty for every phase but the autotune phase, so
# the others launch the kernels' own plans
TUNE_CACHE = os.path.join(ROOT, "build", "smoke_tune_cache.json")
# the autotune phase's keys: kind, (H, Kh, D), kv dtype; gamma_max 4 and
# block size 16 as the serving paths.  LLaMA-7B verify and decode, the
# three SSMs' decode (their drafts and catch-up), bf16 KV; LLaMA-7B in int8
TUNE_GAMMA, TUNE_BS = 4, 16
TUNE_KEYS = [("verify", (32, 32, 128), "bf16"),
             ("decode", (32, 32, 128), "bf16"),
             ("decode", (12, 12, 64), "bf16"),
             ("decode", (16, 16, 64), "bf16"),
             ("decode", (16, 16, 96), "bf16"),
             ("verify", (32, 32, 128), "int8"),
             ("decode", (32, 32, 128), "int8")]
# the autotune phase's long-context calls: LLaMA-7B verify over six
# requests of 2.5-8k tokens (2093 live blocks of 16, a list of 4096
# entries with its padding), LLaMA-616M's draft step over rows of 32k
# and 4k tokens
LONG_VERIFY_LENS = [8000, 6500, 5000, 7000, 4500, 2500]
# the benchmark cells' verify calls for the kernel checks: (model,
# requests, query heads), 8 kv heads, D 128
CELL_VERIFY = [("qwen2.5-14b", 128, 40), ("internlm2-20b", 64, 48)]
LONG_DECODE_LENS = [32767, 4095]
# the dry-run phase's cells (arch, shape, meshes), each in a process of
# its own (its fake 512-rank group): qwen2-0.5b's decode on both
# production meshes (the whole table is launch/dryrun.py --all)
DRYRUN_CELLS = [("qwen2-0.5b", "decode_32k", ["--both-meshes"]),
                ("qwen2-0.5b", "prefill_32k", ["--multi-pod"]),
                ("mixtral-8x22b", "train_4k", []),
                ("mixtral-8x22b", "decode_32k", [])]
# per-device counts a cell must stay under, keyed (arch, shape, 2x16x16):
# the distribution layer's layouts that do each device's share of the
# work (the MoE grid on its shards, the cheaper of the MoE gathers' two
# layouts, query heads split where the model dim does not divide them);
# each bound is a reading of the dry-run table on torch 2.11 before those
# layouts (PERF.md section 6): mixtral train_4k 2511 TFLOP (7187 with the
# grid's gradient at full size), its decode 4.465 GB of collectives;
# qwen2 prefill_32k, 190.7 TFLOP on 16x16 with its heads replicated, 40
DRYRUN_BOUNDS = {("mixtral-8x22b", "train_4k", False): {"flops": 2511e12},
                 ("mixtral-8x22b", "decode_32k", False):
                     {"collective_bytes": 4.465e9},
                 ("qwen2-0.5b", "prefill_32k", True): {"flops": 40e12}}
# the trained zoo's head dims (examples/train_distill_ssm_torch.py: 4 heads
# of d_model / 4 for d 16, 32, 48, 64, 96 and the LLM's 128) and context
# lengths of its requests for the kernel checks
ZOO_HEAD_DIMS = (4, 8, 12, 16, 24, 32)
ZOO_LENS = [30, 75, 0, 12, 50, 96]
# phase 21's workload: mix requests at t = 0, split into easy and hard by
# their difficulty (data/workloads.py: cp 0.05, cip 0.45, alpaca 0.85)
ZOO_REQUESTS, ZOO_SCALE, ZOO_CAPACITY, ZOO_HARD = 24, 0.5, 8, 0.5


def log(*a):
    print(*a, flush=True)


def check(ok, msg):
    """A failed check ends the run (a plain ``assert`` vanishes under -O)."""
    if not ok:
        raise RuntimeError(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ------------------------------------------------------------- timing --

class Timer:
    """Device time of one call: the median over individually timed calls
    (CUDA events), with the L2 cache flushed before each (the serving path
    finds a layer's KV cold).  A spin kernel holds the device while the
    host enqueues every repetition, so no event pair spans host time
    (Python argument checks, launch latency): each reads what the device
    spent on the call's own kernels."""

    def __init__(self, reps=15, spin_cycles=300_000_000):
        self.reps = reps
        self.spin_cycles = spin_cycles                # ~0.15 s at 2 GHz
        self.flush = torch.empty(32 << 20, dtype=torch.float32,
                                 device="cuda")   # 128 MB > 50 MB of L2

    def __call__(self, fn) -> float:
        fn()
        torch.cuda.synchronize()
        for _ in range(3):
            ev = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(self.reps)]
            spun = torch.cuda.Event()
            torch.cuda._sleep(self.spin_cycles)
            spun.record()
            for s, e in ev:
                self.flush.zero_()
                s.record()
                fn()
                e.record()
            host_ahead = not spun.query()    # still spinning: host was ahead
            torch.cuda.synchronize()
            if host_ahead:
                return statistics.median(s.elapsed_time(e) for s, e in ev)
            self.spin_cycles *= 4
        raise RuntimeError("the host could not enqueue the timed calls "
                           "ahead of the device")


# ---------------------------------------------------- bounds, library --

def _kv_slot_bytes(a, Kh, D):
    per = Kh * D * a["k_pool"].element_size() * 2 + 8      # K, V, seg, pos
    return per + (Kh * 8 if a["k_scale"] is not None else 0)


def verify_work(a):
    """(bytes, operations) the verify function needs on these inputs: the
    live blocks' K/V (+ scales, seg, pos) once, the query side and the
    block list once, the output once; 4 D ops per (query head, attended
    slot), slots counted per segment."""
    Tq, H, D = a["q"].shape
    bs, Kh = a["k_pool"].shape[1], a["k_pool"].shape[2]
    M = a["block_ids"].shape[0]
    owner = a["block_owner"].cpu()
    live = owner >= 0
    nbytes = (int(live.sum()) * bs * _kv_slot_bytes(a, Kh, D) + M * 8
              + Tq * 4 * (3 if a["q_anc"] is not None else 2)
              + (M * bs * 4 if a["block_node"] is not None else 0)
              + 2 * a["q"].numel() * a["q"].element_size())
    per_seg = torch.bincount(owner[live].long(),
                             minlength=int(a["q_seg"].max()) + 2) * bs
    qs = a["q_seg"].cpu().long()
    slots = int(per_seg[qs[qs >= 0]].sum())
    return nbytes, 4 * D * H * slots


def _segment_slots(kv_seg, q_seg):
    """Attended slots summed over the queries (each query meets the slots
    of its own segment; causality not subtracted) and the slots of the
    segments some query carries."""
    kv_seg, q_seg = kv_seg.cpu().long(), q_seg.cpu().long()
    n = int(max(kv_seg.max(), q_seg.max())) + 2
    per_seg = torch.bincount(kv_seg[kv_seg >= 0], minlength=n)
    qs = q_seg[q_seg >= 0]
    return int(per_seg[qs].sum()), int(per_seg[torch.unique(qs)].sum())


def dense_verify_work(a):
    """verify_attention: the K/V of the segments the queries carry, every
    slot's tags, the query side and the output once."""
    Tq, H, D = a["q"].shape
    Tkv, Kh = a["k"].shape[:2]
    attended, cells = _segment_slots(a["kv_seg"], a["q_seg"])
    ntags = 3 if a["q_anc"] is not None else 2
    nbytes = (cells * Kh * D * a["k"].element_size() * 2
              + (Tkv + Tq) * 4 * ntags
              + 2 * a["q"].numel() * a["q"].element_size())
    return nbytes, 4 * D * H * attended


def dense_decode_work(a):
    B, H, D = a["q"].shape
    S, Kh = a["k"].shape[1:3]
    live = int(a["lengths"].cpu().clamp(0, S).sum())
    nbytes = (live * Kh * D * a["k"].element_size() * 2 + B * 4
              + 2 * a["q"].numel() * a["q"].element_size())
    return nbytes, 4 * D * H * live


def paged_decode_work(a):
    B, H, D = a["q"].shape
    bs, Kh = a["k_pool"].shape[1], a["k_pool"].shape[2]
    lens = a["lengths"].cpu().clamp(min=0)
    live = int(lens.sum())
    per = (Kh * D * a["k_pool"].element_size() * 2
           + (Kh * 8 if a["k_scale"] is not None else 0))
    blocks = int(torch.div(lens + bs - 1, bs, rounding_mode="floor").sum())
    nbytes = (live * per + blocks * 4 + B * 4
              + 2 * a["q"].numel() * a["q"].element_size())
    return nbytes, 4 * D * H * live


def decode_work(a):
    B, T, H, D = a["q"].shape
    bs, Kh = a["k_pool"].shape[1], a["k_pool"].shape[2]
    bt = a["block_tables"].cpu()
    uniq = torch.unique(bt[bt >= 0]).numel()
    nbytes = (uniq * bs * _kv_slot_bytes(a, Kh, D) + bt.numel() * 4
              + B * T * 8 + 2 * a["q"].numel() * a["q"].element_size())
    slots = int((bt >= 0).sum()) * bs
    return nbytes, 4 * D * H * T * slots


def bound(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _gathered(a, ids):
    out = []
    for leaf in ("k", "v"):
        g = a[leaf + "_pool"][ids]
        sc = a[leaf + "_scale"]
        g = (quant.dequantize(g, sc[ids], a["q"].dtype) if sc is not None
             else g.to(a["q"].dtype))
        out.append(g)
    return out


def library_verify(a):
    """One SDPA call computing the packed verify on the gathered K/V
    (boolean Eq. 13 mask); the gather is set-up, outside the timing."""
    owner = a["block_owner"]
    live = owner >= 0
    ids = a["block_ids"][live].long()
    bs = a["k_pool"].shape[1]
    k, v = (t.reshape(-1, *t.shape[2:]) for t in _gathered(a, ids))
    own = owner[live].repeat_interleave(bs)
    kv_seg = torch.where(a["pool_seg"][ids].reshape(-1) >= 0, own, -1)
    kv_pos = a["pool_pos"][ids].reshape(-1)
    mask = ((a["q_seg"][:, None] == kv_seg[None]) & (kv_seg[None] >= 0)
            & (kv_pos[None] <= a["q_pos"][:, None]))
    if a["block_node"] is not None:
        mask &= tree_mask_term(a["q_anc"][:, None],
                               a["block_node"][live].reshape(-1)[None])
    G = a["q"].shape[1] // k.shape[1]
    q = a["q"].transpose(0, 1)[None]
    k = k.repeat_interleave(G, 1).transpose(0, 1)[None]
    v = v.repeat_interleave(G, 1).transpose(0, 1)[None]
    m = mask[None, None]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=m)


def library_decode(a):
    bt = a["block_tables"]
    B, NB = bt.shape
    bs = a["k_pool"].shape[1]
    g = bt.clamp(min=0).long()
    k, v = (t.reshape(B, NB * bs, *t.shape[3:]) for t in _gathered(a, g))
    live = torch.repeat_interleave(bt >= 0, bs, dim=1)
    kv_seg = torch.where(live, a["pool_seg"][g].reshape(B, -1), -1)
    kv_pos = a["pool_pos"][g].reshape(B, -1)
    mask = ((a["q_seg"][:, :, None] == kv_seg[:, None])
            & (kv_seg[:, None] >= 0)
            & (kv_pos[:, None] <= a["q_pos"][:, :, None]))
    G = a["q"].shape[2] // k.shape[2]
    q = a["q"].transpose(1, 2)
    k = k.repeat_interleave(G, 2).transpose(1, 2)
    v = v.repeat_interleave(G, 2).transpose(1, 2)
    m = mask[:, None]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=m)


def library_dense_verify(a):
    """One SDPA call on the flat buffer with the boolean Eq. 13 mask."""
    kv_seg, kv_pos = a["kv_seg"], a["kv_pos"]
    mask = ((a["q_seg"][:, None] == kv_seg[None]) & (kv_seg[None] >= 0)
            & (kv_pos[None] <= a["q_pos"][:, None]))
    if a["kv_node"] is not None:
        mask &= tree_mask_term(a["q_anc"][:, None], a["kv_node"][None])
    G = a["q"].shape[1] // a["k"].shape[1]
    q = a["q"].transpose(0, 1)[None]
    k = a["k"].to(a["q"].dtype).repeat_interleave(G, 1).transpose(0, 1)[None]
    v = a["v"].to(a["q"].dtype).repeat_interleave(G, 1).transpose(0, 1)[None]
    m = mask[None, None]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=m)


def _library_dense_decode(q, k, v, lengths):
    B, S = k.shape[:2]
    G = q.shape[1] // k.shape[2]
    mask = (torch.arange(S, device=q.device)[None] < lengths[:, None])
    q = q[:, :, None]
    k = k.to(q.dtype).repeat_interleave(G, 2).transpose(1, 2)
    v = v.to(q.dtype).repeat_interleave(G, 2).transpose(1, 2)
    m = mask[:, None, None]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=m)


def library_dense_decode(a):
    return _library_dense_decode(a["q"], a["k"], a["v"], a["lengths"])


def library_paged_decode(a):
    """SDPA on the rows' blocks gathered dense (the gather is set-up)."""
    bt = a["block_tables"]
    B, NB = bt.shape
    bs = a["k_pool"].shape[1]
    k, v = (t.reshape(B, NB * bs, *t.shape[3:])
            for t in _gathered(a, bt.clamp(min=0).long()))
    return _library_dense_decode(a["q"], k, v, a["lengths"])


def flash_work(a):
    """q, k, v and the output once; 4 D operations per (query head,
    attended key), the keys counted under the causal mask and window."""
    B, S, H, D = a["q"].shape
    t = torch.arange(S, dtype=torch.float64)
    keys = t + 1 if not a["window"] else torch.clamp(t + 1, max=a["window"])
    nbytes = (2 * a["q"].numel() + 2 * a["k"].numel()) * a["q"].element_size()
    return nbytes, 4 * D * H * B * int(keys.sum())


def library_flash(a):
    """SDPA on (B, H, S, D) with GQA-expanded K/V: ``is_causal`` without a
    window, a boolean (S, S) mask with one (the expansion and the mask are
    set-up, outside the timing)."""
    q = a["q"].transpose(1, 2)
    G = q.shape[1] // a["k"].shape[2]
    k, v = (a[n].repeat_interleave(G, 2).transpose(1, 2) for n in "kv")
    if not a["window"]:
        return lambda: F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=True)
    i = torch.arange(q.shape[2], device=q.device)
    m = (i[None] <= i[:, None]) & (i[None] > i[:, None] - a["window"])
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=m)


# name -> (kernel wrapper, plain version, work counter, library call)
KERNELS = {
    "fused_paged_verify": (fused_verify.fused_paged_verify,
                           fused_verify.fused_paged_verify_plain,
                           verify_work, library_verify),
    "fused_paged_decode": (fused_decode.fused_paged_decode,
                           fused_decode.fused_paged_decode_plain,
                           decode_work, library_decode),
    "verify_attention": (verify_attention.verify_attention,
                         verify_attention.verify_attention_plain,
                         dense_verify_work, library_dense_verify),
    "decode_attention": (decode_attention.decode_attention,
                         decode_attention.decode_attention_plain,
                         dense_decode_work, library_dense_decode),
    "paged_decode_attention": (paged_attention.paged_decode_attention,
                               paged_attention.paged_decode_attention_plain,
                               paged_decode_work, library_paged_decode),
    "paged_verify_attention": (paged_attention.paged_verify_attention,
                               paged_attention.paged_verify_attention_plain,
                               verify_work, library_verify),
    "flash_attention": (flash_attention.flash_attention,
                        flash_attention.flash_attention_plain, flash_work,
                        library_flash),
}


def measure(name, a, timer):
    """Error against the plain version, and kernel / plain / library /
    bound times, on one set of inputs."""
    kern, plain, work, library = KERNELS[name]
    before = build.LAUNCHES[name]
    out = kern(**a)
    torch.cuda.synchronize()
    check(build.LAUNCHES[name] == before + 1, f"{name} did not launch")
    ref = plain(**a)
    err = (out.float() - ref.float()).abs().max().item()
    ref_max = ref.float().abs().max().item()
    scale = max(1.0, ref_max)
    # bf16 outputs: both round an f32 result, so they may differ by an ulp
    tol = (2.0 ** -6 if out.dtype == torch.bfloat16 else 1e-4) * scale
    ok = bool(torch.isfinite(out.float()).all()) and err <= tol
    nbytes, ops = work(a)
    b_ms, b_by = bound(nbytes, ops, a["q"].dtype)
    lib = library(a)
    rec = dict(max_abs_err=err, ref_max=ref_max, tol=tol, ok=ok,
               ms=timer(lambda: kern(**a)), plain_ms=timer(lambda: plain(**a)),
               library_ms=timer(lib), bound_ms=b_ms, bound_by=b_by,
               bytes=nbytes, ops=ops)
    build.LAUNCHES[name] = before        # comparison launches do not count
    return rec


def shape_of(a):
    kv = a.get("k_pool", a.get("k"))
    return {n: list(t.shape) for n, t in a.items() if t is not None
            and n in ("q", "k_pool", "k", "block_ids", "block_tables")} | {
        "kv": str(kv.dtype).replace("torch.", ""),
        "tree": (a.get("block_node") is not None
                 or a.get("kv_node") is not None)} | (
        {"window": a["window"]} if "window" in a else {})


def kernel_check_cases(gen):
    """Every (kernel, label, inputs) of phase 3, made from ``gen`` in a
    fixed order (``tools/torch_ab_paths.py`` saves the same inputs)."""
    lens7b = [37, 180, 95, 12, 230, 61]
    rows = [40, 0, 150, 7, 96, 230]                  # 0 = an idle row
    todo = []
    for kv, tree in (("bf16", False), ("int8", False), ("fp8", True),
                     ("bf16", True), ("f32", False)):
        todo.append(("fused_paged_verify",
                     f"llama-7b {kv} {'tree' if tree else 'linear'}",
                     cases.verify_inputs(gen, lens7b, 4, 32, 32, 128, 16, kv,
                                         tree)))
    for H, D, tag in ((12, 64, "llama-68m"), (16, 96, "llama-616m")):
        for kv in ("bf16", "int8", "fp8"):
            todo.append(("fused_paged_decode", f"{tag} draft T=1 {kv}",
                         cases.decode_inputs(gen, rows, 1, H, H, D, 16, kv)))
        todo.append(("fused_paged_decode", f"{tag} catch-up T=5 bf16",
                     cases.decode_inputs(gen, rows, 5, H, H, D, 16, "bf16")))
    for kv in ("bf16", "int8"):
        todo.append(("fused_paged_decode", f"llama-7b chunk T=64 {kv}",
                     cases.decode_inputs(gen, [87], 64, 32, 32, 128, 16, kv)))
    todo.append(("fused_paged_decode", "llama-7b verify-unpacked T=5 f32",
                 cases.decode_inputs(gen, rows, 5, 32, 32, 128, 16, "f32",
                                     pad_queries=False)))
    # verify_attention: dense packed verify (interleaved segments, padding
    # cells and queries) at the LLaMA-7B and SSM head geometries
    for kv, tree, H, Kh, D, tag in (
            ("bf16", False, 32, 32, 128, "llama-7b"),
            ("f32", False, 32, 32, 128, "llama-7b"),
            ("bf16", True, 32, 32, 128, "llama-7b"),
            ("bf16", True, 16, 8, 96, "llama-616m-geometry GQA 2"),
            ("f32", True, 12, 12, 64, "llama-68m-geometry")):
        todo.append(("verify_attention",
                     f"{tag} {kv} {'tree' if tree else 'linear'}",
                     cases.dense_verify_inputs(gen, lens7b, 4, H, Kh, D, kv,
                                               tree)))
    # split-KV over many tiles: ~2000 slots in the dense plan's 128-cell
    # rows, mostly padding
    plan_lens = [20, 35, 230, 12, 100, 77, 5, 150, 60, 210, 31, 8]
    for kv, tree in (("bf16", False), ("f32", False), ("bf16", True),
                     ("f32", True)):
        todo.append(("verify_attention",
                     f"llama-7b plan rows {kv} "
                     f"{'tree' if tree else 'linear'}",
                     cases.plan_verify_inputs(gen, plan_lens, 4, 32, 32, 128,
                                              kv, tree)))
    dense_lens = [0, 37, 250, 131, 1, 96]     # S = 250: not a multiple of 32
    for kv, H, Kh, D, tag in (("bf16", 32, 32, 128, "llama-7b"),
                              ("f32", 32, 32, 128, "llama-7b"),
                              ("f32", 16, 4, 96, "D 96 GQA 4"),
                              ("bf16", 12, 12, 64, "llama-68m")):
        todo.append(("decode_attention", f"{tag} S=250 {kv}",
                     cases.dense_decode_inputs(gen, dense_lens, 250, H, Kh, D,
                                               kv)))
    for kv in ("bf16", "int8", "fp8"):
        todo.append(("paged_decode_attention", f"llama-7b {kv}",
                     cases.paged_decode_inputs(gen, rows, 32, 32, 128, 16,
                                               kv)))
    todo.append(("paged_decode_attention", "llama-616m bf16",
                 cases.paged_decode_inputs(gen, rows, 16, 16, 96, 16, "bf16")))
    for kv, tree in (("bf16", False), ("int8", False), ("fp8", True),
                     ("bf16", True), ("int8", True)):
        todo.append(("paged_verify_attention",
                     f"llama-7b {kv} {'tree' if tree else 'linear'}",
                     cases.verify_inputs(gen, lens7b, 4, 32, 32, 128, 16, kv,
                                         tree)))
    # fused_paged_decode's split layout (fewer query rows than warps):
    # draft steps at B = 1 and 6 over rows of 0, 1, 3, 5 and 64 blocks
    # (length 16 k - 1 + T = 16 k slots), block sizes 8 and 32
    blocks = [0, 15, 47, 79, 1023, 20]
    for H, D, tag in ((12, 64, "llama-68m"), (16, 96, "llama-616m")):
        todo.append(("fused_paged_decode",
                     f"{tag} draft T=1 B=6 rows of 0/1/3/5/64/2 blocks bf16",
                     cases.decode_inputs(gen, blocks, 1, H, H, D, 16,
                                         "bf16")))
    for L, kv in ((1023, "bf16"), (15, "int8"), (47, "fp8")):
        todo.append(("fused_paged_decode",
                     f"llama-616m draft T=1 B=1 {(L + 1) // 16} blocks {kv}",
                     cases.decode_inputs(gen, [L], 1, 16, 16, 96, 16, kv)))
    for bs, kv in ((8, "bf16"), (32, "int8"), (8, "f32")):
        todo.append(("fused_paged_decode", f"llama-616m draft T=1 bs={bs} "
                     f"{kv}", cases.decode_inputs(gen, rows, 1, 16, 16, 96,
                                                  bs, kv)))
    todo.append(("fused_paged_decode", "llama-68m catch-up T=5 bs=32 bf16",
                 cases.decode_inputs(gen, rows, 5, 12, 12, 64, 32, "bf16")))
    # paged_verify_attention: block lists in no order (owners shuffled,
    # padding entries among them) and of 1, 17 and 64 entries
    for kv, tree, n in (("bf16", False, None), ("int8", True, None),
                        ("fp8", True, 17), ("bf16", True, 1),
                        ("int8", False, 17), ("f32", False, 64)):
        todo.append(("paged_verify_attention",
                     f"llama-7b shuffled entries M={n or 'pow2'} {kv} "
                     f"{'tree' if tree else 'linear'}",
                     cases.verify_inputs(gen, lens7b, 4, 32, 32, 128, 16, kv,
                                         tree, shuffle=True, n_entries=n)))
    for bs, kv in ((8, "bf16"), (32, "fp8")):
        todo.append(("paged_verify_attention",
                     f"llama-7b bs={bs} {kv} tree",
                     cases.verify_inputs(gen, lens7b, 4, 32, 32, 128, bs, kv,
                                         True, shuffle=True)))
    # fused_paged_verify on the run-of-entries kernel: the same edge
    # geometries, and dbrx's (H 48, Kh 8, G 6)
    for kv, tree, n, bs in (
            ("bf16", False, None, 16), ("int8", True, None, 16),
            ("fp8", True, 17, 16), ("bf16", True, 1, 16),
            ("int8", False, 17, 16), ("f32", False, 64, 16),
            ("bf16", True, None, 8), ("fp8", False, None, 32)):
        todo.append(("fused_paged_verify",
                     f"llama-7b shuffled entries M={n or 'pow2'} bs={bs} "
                     f"{kv} {'tree' if tree else 'linear'}",
                     cases.verify_inputs(gen, lens7b, 4, 32, 32, 128, bs, kv,
                                         tree, shuffle=True, n_entries=n)))
    for kv, tree in (("bf16", False), ("int8", True), ("f32", True)):
        todo.append(("fused_paged_verify",
                     f"dbrx-132b G 6 {kv} {'tree' if tree else 'linear'}",
                     cases.verify_inputs(gen, lens7b, 4, 48, 8, 128, 16, kv,
                                         tree)))
    # decode_attention over runs of tiles: long rows at B = 1 (LLaMA-7B's
    # heads, GQA group 6 at Kh 8, float32) and unequal rows at B = 4
    for kv, lens, S, H, Kh, tag in (
            ("bf16", [4001], 4096, 32, 32, "llama-7b B=1"),
            ("bf16", [8190], 8192, 48, 8, "GQA 6 Kh 8 B=1"),
            ("f32", [1999], 2048, 32, 32, "llama-7b B=1"),
            ("bf16", [0, 1, 700, 2048], 2048, 32, 32,
             "llama-7b B=4 rows 0/1/700/2048")):
        todo.append(("decode_attention", f"{tag} S={S} {kv}",
                     cases.dense_decode_inputs(gen, lens, S, H, Kh, 128,
                                               kv)))
    # paged_decode_attention over runs of tiles: the same long rows read
    # through a block table, unequal int8 rows, block sizes 8 and 64 (rows
    # ending mid-block and mid-tile), and LLaMA-616M's draft rows
    for kv, lens, H, Kh, D, bs, tag in PAGED_DECODE_ROWS:
        todo.append(("paged_decode_attention", f"{tag} {kv}",
                     cases.paged_decode_inputs(gen, lens, H, Kh, D, bs, kv)))
    # #1 and #2 at the trained zoo's geometries (phase 21): 4 heads of D =
    # d_model / 4 = 4 .. 32, block size 16; bf16 K/V at D 4 and 12 takes
    # the scalar path (no whole 16-byte vectors a row)
    for D in ZOO_HEAD_DIMS:
        for kv in ("bf16", "f32"):
            todo.append(("fused_paged_verify", f"zoo D={D} {kv} linear",
                         cases.verify_inputs(gen, ZOO_LENS, 4, 4, 4, D, 16,
                                             kv, False)))
            todo.append(("fused_paged_decode", f"zoo D={D} draft T=1 {kv}",
                         cases.decode_inputs(gen, ZOO_LENS, 1, 4, 4, D, 16,
                                             kv)))
    # #1 and #4 at the benchmark cells' verify shapes (Qwen2.5-14B: 128
    # requests x 5 tokens, H 40, Kh 8; InternLM2-20B: 64 x 5, H 48, Kh 8;
    # the chat mix's contexts, owners grouped by row as the pool lists
    # them; one chunk) and on the long-context list (LONG_VERIFY_LENS, 4096
    # entries; split), the same inputs for both
    for tag, n, H in CELL_VERIFY:
        ctx = torch.randint(8, 190, (n,), generator=gen).tolist()
        a = cases.verify_inputs(gen, ctx, 4, H, 8, 128, 16, "bf16", False)
        for name in ("fused_paged_verify", "paged_verify_attention"):
            todo.append((name, f"{tag} cell bf16 linear", a))
    a = cases.verify_inputs(gen, LONG_VERIFY_LENS, 4, 32, 32, 128, 16,
                            "bf16", False)
    for name in ("fused_paged_verify", "paged_verify_attention"):
        todo.append((name, "llama-7b 4096 entries bf16 linear", a))
    return todo


def phase_kernel_checks(timer, report):
    """Returns the inputs of the paged decode's G 6 long-row check
    (:data:`SAME_CONTENT`) for phase 13."""
    todo = kernel_check_cases(torch.Generator().manual_seed(11))
    run_checks(todo, timer, report)
    return next(a for name, label, a in todo
                if (name, label) == SAME_CONTENT)


def dense_of_paged(a):
    """``decode_attention``'s inputs holding a paged decode's K/V content:
    each row's blocks gathered into a (B, NB * bs, Kh, D) cache (bf16 or
    float32 pools; entries < 0 read block 0, as the paged kernel does)."""
    bt = a["block_tables"]
    B, NB = bt.shape
    bs = a["k_pool"].shape[1]
    k, v = (a[n][bt.clamp(min=0).long()].reshape(B, NB * bs,
                                                 *a[n].shape[2:])
            .contiguous() for n in ("k_pool", "v_pool"))
    return dict(q=a["q"], k=k, v=v, lengths=a["lengths"])


def run_checks(todo, timer, report):
    """Each (kernel, label, inputs) against its plain version, timed; one
    ``check`` line each; raises if any disagrees."""
    failed = []
    for name, label, a in todo:
        rec = measure(name, a, timer)
        log(f"check {name} [{label}] shape={json.dumps(shape_of(a))} "
            f"max_abs_err={rec['max_abs_err']:.3g} max|plain|="
            f"{rec['ref_max']:.3g} tol={rec['tol']:.3g} ms={rec['ms']:.4f} "
            f"plain_ms={rec['plain_ms']:.4f} "
            f"library_ms={rec['library_ms']:.4f} "
            f"bound_ms={rec['bound_ms']:.5f} ({rec['bound_by']}, "
            f"share {100 * rec['bound_ms'] / rec['ms']:.2f}%) "
            f"{'ok' if rec['ok'] else 'FAIL'}")
        report["checks"].append(dict(kernel=name, case=label,
                                     shape=shape_of(a), **rec))
        if not rec["ok"]:
            failed.append(f"{name} [{label}]")
    check(not failed, f"kernel checks failed: {failed}")


# ------------------------------------------------------------ serving --

def full_zoo(dtype: str, llm_layers: int = 0, ssm_layers: int = 0,
             llm_cfg=spin_llama.LLAMA_7B):
    """The LLM (``llm_cfg``, published widths, depth cut to ``llm_layers``
    if given) and the SSMs LLaMA-68M/265M/616M at published widths with the
    LLM's vocabulary; random weights from seeds 0 (LLM) and 1-3."""
    def bundle(cfg, seed, layers):
        cfg = dataclasses.replace(cfg, dtype=dtype,
                                  n_layers=layers or cfg.n_layers,
                                  vocab_size=llm_cfg.vocab_size)
        return sd.Bundle(cfg, T.init_params(cfg, seed, device="cuda"))

    llm = bundle(llm_cfg, 0, llm_layers)
    ssms = [bundle(c, i + 1, ssm_layers and min(ssm_layers, c.n_layers))
            for i, c in enumerate(spin_llama.SSM_ZOO[:3])]
    return llm, ssms


def describe(llm, ssms, what):
    return (f"{llm.cfg.name} {llm.cfg.n_layers} layers d {llm.cfg.d_model} "
            f"vocab {llm.cfg.vocab_size}; SSMs "
            + ", ".join(f"{b.cfg.name} ({b.cfg.n_layers}x{b.cfg.d_model})"
                        for b in ssms) + f"; {what}")


def timed_runs(llm, ssms, required=(), check_run=None, **kw):
    """``TIMED_RUNS`` warm runs of ``serve``, the launch counts set to 0
    before and read after each; every kernel in ``required`` must launch,
    and ``check_run(eng, stats, launches)`` may check more.  Returns the
    summary line (launches from the first run)."""
    runs = []
    for _ in range(TIMED_RUNS):
        build.LAUNCHES.clear()
        eng, stats, wall = serve(llm, ssms, 6, 0.3, **kw)
        launches = dict(build.LAUNCHES)
        for name in required:
            check(launches.get(name, 0) > 0, f"{name} never launched")
        if check_run is not None:
            check_run(eng, stats, launches)
        runs.append(dict(wall_s=wall, slots=len(eng.slot_log),
                         accepted_tokens=stats["accepted_tokens"],
                         launches=launches, stats=stats))
    main = runs[0]
    walls = [r["wall_s"] for r in runs]
    line = dict(goodput_sim=main["stats"]["goodput_sim"], wall_s=walls,
                wall_spread=(max(walls) - min(walls))
                / statistics.median(walls),
                tokens_per_s_wall=[r["accepted_tokens"] / r["wall_s"]
                                   for r in runs],
                accepted_tokens=[r["accepted_tokens"] for r in runs],
                slots=[r["slots"] for r in runs],
                finished=main["stats"]["scheduler"]["finished"],
                kv_layout=main["stats"]["kv_layout"],
                launches=main["launches"],
                launches_per_slot={k: v / main["slots"]
                                   for k, v in main["launches"].items()},
                wall_ms_per_slot=statistics.median(
                    r["wall_s"] / r["slots"] for r in runs) * 1e3,
                llm_layers=llm.cfg.n_layers)
    return line


def serve(llm, ssms, n_req, scale, around=None, fused_kernels="on",
          **ecfg_kw):
    """Serve the mix workload to the end; ``around`` (a context manager,
    e.g. a profiler) encloses the run alone."""
    reqs = make_workload("mix", n_req, llm.cfg.vocab_size, seed=0,
                         scale=scale)
    eng = make_engine(llm, ssms, reqs, EngineConfig(
        gamma=4, max_len=256, fused_kernels=fused_kernels, **ecfg_kw))
    eng.add_requests(reqs)
    torch.cuda.synchronize()
    with around or contextlib.nullcontext():
        t0 = time.perf_counter()
        stats = eng.run(max_slots=400)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    unfinished = [r.rid for r in eng.requests.values() if not r.done]
    check(len(eng.requests) == n_req and not unfinished,
          f"unfinished requests {unfinished}")
    return eng, stats, wall


def device_time(prof):
    """The device's busy time in ms (the union of the intervals of every
    kernel, copy and memset it ran) and the device ms and calls per name."""
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end, per = 0.0, float("-inf"), {}
    for s, e, name in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
        us, n = per.get(name, (0.0, 0))
        per[name] = (us + e - s, n + 1)
    return busy / 1e3, {k: (us / 1e3, n) for k, (us, n) in per.items()}


class Tap:
    """Wraps an ``ops`` entry point during a serving run and keeps a copy
    of the arguments of its largest call (by query elements x block-list
    length), for timing and checks on the path's own inputs."""

    def __init__(self, module, attr):
        self.module, self.attr = module, attr
        self.fn = getattr(module, attr)
        self.best, self.size = None, -1

    def __call__(self, *args, **kw):
        bound = inspect.signature(self.fn).bind(*args, **kw)
        bound.apply_defaults()
        a = dict(bound.arguments)
        for tile in ("config", "bq", "bk"):
            a.pop(tile, None)
        lst = next(a[n] for n in ("block_ids", "block_tables", "k") if n in a)
        size = a["q"].numel() * lst.numel()
        if size > self.size:
            self.size = size
            self.best = {n: t.clone() if isinstance(t, torch.Tensor) else t
                         for n, t in a.items()}
        return self.fn(*args, **kw)

    def __enter__(self):
        setattr(self.module, self.attr, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.fn)


class MoeTap(Tap):
    """Tap of ``ops.moe_experts``: keeps its call of the most tokens (the
    expert weights by reference, the rest copied)."""

    def __call__(self, x, ids, weights, w_gate, w_up, w_down):
        if x.shape[0] > self.size:
            self.size = x.shape[0]
            self.best = dict(x=x.clone(), ids=ids.clone(),
                             weights=weights.clone(), w_gate=w_gate,
                             w_up=w_up, w_down=w_down)
        return self.fn(x, ids, weights, w_gate, w_up, w_down)


def moe_work(a):
    """Bytes and operations of one ``moe_experts`` call: the weights of
    the experts its ids touch, once, plus x, ids, weights and the output;
    2 x 3 d ff operations a (token, choice) pair."""
    E, d, ff = a["w_gate"].shape
    el = a["x"].element_size()
    touched = int(torch.unique(a["ids"]).numel())
    nbytes = (3 * touched * d * ff * el + 2 * a["x"].numel() * el
              + a["ids"].numel() * (a["ids"].element_size() + 4))
    return nbytes, 6 * d * ff * a["ids"].numel()


def moe_inputs(T, d, ff, E, k, dtype, seed):
    """Random ``moe_experts`` inputs on the card: each token's k distinct
    experts, weights in (0, 1), matrices of std 1 / sqrt(input width)."""
    g = torch.Generator().manual_seed(seed)
    gc = torch.Generator(device="cuda").manual_seed(seed)

    def mat(*shape):
        return (torch.randn(*shape, generator=gc, device="cuda")
                / math.sqrt(shape[1])).to(dtype)
    ids = torch.stack([torch.randperm(E, generator=g)[:k] for _ in range(T)])
    return dict(x=torch.randn(T, d, generator=gc, device="cuda").to(dtype),
                ids=ids.cuda(), weights=torch.rand(T, k, generator=g).cuda(),
                w_gate=mat(E, d, ff), w_up=mat(E, d, ff),
                w_down=mat(E, ff, d))


def check_moe(label, a, timer, report):
    """``moe_experts`` against its plain version on one input, timed
    beside its bound (the plain version walks its plan on the host, a sync
    a call, so the timer cannot run ahead of it: not timed); one ``check``
    line; raises if they disagree."""
    before = build.LAUNCHES[moe_experts.NAME]
    out = moe_experts.moe_experts(**a)
    torch.cuda.synchronize()
    check(build.LAUNCHES[moe_experts.NAME] == before + 1,
          "moe_experts did not launch")
    ref = moe_experts.moe_experts_plain(**a)
    err = (out.float() - ref.float()).abs().max().item()
    ref_max = ref.float().abs().max().item()
    # both sum float32 products in other orders and round the SwiGLU and
    # the output to bf16: an ulp or two of the largest output (2^-8 each);
    # a wrong expert, row or weight misses by the output's own size
    tol = (2.0 ** -6 if out.dtype == torch.bfloat16 else 1e-4) * max(
        1.0, ref_max)
    ok = bool(torch.isfinite(out.float()).all()) and err <= tol
    nbytes, ops_ = moe_work(a)
    b_ms, b_by = bound(nbytes, ops_, a["x"].dtype)
    ms = timer(lambda: moe_experts.moe_experts(**a))
    build.LAUNCHES[moe_experts.NAME] = before
    E, d, ff = a["w_gate"].shape
    shape = dict(tokens=a["x"].shape[0], d=d, ff=ff, experts=E,
                 top_k=a["ids"].shape[1], dtype=str(a["x"].dtype)[6:])
    log(f"check moe_experts [{label}] shape={json.dumps(shape)} "
        f"max_abs_err={err:.3g} max|plain|={ref_max:.3g} tol={tol:.3g} "
        f"ms={ms:.4f} bound_ms={b_ms:.5f} ({b_by}, "
        f"share {100 * b_ms / ms:.2f}%) {'ok' if ok else 'FAIL'}")
    report["checks"].append(dict(
        kernel=moe_experts.NAME, case=label, shape=shape, max_abs_err=err,
        ref_max=ref_max, tol=tol, ok=ok, ms=ms, bound_ms=b_ms, bound_by=b_by, bytes=nbytes, ops=ops_))
    check(ok, f"moe_experts [{label}] disagrees with its plain version")


def phase_main_path(report):
    llm, ssms = full_zoo("bfloat16")
    log("main path: " + describe(llm, ssms, "bf16 weights, paged bf16 KV"))
    # untimed: the first use of every shape, and the kernels' inputs
    taps = {"fused_paged_verify": Tap(ops, "fused_paged_verify"),
            "fused_paged_decode": Tap(ops, "fused_paged_decode")}
    with taps["fused_paged_verify"], taps["fused_paged_decode"]:
        serve(llm, ssms, 6, 0.3, capacity=6)
    captured = {n: t.best for n, t in taps.items()}
    line = timed_runs(llm, ssms, PAGED, capacity=6)

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    eng, _, prof_wall = serve(llm, ssms, 6, 0.3, capacity=6, around=prof)
    busy_ms, per_name = device_time(prof)
    check(busy_ms > 0, "the profiler saw no device activity")
    busy_slot = busy_ms / len(eng.slot_log)
    line.update(device_busy_ms_per_slot=busy_slot,
                device_busy_share=busy_slot / line["wall_ms_per_slot"],
                profiled_wall_ms_per_slot=prof_wall * 1e3 / len(eng.slot_log),
                depth_cut=False,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    log("main path stats (warm; launches from the first timed run; device "
        "busy time from a profiled run, over the timed runs' wall time) "
        + json.dumps(line))
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])
    shown = top[:8] + [kv for kv in top[8:] if "spin::" in kv[0]]
    by_kernel = {k[:90]: {"device_ms": ms, "calls": n} for k, (ms, n) in shown}
    log("main path device ms by kernel (profiled run) "
        + json.dumps(by_kernel))
    report["main_path"] = line
    report["main_path_device_ms_by_kernel"] = by_kernel
    # flash_attention's LLaMA-7B input: layer 0 of this model
    qkv = layer0_qkv(llm, 2048, seed=7)
    del eng, prof
    torch.cuda.empty_cache()
    return (line["launches"], captured, line["wall_ms_per_slot"], qkv,
            (llm, ssms))


def dense_inputs(llm, ssms):
    """One untimed dense-layout run of the workload; returns the largest
    ``verify_attention`` call's inputs and phase 8's ``decode_attention``
    input: the LLM's last layer of K/V as the run left it, each row with
    the length its last request had, and a seeded random query."""
    evict, row_len = DenseCachePool.evict, {}

    def keep_length(pool, rid):
        if pool.cfg is llm.cfg:
            row = pool.row_of[rid]
            row_len[row] = int(pool.lengths[row])
        evict(pool, rid)

    DenseCachePool.evict = keep_length
    try:
        with Tap(ops, "verify_attention") as tap:
            eng, _, _ = serve(llm, ssms, 6, 0.3, capacity=6,
                              kv_layout="dense", fused_kernels="off")
    finally:
        DenseCachePool.evict = evict
    check(any(row_len.values()), "no dense LLM row was evicted")
    cache, top = eng.llm_pool.cache, llm.cfg.n_layers - 1
    B, _, Kh, D = cache["k"][top].shape
    grid = dict(
        q=torch.randn((B, llm.cfg.n_heads, D),
                      generator=torch.Generator().manual_seed(5))
        .to(cache["k"].dtype).to(cache["k"].device),
        k=cache["k"][top].clone(), v=cache["v"][top].clone(),
        lengths=torch.tensor([row_len.get(b, 0) for b in range(B)],
                             dtype=torch.int32, device=cache["k"].device))
    return tap.best, grid


def phase_dense_main_path(report, paged_ms_per_slot):
    """The main path's zoo and workload on the dense KV layout: packed
    verify through ``verify_attention`` on every LLM layer of every slot,
    drafts and catch-up in plain PyTorch over the dense grids."""
    llm, ssms = full_zoo("bfloat16")
    log("dense main path: " + describe(llm, ssms,
                                       "bf16 weights, dense bf16 KV"))
    kw = dict(capacity=6, kv_layout="dense", fused_kernels="off")
    captured, grid = dense_inputs(llm, ssms)

    def check_run(eng, stats, launches):
        verified = sum(1 for rec in eng.slot_log if rec.get("active"))
        check(stats["kv_layout"] == "dense", "the engine did not go dense")
        check(launches.get("verify_attention", 0)
              == verified * llm.cfg.n_layers > 0,
              f"verify_attention launched {launches} times over {verified} "
              f"verify slots of {llm.cfg.n_layers} layers")
        check(set(launches) == {"verify_attention"},
              f"the dense path launched other kernels: {launches}")

    line = timed_runs(llm, ssms, check_run=check_run, **kw)
    line.update(paged_wall_ms_per_slot=paged_ms_per_slot, depth_cut=False)
    log("dense main path stats (warm; launches from the first timed run; "
        "paged wall ms per slot from this call's phase 4) "
        + json.dumps(line))
    report["dense_main_path"] = line
    del llm, ssms
    torch.cuda.empty_cache()
    return line["launches"], captured, grid


def greedy_reference(llm, prompt, n_new):
    """Plain LLM greedy decoding through the dense cache (no kernels);
    returns the tokens and each step's top-2 logit gap."""
    P = len(prompt)
    toks = torch.as_tensor(np.asarray(prompt, np.int32), device="cuda")[None]
    lengths = torch.tensor([P], dtype=torch.int32, device="cuda")
    lg, cache = llm.prefill(toks, lengths, P + n_new + 8)
    V = llm.cfg.vocab_size
    row = lg[0, P - 1, :V].float()
    out, gaps = [], []
    for step in range(n_new):
        top = torch.topk(row, 2).values
        gaps.append(float(top[0] - top[1]))
        tok = int(torch.argmax(row))
        out.append(tok)
        if step == n_new - 1:
            break
        lg, cache = llm.decode(cache, torch.tensor([[tok]], dtype=torch.int32,
                                                   device="cuda"), lengths)
        lengths = lengths + 1
        row = lg[0, -1, :V].float()
    return out, gaps


def unit_attention(bundles):
    """Rescale the q/k projections to fan_in = d_model.  The reference
    initializer takes fan_in = shape[-2], the head count for wq (d, H, hd),
    so q and k elements have std sqrt(d / H) and attention logits std about
    d / H (128 for LLaMA-7B): a near-hard-max that amplifies float32
    rounding from layer to layer, so two correct summation orders part
    ways at logit gaps far above 1e-4 (seen on the card: a flip at a gap of
    4.6e-3).  At fan_in = d the logits have unit scale, as in a trained
    model, and the comparison tests the kernels, not the chaos."""
    for b in bundles:
        d = b.cfg.d_model
        for p in b.params["layers"]:
            p["wq"].mul_(math.sqrt(b.cfg.n_heads / d))
            p["wk"].mul_(math.sqrt(b.cfg.n_kv_heads / d))


def divergences(tokens, refs):
    """Per request whose tokens differ from greedy decoding's (``refs``:
    rid -> (tokens, top-2 gaps)), the first differing token and the
    reference's top-2 logit gap there."""
    div = []
    for rid, got in tokens.items():
        want, gaps = refs[rid]
        if got != want:
            i = next((i for i, (a, b) in enumerate(zip(got, want))
                      if a != b), len(got))
            div.append(dict(rid=rid, index=i, gap=gaps[i],
                            got=got[i] if i < len(got) else None,
                            want=want[i]))
    return div


def lossless_run(llm, ssms, fused_kernels, refs=None, kv_layout="paged"):
    """Serve the float32 zoo and hold each request's tokens against plain
    greedy decoding (computed here unless ``refs`` are given); a
    divergence is the first differing token and the reference's top-2
    logit gap there."""
    build.LAUNCHES.clear()
    eng, _, wall = serve(llm, ssms, 6, 0.3, capacity=6,
                         fused_kernels=fused_kernels, kv_layout=kv_layout)
    launches = dict(build.LAUNCHES)
    if refs is None:
        refs = {r.rid: greedy_reference(llm, r.prompt, r.max_new)
                for r in eng.requests.values()}
    tokens = {r.rid: r.emitted[:r.max_new] for r in eng.requests.values()}
    div = divergences(tokens, refs)
    line = dict(kv_layout=kv_layout, fused_kernels=fused_kernels,
                requests=len(tokens),
                exact=len(tokens) - len(div), divergences=div,
                launches=launches, wall_s=wall)
    return line, refs, tokens


def phase_lossless(report):
    llm, ssms = full_zoo("float32", llm_layers=4)
    on, refs, tok_on = lossless_run(llm, ssms, "on")
    off, _, tok_off = lossless_run(llm, ssms, "off", refs)
    check(not any(off["launches"].values()),
          "fused_kernels off launched a kernel")
    ref_init = dict(on=on, off=off, same_tokens_on_off=sum(
        tok_on[r] == tok_off[r] for r in tok_on))
    log("lossless, reference init (float32, LLM 4 layers; fused and "
        "gather paths, reported, not held to the limit) "
        + json.dumps(ref_init))
    unit_attention([llm] + ssms)
    unit, refs, _ = lossless_run(llm, ssms, "on")
    dense, _, _ = lossless_run(llm, ssms, "off", refs, kv_layout="dense")
    check(dense["launches"].get("verify_attention", 0) > 0,
          "the dense float32 run never launched verify_attention")
    for run in (unit, dense):
        bad = [d for d in run["divergences"] if d["gap"] >= 1e-4]
        check(not bad, f"{run['kv_layout']}: tokens differ from greedy "
              f"decoding at top-2 gaps >= 1e-4: {bad}")
        log(f"lossless {run['kv_layout']} (float32, LLM 4 layers, "
            f"unit-scale attention) " + json.dumps(run))
    report["lossless"] = dict(reference_init=ref_init, unit_attention=unit,
                              dense_unit_attention=dense)
    del llm, ssms
    torch.cuda.empty_cache()


def phase_chunked(report):
    llm, ssms = full_zoo("bfloat16", llm_layers=4, ssm_layers=4)
    build.LAUNCHES.clear()
    eng, stats, wall = serve(llm, ssms, 4, 1.0, capacity=4,
                             prefill_chunk=64, kv_dtype="int8",
                             spec_shape="tree", spec_branch=2)
    launches = dict(build.LAUNCHES)
    for name in PAGED:
        check(launches.get(name, 0) > 0, f"{name} never launched")
    check(stats["scheduler"]["prefill_grants"] > len(eng.requests),
          "no prompt was split into chunks")
    check(stats["tree_forks"] > 0, "tree speculation never forked a row")
    line = dict(prefill_grants=stats["scheduler"]["prefill_grants"],
                tree_forks=stats["tree_forks"], kv_dtype=stats["kv_dtype"],
                accepted_tokens=stats["accepted_tokens"], launches=launches,
                wall_s=wall)
    log("chunked prefill 64 + int8 KV + tree (LLM/SSMs 4 layers) "
        + json.dumps(line))
    report["chunked"] = line
    del eng, llm, ssms
    torch.cuda.empty_cache()


def layer0_qkv(llm, S, seed):
    """Layer 0's q, k, v (RoPE applied) of ``llm`` for one seeded prompt
    of S tokens at positions 0..S-1: flash_attention's input on a
    full-width model's data."""
    cfg, p = llm.cfg, llm.params["layers"][0]
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (1, S), generator=gen)
    x = embed(toks.to("cuda"), llm.params["embed"]).to(cfg.compute_dtype)
    pos = torch.arange(S, dtype=torch.int32, device="cuda")[None]
    with torch.no_grad():
        q, k, v = T.project_qkv(p, rms_norm(x, p["ln1"], cfg.norm_eps), cfg,
                                pos)
    return dict(q=q.contiguous(), k=k.contiguous(), v=v.contiguous(),
                window=cfg.sliding_window, model=cfg.name)


def phase_moe_window_path(report, timer):
    """mixtral-8x22b at published widths, depth cut to ``MIXTRAL_LAYERS``:
    its window sends the engine to the dense layout (plain windowed
    attention, as the reference's path); its experts run dropless through
    ``moe_experts``, required in every timed run and held against its
    plain version on the path's largest call."""
    llm, ssms = full_zoo("bfloat16", MIXTRAL_LAYERS,
                         llm_cfg=registry.get("mixtral-8x22b"))
    log("MoE window path: " + describe(llm, ssms, "bf16 weights; the "
                                       "window forces the dense layout"))
    with MoeTap(ops, "moe_experts") as tap:
        serve(llm, ssms, 6, 0.3, capacity=6)       # untimed
    line = timed_runs(llm, ssms, ("moe_experts",), capacity=6)
    check(line["kv_layout"] == "dense", "mixtral did not go dense")
    check(line["finished"] == 6, f"{line['finished']} of 6 finished")
    line.update(depth_cut=f"{MIXTRAL_LAYERS} of 56 layers",
                peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    log("MoE window path stats (mixtral; warm) " + json.dumps(line))
    report["moe_window_path"] = line
    check_moe("mixtral-8x22b window path, largest call", tap.best, timer,
              report)
    del tap
    # flash_attention's windowed input: S = 6144 > the 4096 window
    qkv = layer0_qkv(llm, 6144, seed=7)
    del llm, ssms
    torch.cuda.empty_cache()
    return qkv


def phase_moe_paged_path(report, timer):
    """dbrx-132b at published widths, depth cut to ``DBRX_LAYERS``, on
    paged bf16 KV with the fused kernels: kernels #1 and #2 at GQA group
    6; then both held against their plain versions on this path's largest
    calls."""
    llm, ssms = full_zoo("bfloat16", DBRX_LAYERS,
                         llm_cfg=registry.get("dbrx-132b"))
    log("MoE paged path: " + describe(llm, ssms, "bf16 weights, paged "
                                      "bf16 KV, fused kernels"))
    taps = {"fused_paged_verify": Tap(ops, "fused_paged_verify"),
            "fused_paged_decode": Tap(ops, "fused_paged_decode")}
    with taps["fused_paged_verify"], taps["fused_paged_decode"], \
            MoeTap(ops, "moe_experts") as moe_tap:
        serve(llm, ssms, 6, 0.3, capacity=6)       # untimed
    line = timed_runs(llm, ssms, PAGED + ["moe_experts"], capacity=6)
    check(line["kv_layout"] == "paged", "dbrx did not run paged")
    check(line["finished"] == 6, f"{line['finished']} of 6 finished")
    line.update(depth_cut=f"{DBRX_LAYERS} of 40 layers",
                peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    log("MoE paged path stats (dbrx; warm; launches from the first timed "
        "run) " + json.dumps(line))
    report["moe_paged_path"] = line
    check_moe("dbrx-132b paged path, largest call", moe_tap.best, timer,
              report)
    del llm, ssms, moe_tap
    torch.cuda.empty_cache()
    run_checks([(n, "dbrx-132b paged path, largest call", t.best)
                for n, t in taps.items()], timer, report)


def phase_moe_lossless(report):
    """Float32 mixtral-8x22b at published widths, 1 layer, on the dense
    fallback, unit-scale attention (see ``unit_attention``): the engine's
    tokens against plain greedy decoding."""
    llm, ssms = full_zoo("float32", 1, llm_cfg=registry.get("mixtral-8x22b"))
    unit_attention([llm] + ssms)
    run, _, _ = lossless_run(llm, ssms, "off", kv_layout="dense")
    bad = [d for d in run["divergences"] if d["gap"] >= 1e-4]
    check(not bad, f"mixtral: tokens differ from greedy decoding at top-2 "
          f"gaps >= 1e-4: {bad}")
    log("lossless mixtral-8x22b (float32, 1 layer, dense fallback, "
        "unit-scale attention) " + json.dumps(run))
    report["moe_lossless"] = run
    del llm, ssms
    torch.cuda.empty_cache()


# Trinity-Mini's routed experts: (tokens, dtype) a decode step, a batch-1
# admission of ~95 tokens, a 640-token packed verify; float32
TRINITY_MOE = dict(d=2048, ff=1024, E=128, k=8)
TRINITY_MOE_CASES = [(1, torch.bfloat16), (95, torch.bfloat16),
                     (640, torch.bfloat16), (95, torch.float32)]


def phase_moe_experts(report, timer):
    """``moe_experts`` at Trinity-Mini's widths against its plain
    version, timed beside its bound."""
    for i, (n, dt) in enumerate(TRINITY_MOE_CASES):
        a = moe_inputs(n, **TRINITY_MOE, dtype=dt, seed=31 + i)
        check_moe(f"trinity-mini widths, {n} tokens", a, timer, report)
        del a
        torch.cuda.empty_cache()


def phase_flash(report, timer, path_inputs):
    """flash_attention: the check shapes against the plain version, then
    the ops call on the full-width models' layer-0 q/k/v (launch counts
    as in phase 4), each also held against ``layers.attention`` (the same
    function for one unpadded segment)."""
    gen = torch.Generator().manual_seed(13)
    todo = []
    # bf16 runs on the tensor cores, float32 on the CUDA cores
    for kv, B, S, H, Kh, D, window, tag in (
            ("bf16", 1, 1000, 14, 2, 64, 0, "qwen2-0.5b G 7"),
            ("f32", 1, 777, 14, 2, 64, 256, "qwen2-0.5b G 7"),
            ("bf16", 1, 1500, 16, 16, 96, 0, "llama-616m"),
            ("f32", 1, 600, 12, 2, 96, 100, "D 96 G 6"),
            ("bf16", 1, 2049, 48, 8, 128, 512, "mixtral G 6"),
            ("f32", 1, 1000, 32, 32, 128, 0, "llama-7b"),
            ("bf16", 1, 333, 56, 8, 128, 0, "G 7 D 128"),
            ("bf16", 2, 45, 6, 1, 64, 7, "G 6 D 64 S < 64"),
            ("bf16", 2, 130, 64, 8, 96, 32, "G 8 D 96"),
            ("bf16", 2, 257, 32, 32, 128, 7, "G 1 D 128"),
            ("bf16", 2, 63, 7, 1, 96, 0, "G 7 D 96 S < 64"),
            ("bf16", 2, 500, 64, 8, 64, 0, "G 8 D 64")):
        todo.append(("flash_attention",
                     f"{tag} B={B} S={S} window={window} {kv}",
                     cases.flash_inputs(gen, B, S, H, Kh, D, kv, window)))
    run_checks(todo, timer, report)

    build.LAUNCHES.clear()
    outs = [ops.flash_attention(a["q"], a["k"], a["v"], window=a["window"])
            for a in path_inputs]
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    check(launches.get("flash_attention", 0) == len(path_inputs),
          f"flash_attention launched {launches}")
    lines = []
    for a, out in zip(path_inputs, outs):
        S = a["q"].shape[1]
        pos = torch.arange(S, dtype=torch.int32, device="cuda")[None]
        want = attention(a["q"], a["k"], a["v"], q_positions=pos,
                         kv_positions=pos, window=a["window"])
        err = (out.float() - want.float()).abs().max().item()
        tol = (2.0 ** -6 if out.dtype == torch.bfloat16 else 1e-4) * max(
            1.0, want.float().abs().max().item())
        check(bool(torch.isfinite(out.float()).all()) and err <= tol,
              f"flash_attention on {a['model']} differs from "
              f"layers.attention by {err} (tol {tol})")
        lines.append(dict(model=a["model"], shape=shape_of(a),
                          err_vs_layers_attention=err, tol=tol))
    log("flash path (ops.flash_attention on layer 0 of the full-width "
        "models) " + json.dumps(dict(launches=launches, calls=lines)))
    run_checks([("flash_attention", f"{a['model']} layer 0",
                 {n: a[n] for n in ("q", "k", "v", "window")})
                for a in path_inputs], timer, report)
    report["flash_path"] = dict(launches=launches, calls=lines)
    return launches


def ops_paged_decode_input(a):
    """``paged_decode_attention``'s inputs from a ``fused_paged_decode``
    call: its first query token, each row at that token's length (at most
    its allocated slots; an idle row 0)."""
    bs = a["k_pool"].shape[1]
    cells = (a["block_tables"] >= 0).sum(1, dtype=torch.int32) * bs
    lengths = torch.where(a["q_seg"][:, 0] >= 0, a["q_pos"][:, 0] + 1, 0)
    return dict(q=a["q"][:, 0].contiguous(), k_pool=a["k_pool"],
                v_pool=a["v_pool"], block_tables=a["block_tables"],
                lengths=torch.minimum(lengths, cells).to(torch.int32)
                .contiguous(), k_scale=a["k_scale"], v_scale=a["v_scale"])


def phase_ops_path(report, paged_verify, paged_decode, dense_grid):
    """The public kernel API of the three kernels no serving path runs,
    on the main paths' data (see the module docstring, phase 8).  Returns
    the launches and each kernel's inputs."""
    inputs = {
        "paged_verify_attention": paged_verify,
        "paged_decode_attention": ops_paged_decode_input(paged_decode),
        "decode_attention": dense_grid,
    }
    v = inputs["paged_verify_attention"]
    d = inputs["paged_decode_attention"]
    e = inputs["decode_attention"]
    build.LAUNCHES.clear()
    outs = [
        ops.paged_verify_attention(
            v["q"], v["k_pool"], v["v_pool"], v["pool_seg"], v["pool_pos"],
            v["q_seg"], v["q_pos"], v["block_ids"], v["block_owner"],
            v["k_scale"], v["v_scale"], q_anc=v["q_anc"],
            block_node=v["block_node"]),
        ops.paged_decode_attention(d["q"], d["k_pool"], d["v_pool"],
                                   d["block_tables"], d["lengths"],
                                   d["k_scale"], d["v_scale"]),
        ops.decode_attention(e["q"], e["k"], e["v"], e["lengths"])]
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    for name in inputs:
        check(launches.get(name, 0) > 0, f"{name} never launched")
    check(all(bool(torch.isfinite(o.float()).all()) for o in outs),
          "the ops path gave non-finite values")
    line = dict(launches=launches, shapes={n: shape_of(x)
                                           for n, x in inputs.items()},
                paged_decode_lengths=d["lengths"].tolist(),
                dense_decode_lengths=e["lengths"].tolist(),
                rows=d["q"].shape[0])
    log("ops path (kernels/ops.py on the main paths' data) "
        + json.dumps(line))
    report["ops_path"] = line
    return launches, inputs


# -------------------------------------------------------------- fleet --

def fleet(llm, ssms, policy, steal="off", classes=None, router_kw=None):
    """A ``Router`` over two paged engines built as the serve launcher
    builds a fleet (``launch.serve.build_fleet``: the zoo's bundles and the
    one card shared, pools and selectors per replica, ``FLEET_CAPACITY``
    split evenly), fused kernels on; serves ``FLEET_REQUESTS`` requests of
    the mix workload with Poisson arrivals to the end.  Checks that every
    request finishes, that each replica serves at least one and that the
    fleet's tokens are the sum of its replicas'.  ``router_kw``: the
    Router's keyword arguments (sub-meshes and rules).  Returns (router,
    line)."""
    reqs = make_workload("mix", FLEET_REQUESTS, llm.cfg.vocab_size, seed=0,
                         scale=0.3, arrival_rate=FLEET_RATE)
    classes = classes or ["general", "general"]
    engines = build_fleet(llm, ssms, reqs, EngineConfig(
        gamma=4, capacity=FLEET_CAPACITY, max_len=256, fused_kernels="on"),
        classes)
    router = Router(engines, RouterConfig(
        policy=policy, steal=steal,
        classes=",".join(classes) if set(classes) != {"general"} else ""),
        **(router_kw or {}))
    router.submit(reqs)
    torch.cuda.synchronize()
    build.LAUNCHES.clear()
    t0 = time.perf_counter()
    stats = router.run(max_slots=400)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    served = [r for eng in engines for r in eng.requests.values()]
    unfinished = [r.rid for r in served if not r.done]
    check(stats["finished"] == FLEET_REQUESTS and len(served)
          == FLEET_REQUESTS and not unfinished,
          f"fleet {policy}: finished {stats['finished']}, unfinished "
          f"{unfinished}")
    per = [len(eng.scheduler.finished) for eng in engines]
    check(min(per) >= 1, f"fleet {policy}: a replica served nothing {per}")
    tokens = [sum(len(r.emitted) for r in eng.requests.values())
              for eng in engines]
    check(stats["accepted_tokens"]
          == sum(s["accepted_tokens"] for s in stats["replica_stats"])
          and sum(tokens) == sum(len(r.emitted) for r in served),
          f"fleet {policy}: fleet tokens are not the replicas' sum")
    slots = sum(stats["steps"])
    line = dict(policy=policy, steal=steal, classes=stats["classes"],
                requests=FLEET_REQUESTS, finished_per_replica=per,
                dispatched=stats["dispatched"], steals=stats["steals"],
                slots=stats["steps"],
                wall_ms_per_slot=[eng.wall_time * 1e3 / max(1, n)
                                  for eng, n in zip(engines, stats["steps"])],
                fleet_wall_s=wall,
                fleet_tokens_per_s_wall=stats["accepted_tokens"] / wall,
                accepted_tokens=stats["accepted_tokens"],
                emitted_tokens=tokens, launches=launches,
                launches_per_fleet_slot={k: v / slots
                                         for k, v in launches.items()},
                makespan_sim=stats["makespan_sim"])
    return router, line


def phase_fleet_path(report, timer, llm, ssms):
    """The main path's zoo (LLaMA-7B, full width and depth, bf16, and the
    three SSMs) behind the router: two replicas, lot; then p2c with work
    stealing and the classes prefill,decode.  Each fleet first serves an
    untimed pass that warms its shapes up and keeps both fused kernels'
    largest calls; then the timed run, driven with the launch counts set
    to 0 just before it and read just after: both fused kernels must
    launch, and no other.  Last, each kept call is held against its plain
    version and timed."""
    log("fleet path: " + describe(llm, ssms, "bf16 weights, paged bf16 KV, "
                                  "2 replicas"))
    lines, todo = [], []
    for kw in (dict(policy="lot"),
               dict(policy="p2c", steal="on", classes=["prefill",
                                                        "decode"])):
        taps = [Tap(ops, name) for name in PAGED]
        with taps[0], taps[1]:
            fleet(llm, ssms, **kw)                         # untimed
        what = " ".join([kw["policy"], *kw.get("classes", [])])
        todo += [(t.attr, f"fleet {what}, largest call", t.best)
                 for t in taps]
        router, line = fleet(llm, ssms, **kw)
        for name in PAGED:
            check(line["launches"].get(name, 0) > 0,
                  f"fleet {kw}: {name} never launched")
        check(set(line["launches"]) <= set(PAGED),
              f"fleet {kw}: other kernels launched {line['launches']}")
        log(f"fleet path [{report['card']}] " + json.dumps(line))
        lines.append(line)
        del router
    report["fleet_path"] = lines
    run_checks(todo, timer, report)


def lossless_check(what, tokens, refs):
    """Each request's tokens against plain greedy decoding; a mismatch
    passes only where the reference's top-2 logit gap is below 1e-4."""
    div = divergences(tokens, refs)
    bad = [d for d in div if d["gap"] >= 1e-4]
    check(not bad, f"{what}: tokens differ from greedy decoding at top-2 "
          f"gaps >= 1e-4: {bad}")
    return dict(requests=len(tokens), exact=len(tokens) - len(div),
                divergences=div)


def phase_fleet_lossless(report):
    """Two float32 replicas (LLaMA-7B cut to 4 layers, unit-scale
    attention as in phase 6), p2c with work stealing: every request's
    tokens equal plain greedy decoding.  Returns the zoo for the
    speculation-API phase."""
    llm, ssms = full_zoo("float32", llm_layers=4)
    unit_attention([llm] + ssms)
    router, line = fleet(llm, ssms, "p2c", steal="on")
    tokens = {r.rid: r.emitted[:r.max_new] for eng in router.engines
              for r in eng.requests.values()}
    refs = {r.rid: greedy_reference(llm, r.prompt, r.max_new)
            for eng in router.engines for r in eng.requests.values()}
    line.update(lossless_check("fleet", tokens, refs))
    log(f"fleet lossless (float32, LLM 4 layers, unit-scale attention) "
        f"[{report['card']}] " + json.dumps(line))
    report["fleet_lossless"] = line
    return llm, ssms


def phase_spec_api(report, llm, ssm, new_tokens=24, gamma=4):
    """The engine-free speculation API (``spec_iteration`` over dense
    caches, no kernel) with ``llm`` and ``ssm`` (phase 16's float32
    LLaMA-7B at 4 layers and LLaMA-68M at full width): three prompts of
    unequal length, iterations until every row has ``new_tokens`` tokens;
    each row's tokens equal plain greedy decoding (gap rule of phase 6)."""
    reqs = make_workload("mix", 3, llm.cfg.vocab_size, seed=1, scale=0.3)
    lens = [r.prompt_len for r in reqs]
    toks = np.zeros((3, max(lens)), np.int32)
    for b, r in enumerate(reqs):
        toks[b, :lens[b]] = r.prompt
    max_len = max(lens) + new_tokens * (gamma + 1) + gamma + 2
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    toks = torch.as_tensor(toks, device="cuda")
    build.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, llm_cache = llm.prefill(toks, lengths, max_len)
    _, ssm_cache = ssm.prefill(toks, lengths, max_len)
    rows = torch.arange(3, device="cuda")
    last = torch.argmax(lg[rows, lengths.long() - 1, :llm.cfg.vocab_size],
                        -1)[:, None].to(torch.int32)
    emitted = [[int(t)] for t in last[:, 0]]
    iters = accepted = 0
    while min(len(e) for e in emitted) < new_tokens:
        out, out_len, n_acc, llm_cache, ssm_cache, lengths, last = \
            sd.spec_iteration(llm, ssm, llm_cache, ssm_cache, last, lengths,
                              gamma)
        iters += 1
        accepted += int(n_acc.sum())
        for b in range(3):
            emitted[b] += out[b, :int(out_len[b])].tolist()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    refs = {b: greedy_reference(llm, r.prompt, new_tokens)
            for b, r in enumerate(reqs)}
    line = dict(llm=f"{llm.cfg.name} {llm.cfg.n_layers} layers float32",
                ssm=f"{ssm.cfg.name} {ssm.cfg.n_layers}x{ssm.cfg.d_model}",
                prompts=lens, gamma=gamma, iterations=iters,
                accepted=accepted, ms_per_iteration=wall * 1e3 / iters,
                launches=dict(build.LAUNCHES))
    line.update(lossless_check("spec_iteration", {
        b: e[:new_tokens] for b, e in enumerate(emitted)}, refs))
    log(f"speculation API [{report['card']}] " + json.dumps(line))
    report["spec_api"] = line


def train_batch(cfg, step):
    """Batch ``step`` of the train launcher's stream (seed 0, batch 8,
    sequence 128) on the card."""
    toks, labels = TokenStream(seed=0, batch=8, seq_len=128,
                               vocab=cfg.vocab_size).batch_at(step)
    return {"tokens": torch.as_tensor(toks, device="cuda"),
            "labels": torch.as_tensor(labels, device="cuda")}


def batch_loss(params, cfg, batch):
    with torch.no_grad():
        return float(T.loss_fn(params, cfg, batch)[1]["loss"])


def init_params(cfg, unit):
    """The seed-0 init, with the q/k projections at unit scale (see
    ``unit_attention``) if ``unit``."""
    params = T.init_params(cfg, 0, device="cuda")
    if unit:
        unit_attention([sd.Bundle(cfg, params)])
    return params


def init_grads(cfg, batch, mode="none", unit=True):
    """The gradient of every leaf at ``init_params(cfg, unit)`` under
    ``remat`` mode ``mode`` (a leaf no forward reads: zeros)."""
    params = init_params(cfg, unit)
    flat = tensor_leaves(params)
    for p in flat:
        p.requires_grad_(True)
    total, _ = T.loss_fn(params, cfg, batch, T.Opts(remat=mode))
    grads = torch.autograd.grad(total, flat, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(flat, grads)]


def global_norm(tensors):
    return math.sqrt(sum(float(torch.sum(torch.square(t.double())))
                         for t in tensors))


def phase_train(report):
    """``launch/train.py`` on qwen2-0.5b at published widths and depth
    (24 x 896, vocab 151936), float32, batch 8, sequence 128: an
    uninterrupted run of ``TRAIN_STEPS`` steps, then a run with a
    checkpoint every ``TRAIN_CKPT_EVERY`` steps and a failure injected at
    ``TRAIN_FAIL_AT`` that resumes from the last checkpoint.

    The launcher's init (the reference's) gives q/k elements of std
    sqrt(d / H), a near-hard-max attention whose gradient grows by orders
    of magnitude a layer toward the input (its global norm is printed
    beside the one at unit scale): the global clip then leaves the deep
    layers' Adam steps under ``eps``, and 30 steps cannot move the loss
    beyond the batch-to-batch spread.  So learning is checked with the
    q/k projections at unit scale (``unit_attention``), through the
    launcher's step function, optimizer and schedule: ``TRAIN_STEPS``
    steps on the same stream, and the loss on ``TRAIN_EVAL`` held-out
    batches before and after must fall by ``TRAIN_DROP_SE`` standard
    errors of its mean.  From the same init, each remat mode: its
    gradients against none's, and two steps whose second loss (it reads
    the first step's update) is held to none's."""
    ckpt = os.path.join(ROOT, "build", "train_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = ["--device", "cuda", "--arch", "qwen2-0.5b", "--dtype", "float32",
            "--steps", str(TRAIN_STEPS), "--batch", "8", "--seq-len", "128",
            "--lr", str(TRAIN_LR), "--warmup", str(TRAIN_WARMUP),
            "--ckpt-every", str(TRAIN_CKPT_EVERY)]
    cfg = dataclasses.replace(registry.get("qwen2-0.5b"), dtype="float32")
    batch = train_batch(cfg, 0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    clean = train.main(argv)
    torch.cuda.synchronize()
    clean_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    try:
        crash = train.main(argv + ["--ckpt-dir", ckpt, "--simulate-failures",
                                   "--fail-at", str(TRAIN_FAIL_AT)])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    crash_s = time.perf_counter() - t0
    losses = clean["losses"]
    check(all(math.isfinite(x) for x in losses + crash["losses"]),
          "train: a loss is not finite")
    last_ckpt = (TRAIN_FAIL_AT + 1) // TRAIN_CKPT_EVERY * TRAIN_CKPT_EVERY
    check(crash["resumed_from"] == last_ckpt,
          f"train: resumed from {crash['resumed_from']}, not {last_ckpt}")
    after = losses[last_ckpt:]
    rel = max(abs(a - b) / abs(b) for a, b in zip(crash["losses"], after))
    check(len(crash["losses"]) == len(after) and rel <= TRAIN_RTOL,
          f"train: resumed losses differ from the uninterrupted run's by "
          f"{rel:.3g} (tolerance {TRAIN_RTOL})")
    first = batch_loss(init_params(cfg, False), cfg, batch)
    check(abs(first - losses[0]) <= TRAIN_RTOL * losses[0],
          f"train: the launcher's first loss {losses[0]} is not the init's "
          f"loss {first} on its first batch")
    grad_norm = {k: global_norm(init_grads(cfg, batch, unit=unit))
                 for k, unit in (("launcher_init", False),
                                 ("unit_attention", True))}

    # learning, at unit-scale attention: the launcher's step, optimizer
    # and schedule on its stream; the loss on held-out batches
    evals = [train_batch(cfg, TRAIN_EVAL_FROM + i) for i in range(TRAIN_EVAL)]
    params = init_params(cfg, True)
    before = [batch_loss(params, cfg, b) for b in evals]
    opt = AdamW(lr=cosine_schedule(TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS))
    state = opt.init(params)
    step = T.make_train_step(cfg, opt, T.Opts(remat="none"))
    unit_losses = []
    for i in range(TRAIN_STEPS):
        params, state, m = step(params, state, train_batch(cfg, i))
        unit_losses.append(float(m["loss"]))
    drops = [b - batch_loss(params, cfg, e) for b, e in zip(before, evals)]
    del params, state, step
    mean = statistics.mean(drops)
    se = statistics.stdev(drops) / math.sqrt(len(drops))
    held_out = dict(before=statistics.mean(before), mean_drop=mean,
                    sd=statistics.stdev(drops), se=se, min_drop=min(drops),
                    max_drop=max(drops))
    check(all(math.isfinite(x) for x in unit_losses + drops)
          and mean >= TRAIN_DROP_SE * se,
          f"train: the held-out loss fell by {mean:.4g} (standard error "
          f"{se:.3g}), less than {TRAIN_DROP_SE} standard errors")

    # remat: each mode's gradients at the init against none's, then two
    # steps from the init (the second step's loss reads the first step's
    # update); peak memory over the steps
    ref, grad_err = init_grads(cfg, batch), {}
    for mode in ("full", "dots"):
        grad_err[mode] = max(
            (g - r).abs().max().item() / max(1.0, r.abs().max().item())
            for g, r in zip(init_grads(cfg, batch, mode), ref))
    del ref
    remat = {}
    for mode in ("none", "full", "dots"):
        params = init_params(cfg, True)
        opt = AdamW(lr=TRAIN_LR)
        state = opt.init(params)
        step = T.make_train_step(cfg, opt, T.Opts(remat=mode))
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        params, state, m = step(params, state, batch)
        loss = float(m["loss"])
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        remat[mode] = dict(loss=loss, second_loss=float(m["loss"]),
                           ms=(time.perf_counter() - t0) * 1e3,
                           peak_mem_gb=torch.cuda.max_memory_allocated()
                           / 2**30, max_rel_grad_err=grad_err.get(mode, 0.0))
        del params, state, step, m
    torch.cuda.empty_cache()
    for mode in ("full", "dots"):
        r, n = remat[mode], remat["none"]
        check(r["max_rel_grad_err"] <= REMAT_GRAD_TOL,
              f"train: remat {mode} gradients differ from none's by "
              f"{r['max_rel_grad_err']:.3g} x max(1, max|g|)")
        check(abs(r["second_loss"] - n["second_loss"])
              <= REMAT_RTOL * abs(n["second_loss"]),
              f"train: remat {mode} second-step loss {r['second_loss']} "
              f"against none {n['second_loss']}")
    line = dict(model=f"{cfg.name} {cfg.n_layers}x{cfg.d_model} vocab "
                      f"{cfg.vocab_size} {cfg.dtype}", batch=8,
                seq_len=128, steps=TRAIN_STEPS, lr=TRAIN_LR, losses=losses,
                resumed_from=crash["resumed_from"],
                resumed_losses=crash["losses"], resumed_max_rel_diff=rel,
                tolerance=TRAIN_RTOL, grad_norm_first_batch=grad_norm,
                unit_attention_losses=unit_losses, held_out=held_out,
                min_standard_errors=TRAIN_DROP_SE,
                ms_per_step=clean_s * 1e3 / TRAIN_STEPS,
                crash_run_s=crash_s, peak_mem_gb=peak / 2**30, remat=remat,
                remat_tolerances=dict(grad=REMAT_GRAD_TOL,
                                      second_loss=REMAT_RTOL))
    log(f"train [{report['card']}] " + json.dumps(line))
    report["train"] = line


# ------------------------------------------------- tile configs, mesh --

def config_check(name, a, timer, configs):
    """``name`` on the inputs ``a`` under each (label, config): its error
    against the plain version (held to the kernels' tolerance) and its
    time, the launches made here not counted."""
    kern, plain = KERNELS[name][:2]
    before = build.LAUNCHES[name]
    ref = plain(**a)
    scale = max(1.0, ref.float().abs().max().item())
    out = {}
    for label, cfg in configs:
        got = kern(**a, config=cfg)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        tol = (2.0 ** -6 if got.dtype == torch.bfloat16 else 1e-4) * scale
        ok = bool(torch.isfinite(got.float()).all()) and err <= tol
        out[label] = dict(config=dataclasses.asdict(cfg), max_abs_err=err,
                          tol=tol, ok=ok,
                          ms=timer(lambda: kern(**a, config=cfg)))
    build.LAUNCHES[name] = before
    return out


def phase_autotune(report, timer, llm, ssms, captured):
    """Tile configs tuned on the card (``kernels/autotune.py``), in this
    run's cache (:data:`TUNE_CACHE`): every key of :data:`TUNE_KEYS` on
    two calls, the paged path's own largest call (phase 4's: LLaMA-7B's
    verify, LLaMA-616M's catch-up) where the key is its geometry, else the
    synthetic pool, and a long-context call; each candidate held to the
    plain version on both before it may win (one that disagrees raises).
    Then the configs kept for #1 and #2 beside the default on the path's
    calls and on the long-context calls, each held to the plain version
    and timed; a paged serving pass of the main path's zoo
    whose engine reads the tuned cache (its launches and wall ms per
    slot; the cache must be hit); and float32 losslessness at 4 layers on
    the tuned cache, as phase 6.  The cache is removed after, so later
    phases launch the plans."""
    autotune.CACHE_STATS.update(hits=0, misses=0)
    # each key tunes on two calls: the paged path's largest call where the
    # key is its geometry (LLaMA-7B's verify, LLaMA-616M's catch-up, bf16
    # KV), else the reference's synthetic pool; and a long-context call
    on_path = {}
    for name, kind in (("fused_paged_verify", "verify"),
                       ("fused_paged_decode", "decode")):
        a = captured[name]
        geom = (a["q"].shape[-2], a["k_pool"].shape[2], a["q"].shape[-1])
        on_path[(kind, geom, "bf16")] = a
    check(all(k in TUNE_KEYS for k in on_path),
          f"the path's calls {list(on_path)} have no key to tune")
    gen = torch.Generator().manual_seed(19)
    lines, long_calls = [], {}
    for kind, (H, Kh, D), kv in TUNE_KEYS:
        t0 = time.perf_counter()
        base = on_path.get((kind, (H, Kh, D), kv))
        if base is None:
            base = autotune.synthetic_call(kind, H, Kh, D, TUNE_GAMMA,
                                           TUNE_BS, "linear", kv, 0,
                                           torch.device("cuda"))
        long = (cases.verify_inputs(gen, LONG_VERIFY_LENS, TUNE_GAMMA, H, Kh,
                                    D, TUNE_BS, kv, False)
                if kind == "verify" else
                cases.decode_inputs(gen, LONG_DECODE_LENS, 1, H, Kh, D,
                                    TUNE_BS, kv))
        won = autotune.autotune(kind, H=H, Kh=Kh, D=D, gamma_max=TUNE_GAMMA,
                                block_size=TUNE_BS, kv_dtype=kv,
                                path=TUNE_CACHE, calls=[base, long])
        key = autotune.tune_key(kind, H=H, Kh=Kh, D=D, gamma_max=TUNE_GAMMA,
                                block_size=TUNE_BS, kv_dtype=kv,
                                device="cuda")
        entry = autotune.load_cache(TUNE_CACHE)[key]
        line = dict(key=key, calls=[
            "path" if (kind, (H, Kh, D), kv) in on_path else "synthetic",
            shape_of(long)], kept=dataclasses.asdict(won),
            us=entry["us"], default_us=entry["default_us"],
            default_min_us=entry["default_min_us"],
            fastest=entry["fastest"], trials=entry["trials"],
            s=time.perf_counter() - t0)
        log(f"autotune [{report['card']}] " + json.dumps(line))
        lines.append(line)
        if (kind, (H, Kh, D), kv) in on_path:
            long_calls[kind] = long
        del base, long
        torch.cuda.empty_cache()
    cache = autotune.load_cache(TUNE_CACHE)

    def winner(kind, H, Kh, D):
        e = cache[autotune.tune_key(kind, H=H, Kh=Kh, D=D,
                                    gamma_max=TUNE_GAMMA, block_size=TUNE_BS,
                                    device="cuda")]
        return autotune.FusedConfig(e["bq"], e["bk"], e["depth"])

    path_calls = {}
    for name, kind in (("fused_paged_verify", "verify"),
                       ("fused_paged_decode", "decode")):
        a = captured[name]
        H, D = a["q"].shape[-2:]
        Kh = a["k_pool"].shape[2]
        cfg = winner(kind, H, Kh, D)
        rec = config_check(name, a, timer, [
            ("default", autotune.DEFAULT_CONFIG), ("tuned", cfg)])
        check(all(r["ok"] for r in rec.values()),
              f"{name} disagrees on the paged path's largest call: {rec}")
        rec["shape"] = shape_of(a)
        log(f"tuned on the path's largest call {name} "
            f"[{report['card']}] " + json.dumps(rec))
        path_calls[name] = rec
    # the kept configs and the default on the long-context calls they were
    # tuned on (the tuner held every candidate to the plain version there)
    for name, kind in (("fused_paged_verify", "verify"),
                       ("fused_paged_decode", "decode")):
        a = long_calls.pop(kind)
        H, D = a["q"].shape[-2:]
        rec = config_check(name, a, timer, [
            ("default", autotune.DEFAULT_CONFIG),
            ("kept", winner(kind, H, a["k_pool"].shape[2], D))])
        check(all(r["ok"] for r in rec.values()),
              f"{name} disagrees on a long-context call: {rec}")
        rec["shape"] = shape_of(a)
        log(f"tile configs on a long-context call {name} "
            f"[{report['card']}] " + json.dumps(rec))
        long_calls[name] = rec
        del a
    build.LAUNCHES.clear()
    autotune.CACHE_STATS.update(hits=0, misses=0)
    eng, stats, wall = serve(llm, ssms, 6, 0.3, capacity=6)
    launches = dict(build.LAUNCHES)
    hits = autotune.CACHE_STATS["hits"]
    check(hits > 0, "the tuned engine never hit the tile cache")
    for name in PAGED:
        check(launches.get(name, 0) > 0, f"{name} never launched (tuned)")
    served = dict(
        configs=dict(llm_verify=dataclasses.asdict(eng.fused_llm_verify),
                     llm_decode=dataclasses.asdict(eng.fused_llm_decode),
                     ssm_decode=[dataclasses.asdict(c)
                                 for c in eng.fused_ssm_decode]),
        cache_stats=dict(autotune.CACHE_STATS), launches=launches,
        slots=len(eng.slot_log), wall_s=wall,
        wall_ms_per_slot=wall * 1e3 / len(eng.slot_log),
        finished=stats["scheduler"]["finished"])
    log(f"tuned paged serving pass [{report['card']}] " + json.dumps(served))
    del eng
    f32, f32_ssms = full_zoo("float32", llm_layers=4)
    unit_attention([f32] + f32_ssms)
    autotune.CACHE_STATS.update(hits=0, misses=0)
    lossless, _, _ = lossless_run(f32, f32_ssms, "on")
    check(autotune.CACHE_STATS["hits"] > 0,
          "the float32 engine never hit the tile cache")
    bad = [d for d in lossless["divergences"] if d["gap"] >= 1e-4]
    check(not bad, f"tuned: tokens differ from greedy decoding at top-2 "
          f"gaps >= 1e-4: {bad}")
    log("lossless on the tuned cache (float32, LLM 4 layers, unit-scale "
        "attention) " + json.dumps(lossless))
    os.remove(TUNE_CACHE)
    report["autotune"] = dict(keys=lines, path_calls=path_calls,
                              long_calls=long_calls, serving=served,
                              lossless=lossless)
    del f32, f32_ssms
    torch.cuda.empty_cache()


def phase_sharded_fleet(report, llm, ssms):
    """Phase 15's float32 zoo (LLaMA-7B at 4 layers, unit-scale attention)
    behind the router, lot, twice: without meshes, then with each
    replica stepping under ``use_rules`` on its sub-mesh
    (``launch.mesh.replica_submeshes`` of a two-replica local mesh on the
    one card: two 1x1 CUDA meshes of a world-1 process group, destroyed
    after) and ``serve_rules()``.  Tokens and router stats (host wall
    times aside) must be equal, and both fused kernels launch."""
    import torch.distributed as dist

    def outcome(router):
        stats = router.stats()
        stats["replica_stats"] = [
            {k: v for k, v in r.items() if k != "wall_time"}
            for r in stats["replica_stats"]]
        return stats, {r.rid: list(r.emitted) for eng in router.engines
                       for r in eng.requests.values()}

    router, plain = fleet(llm, ssms, "lot")
    plain_stats, plain_tokens = outcome(router)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        subs = mesh.replica_submeshes(mesh.make_local_mesh(
            replicas=2, device_type="cuda"))
        router, line = fleet(llm, ssms, "lot", router_kw=dict(
            submeshes=subs, rules=sharding.serve_rules()))
        stats, tokens = outcome(router)
    finally:
        dist.destroy_process_group()
    check(not sharding.active(), "the replicas' rules outlived the fleet")
    for name in PAGED:
        check(line["launches"].get(name, 0) > 0,
              f"sharded fleet: {name} never launched")
    check(tokens == plain_tokens, "the sharded fleet's tokens differ from "
          "the unsharded fleet's")
    check(stats == plain_stats, f"the sharded fleet's router stats differ: "
          f"{stats} against {plain_stats}")
    out = dict(meshes=[str(m) for m in subs], rules="serve_rules()",
               sharded=line, unsharded=plain, tokens_equal=True,
               stats_equal=True)
    log(f"sharded fleet (float32, LLM 4 layers, lot, 1x1 CUDA sub-meshes) "
        f"[{report['card']}] " + json.dumps(out, default=str))
    report["sharded_fleet"] = out


def start_dryrun():
    """Start the dry-run of each cell of :data:`DRYRUN_CELLS` (host only,
    its fake 512-rank group in a process of its own) to run beside the
    card's phases; :func:`phase_dryrun` reads them.  A process still
    running when this script exits is killed."""
    runs = []
    for arch, shape, meshes in DRYRUN_CELLS:
        out = os.path.join(ROOT, "build", f"smoke_dryrun_{arch}_{shape}")
        logf = open(out + ".log", "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, *meshes, "--roofline", "--json",
             out + ".json"], cwd=ROOT, stdout=logf, stderr=subprocess.STDOUT,
            env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
        logf.close()
        atexit.register(lambda p=proc: p.poll() is None and p.kill())
        runs.append((arch, shape, out, proc))
    return runs


def phase_dryrun(report, runs):
    """The distribution layer's dry-run (``launch/dryrun.py``; host only):
    the runs :func:`start_dryrun` started, each cell's record read back;
    every cell must be ``ok`` and under its :data:`DRYRUN_BOUNDS`."""
    recs = []
    for arch, shape, out, proc in runs:
        try:
            proc.wait(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            check(False, f"dry-run {arch} {shape} did not end in 900 s")
        with open(out + ".log") as f:
            text = f.read()
        check(proc.returncode == 0, f"dry-run {arch} {shape} failed: "
              f"{text[-4000:]}")
        with open(out + ".json") as f:
            cells = json.load(f)
        for rec in cells:
            check(rec["status"] == "ok", f"dry-run cell not ok: {rec}")
            rec.pop("traceback", None)
            for k, lim in DRYRUN_BOUNDS.get(
                    (arch, shape, rec["multi_pod"]), {}).items():
                check(rec[k] < lim, f"dry-run {arch} {shape} "
                      f"{'2x16x16' if rec['multi_pod'] else '16x16'}: "
                      f"{k} {rec[k]:.4g} a device, over {lim:.4g}")
            log(f"dryrun {arch} {shape} "
                f"{'2x16x16' if rec['multi_pod'] else '16x16'} "
                f"(cell {rec['compile_s']:.1f} s) " + json.dumps(rec))
        recs.append(dict(arch=arch, shape=shape, cells=cells))
    report["dryrun"] = recs


def zoo_serve(llm, ssms):
    """Serve :data:`ZOO_REQUESTS` mix requests through the paged engine,
    fused kernels on, LBSS over every SSM; per SSM and per easy / hard
    request: LBSS's selections of it (one a request and slot) and its
    acceptance (the mean over those of the accepted drafts over the
    positions tested, as the engine observes them)."""
    reqs = make_workload("mix", ZOO_REQUESTS, llm.cfg.vocab_size, seed=0,
                         scale=ZOO_SCALE)
    eng = make_engine(llm, ssms, reqs, EngineConfig(
        gamma=4, max_len=256, fused_kernels="on", capacity=ZOO_CAPACITY))
    eng.add_requests(reqs)
    hard = {r.rid: r.difficulty >= ZOO_HARD for r in reqs}
    table = {(j, h): dict(slots=0, rates=[]) for j in range(len(ssms))
             for h in (False, True)}
    observe = eng.selector.observe_accept

    def observe_accept(rid, j, rate):
        cell = table[(j, hard[rid])]
        cell["slots"] += 1
        cell["rates"].append(rate)
        return observe(rid, j, rate)
    eng.selector.observe_accept = observe_accept
    build.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = eng.run(max_slots=1000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    unfinished = [r.rid for r in eng.requests.values() if not r.done]
    check(not unfinished, f"zoo: unfinished requests {unfinished}")
    for name in ("fused_paged_verify", "fused_paged_decode"):
        check(launches.get(name, 0) > 0, f"zoo: {name} never launched")
    per = []
    for j, b in enumerate(ssms):
        row = dict(ssm=b.cfg.name, d_model=b.cfg.d_model)
        for h, tag in ((False, "easy"), (True, "hard")):
            c = table[(j, h)]
            row[tag] = dict(selections=c["slots"], acceptance=(
                float(np.mean(c["rates"])) if c["rates"] else None))
        per.append(row)
    return dict(requests=len(reqs), easy=sum(not h for h in hard.values()),
                hard=sum(hard.values()), slots=len(eng.slot_log),
                accepted_tokens=stats["accepted_tokens"],
                mean_accept=stats["mean_accept"], wall_s=wall,
                launches=launches, per_ssm=per)


def phase_zoo(report):
    """The trained zoo (``examples/train_distill_ssm_torch.py``): trained
    on the card into ``build/smoke_zoo`` (removed after), then served
    trained and at random init (the same configs, seeds 0-5), a float32
    lossless run against its LLM's greedy decoding, and the serving
    launcher on it (``examples/serve_spin_torch.py --zoo``)."""
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import train_distill_ssm_torch as zoo_example
    zoo_dir = os.path.join(ROOT, "build", "smoke_zoo")
    shutil.rmtree(zoo_dir, ignore_errors=True)
    trained = {}
    try:
        llm, ssms = zoo_example.build_zoo(force=True, device="cuda",
                                          zoo_dir=zoo_dir, log=log,
                                          record=trained)
    finally:
        shutil.rmtree(zoo_dir, ignore_errors=True)
    for key, r in trained.items():
        check(math.isfinite(r["final_loss"]), f"zoo {key}: loss not finite")
        log(f"zoo train {key} {r['name']}: {r['steps']} steps, final loss "
            f"{r['final_loss']:.4f}, {r['seconds']:.1f} s")
    runs = {"trained": zoo_serve(llm, ssms)}
    rand_llm = sd.Bundle(llm.cfg, T.init_params(llm.cfg, 0, device="cuda"))
    rand = [sd.Bundle(b.cfg, T.init_params(b.cfg, i + 1, device="cuda"))
            for i, b in enumerate(ssms)]
    runs["random"] = zoo_serve(rand_llm, rand)
    del rand_llm, rand
    for what, run in runs.items():
        log(f"zoo serve [{what}] " + json.dumps(run))
        for row in run["per_ssm"]:
            log(f"  zoo [{what}] {row['ssm']} (d {row['d_model']}): "
                + "; ".join(
                    f"{tag} selections {row[tag]['selections']} acceptance "
                    + ("-" if row[tag]["acceptance"] is None
                       else f"{row[tag]['acceptance']:.3f}")
                    for tag in ("easy", "hard")))
    check(llm.cfg.dtype == "float32", "the zoo is not float32")
    line, _, _ = lossless_run(llm, ssms, "on")
    bad = [d for d in line["divergences"] if d["gap"] >= 1e-4]
    check(not bad, f"zoo: tokens differ from greedy decoding at top-2 gaps "
          f">= 1e-4: {bad}")
    log("lossless zoo (float32, trained) " + json.dumps(line))
    from repro_torch.launch import serve as serve_launcher
    with contextlib.redirect_stdout(io.StringIO()):
        stats = serve_launcher.main(
            ["--device", "cuda", "--dataset", "mix", "--requests", "8",
             "--fused-kernels", "on"], zoo=(llm, ssms))
    check(stats["scheduler"]["finished"] == 8,
          "the serving launcher did not finish the trained zoo's requests")
    log(f"zoo serving launcher: finished {stats['scheduler']['finished']}, "
        f"mean_accept {stats['mean_accept']:.3f}")
    report["zoo"] = dict(train=trained, serve=runs, lossless=line,
                         launcher=dict(finished=stats["scheduler"][
                             "finished"], mean_accept=stats["mean_accept"]))
    del llm, ssms
    torch.cuda.empty_cache()


# --------------------------------------------------------------- main --

def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--report", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; this script needs an "
                 "NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}")
    report = {"card": card, "checks": []}

    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s wall for "
        + ", ".join(f"{n} {r['seconds']:.1f} s" for n, r in logs.items()))
    report["build"] = {n: r["seconds"] for n, r in logs.items()}
    for n, r in logs.items():
        entries = build.ptxas_entries(r["ptxas"])
        report["build_ptxas_" + n] = entries
        regs = [e["registers"] for e in entries] or [0]
        log(f"  ptxas {n}: {len(entries)} entries, registers "
            f"{min(regs)}-{max(regs)}, spill bytes "
            f"{sum(e['spill_bytes'] for e in entries)}")
        for e in entries:
            log(f"    {e['entry']}: {e['registers']} registers, "
                f"{e['spill_bytes']} spill bytes, {e['static_smem']} "
                f"bytes static smem")

    timer = Timer()

    def timed(phase, *args):
        t = time.perf_counter()
        out = phase(*args)
        dt = time.perf_counter() - t
        log(f"{phase.__name__}: {dt:.1f} s")
        report.setdefault("phase_s", {})[phase.__name__] = dt
        return out

    dryruns = start_dryrun()
    # this run's tile cache: empty (the kernels' own plans) but in the
    # autotune phase
    autotune.CACHE_PATH = TUNE_CACHE
    if os.path.exists(TUNE_CACHE):
        os.remove(TUNE_CACHE)
    same_content = timed(phase_kernel_checks, timer, report)
    paged_launches, captured, paged_ms, llama_qkv, zoo = timed(
        phase_main_path, report)
    timed(phase_fleet_path, report, timer, *zoo)
    timed(phase_autotune, report, timer, *zoo, captured)
    del zoo
    torch.cuda.empty_cache()
    dense_launches, dense_captured, dense_grid = timed(
        phase_dense_main_path, report, paged_ms)
    timed(phase_lossless, report)
    llm, ssms = timed(phase_fleet_lossless, report)
    timed(phase_sharded_fleet, report, llm, ssms)
    timed(phase_spec_api, report, llm, ssms[0])
    del llm, ssms
    torch.cuda.empty_cache()
    timed(phase_chunked, report)
    ops_launches, ops_inputs = timed(
        phase_ops_path, report, captured["fused_paged_verify"],
        captured["fused_paged_decode"], dense_grid)
    mixtral_qkv = timed(phase_moe_window_path, report, timer)
    timed(phase_moe_paged_path, report, timer)
    timed(phase_moe_lossless, report)
    timed(phase_moe_experts, report, timer)
    flash_launches = timed(phase_flash, report, timer,
                           [mixtral_qkv, llama_qkv])
    timed(phase_zoo, report)
    timed(phase_train, report)
    timed(phase_dryrun, report, dryruns)
    launches = {"paged": paged_launches, "dense": dense_launches,
                "ops": ops_launches, "flash": flash_launches}
    inputs = {**captured, "verify_attention": dense_captured, **ops_inputs,
              "flash_attention": {n: mixtral_qkv[n]
                                  for n in ("q", "k", "v", "window")}}

    kernels, path_recs = [], {}
    for name, (source, replaces, path) in SOURCES.items():
        a = inputs[name]
        rec = measure(name, a, timer)
        errs = [c["max_abs_err"] for c in report["checks"]
                if c["kernel"] == name] + [rec["max_abs_err"]]
        log(f"{path}-path inputs {name} shape={json.dumps(shape_of(a))} "
            f"ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
            f"library_ms={rec['library_ms']:.4f} bound_ms="
            f"{rec['bound_ms']:.5f} ({rec['bound_by']}) "
            f"err={rec['max_abs_err']:.3g} max|plain|={rec['ref_max']:.3g} "
            f"tol={rec['tol']:.3g}")
        check(rec["ok"], f"{name} disagrees on the {path} path's inputs")
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[path][name], path=path,
            max_abs_err=max(errs), ms=rec["ms"],
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec["library_ms"]))
        report[f"{path}_path_inputs_{name}"] = dict(shape=shape_of(a), **rec)
        path_recs[name] = rec
    same = {n: path_recs[n] for n in ("fused_paged_verify",
                                      "paged_verify_attention")}
    log("same input (the paged path's largest verify call): "
        + " ".join(f"{n} ms={r['ms']:.4f}" for n, r in same.items())
        + f" library_ms={same['fused_paged_verify']['library_ms']:.4f}")
    paged = measure("paged_decode_attention", same_content, timer)
    dense = measure("decode_attention", dense_of_paged(same_content), timer)
    check(paged["ok"] and dense["ok"], "the decode kernels disagree on the "
          "same-content check")
    report["same_content_decode"] = dict(paged_decode_attention=paged,
                                         decode_attention=dense)
    log(f"same content ([{SAME_CONTENT[1]}]; {paged['bytes']} bytes to "
        f"move paged, {dense['bytes']} dense): "
        f"paged_decode_attention ms={paged['ms']:.4f} bound_ms="
        f"{paged['bound_ms']:.5f} ({paged['bound_by']}) share="
        f"{paged['bound_ms'] / paged['ms']:.3f} library_ms="
        f"{paged['library_ms']:.4f}; decode_attention over the gathered "
        f"dense cache ms={dense['ms']:.4f} bound_ms={dense['bound_ms']:.5f} "
        f"library_ms={dense['library_ms']:.4f}")
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)),
                    exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
