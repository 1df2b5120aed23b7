#!/usr/bin/env python3
"""Smoke test of the PyTorch port of SPIN on one NVIDIA card.

    python3 chip_smoke.py [--report PATH]

Run from the root of a checkout.  Every phase that fails raises, and the
script then exits non-zero without its last line.  Phases:

1. the card (name, power limit, torch and CUDA versions);
2. the build of every CUDA kernel under src/repro_torch/kernels/csrc (one
   nvcc per source, in parallel);
3. kernel checks: each kernel against its plain PyTorch version on the
   card, at the head geometries of the serving path (LLaMA-7B verify
   H=Kh=32 D=128; SSM decode H=12 D=64 and H=16 D=96), with bf16, int8, fp8
   and float32 pools, linear and tree masks, and edge cases (idle rows,
   padding queries, trailing padding entries, ancestor bit 31);
4. the main path: the port's SpinEngine serving the mix workload with
   LLaMA-7B (32 layers, full width) and the SSMs LLaMA-68M/265M/616M at
   full width, random bf16 weights, paged bf16 KV, fused kernels on.  An
   untimed pass warms every shape up and keeps the kernels' largest
   inputs; then ``TIMED_RUNS`` timed runs, the kernels' launch counts set
   to 0 before and read after each (the first is the main path's run);
   then one run under ``torch.profiler`` for the device's busy time, read
   against the timed runs' wall time;
5. losslessness in float32 with the LLM cut to 4 layers.  With the
   reference initializer, the fused and the gather (``fused_kernels
   off``) paths are both held against plain greedy decoding and their
   first divergences reported; with the q/k projections at fan_in =
   d_model (see ``unit_attention``) the fused path's tokens must equal
   greedy decoding (a mismatch passes only where the reference's top-2
   logit gap is below 1e-4);
6. chunked prefill (64-token chunks) with int8 KV and tree speculation at
   reduced LLM depth, so that chunk appends (T > W + 1), the dequant path
   and the tree-masked verify launch;
7. timing of each kernel on the largest call the main path made (its own
   inputs, kept in phase 4): kernel, plain version and one PyTorch
   library call (scaled_dot_product_attention on the gathered K/V, a
   yardstick the port never calls), each the median of individually timed
   launches with the L2 cache flushed before each; and the bound, the
   larger of the bytes over 3.35 TB/s and the operations over the peak
   rate of the input type.

The last three lines are the kernels JSON, the card line of
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import inspect
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import spin_llama  # noqa: E402
from repro_torch.core import spec_decode as sd  # noqa: E402
from repro_torch.data.workloads import make_workload  # noqa: E402
from repro_torch.kernels import (build, cases, fused_decode,  # noqa: E402
                                 fused_verify, ops, quant)
from repro_torch.kernels.ref import tree_mask_term  # noqa: E402
from repro_torch.launch.serve import make_selector  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving.engine import EngineConfig, SpinEngine  # noqa: E402

HBM_BYTES_PER_S = 3.35e12                      # H100 SXM data sheet
TIMED_RUNS = 3
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
SOURCES = {
    "fused_paged_verify": ("src/repro_torch/kernels/csrc/fused_verify.cu",
                           "src/repro/kernels/fused_verify.py:43"),
    "fused_paged_decode": ("src/repro_torch/kernels/csrc/fused_decode.cu",
                           "src/repro/kernels/fused_decode.py:41"),
}


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


# name -> (kernel wrapper, plain version, work counter, library call)
KERNELS = {
    "fused_paged_verify": (fused_verify.fused_paged_verify,
                           fused_verify.fused_paged_verify_plain,
                           verify_work, library_verify),
    "fused_paged_decode": (fused_decode.fused_paged_decode,
                           fused_decode.fused_paged_decode_plain,
                           decode_work, library_decode),
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
    return {n: list(t.shape) for n, t in a.items() if t is not None
            and n in ("q", "k_pool", "block_ids", "block_tables")} | {
        "kv": str(a["k_pool"].dtype).replace("torch.", ""),
        "tree": a.get("block_node") is not None}


def phase_kernel_checks(timer, report):
    gen = torch.Generator().manual_seed(11)
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
    failed = []
    for name, label, a in todo:
        rec = measure(name, a, timer)
        log(f"check {name} [{label}] shape={json.dumps(shape_of(a))} "
            f"max_abs_err={rec['max_abs_err']:.3g} max|plain|="
            f"{rec['ref_max']:.3g} tol={rec['tol']:.3g} ms={rec['ms']:.4f} "
            f"plain_ms={rec['plain_ms']:.4f} "
            f"library_ms={rec['library_ms']:.4f} "
            f"bound_ms={rec['bound_ms']:.5f} ({rec['bound_by']}) "
            f"{'ok' if rec['ok'] else 'FAIL'}")
        report["checks"].append(dict(kernel=name, case=label,
                                     shape=shape_of(a), **rec))
        if not rec["ok"]:
            failed.append(f"{name} [{label}]")
    check(not failed, f"kernel checks failed: {failed}")


# ------------------------------------------------------------ serving --

def full_zoo(dtype: str, llm_layers: int = 0, ssm_layers: int = 0):
    def bundle(cfg, seed, layers):
        cfg = dataclasses.replace(cfg, dtype=dtype,
                                  n_layers=layers or cfg.n_layers)
        return sd.Bundle(cfg, T.init_params(cfg, seed, device="cuda"))

    llm = bundle(spin_llama.LLAMA_7B, 0, llm_layers)
    ssms = [bundle(c, i + 1, ssm_layers and min(ssm_layers, c.n_layers))
            for i, c in enumerate(spin_llama.SSM_ZOO[:3])]
    return llm, ssms


def serve(llm, ssms, n_req, scale, around=None, fused_kernels="on",
          **ecfg_kw):
    """Serve the mix workload to the end; ``around`` (a context manager,
    e.g. a profiler) encloses the run alone."""
    reqs = make_workload("mix", n_req, llm.cfg.vocab_size, seed=0,
                         scale=scale)
    cap = ecfg_kw.pop("capacity")
    sel = make_selector("lbss", len(ssms), cap,
                        {r.rid: r.prompt_len for r in reqs}, 0,
                        group_of={r.rid: r.dataset for r in reqs})
    ecfg = EngineConfig(gamma=4, capacity=cap, max_len=256,
                        fused_kernels=fused_kernels, **ecfg_kw)
    eng = SpinEngine(llm, ssms, sel, ecfg)
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
    """Wraps an ``ops`` entry point during the main path and keeps a copy
    of the arguments of its largest call (by query elements x block-list
    length), for phase 7's timing on the main path's own inputs."""

    def __init__(self, module, attr):
        self.module, self.attr = module, attr
        self.fn = getattr(module, attr)
        self.best, self.size = None, -1

    def __call__(self, *args, **kw):
        bound = inspect.signature(self.fn).bind(*args, **kw)
        bound.apply_defaults()
        a = dict(bound.arguments)
        a.pop("config", None)
        lst = a.get("block_ids", a.get("block_tables"))
        size = a["q"].numel() * lst.numel()
        if size > self.size:
            self.size = size
            self.best = {n: None if t is None else t.clone()
                         for n, t in a.items()}
        return self.fn(*args, **kw)

    def __enter__(self):
        setattr(self.module, self.attr, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.fn)


def phase_main_path(report):
    llm, ssms = full_zoo("bfloat16")
    log(f"main path: {llm.cfg.name} {llm.cfg.n_layers} layers d "
        f"{llm.cfg.d_model} vocab {llm.cfg.vocab_size}; SSMs "
        + ", ".join(f"{b.cfg.name} ({b.cfg.n_layers}x{b.cfg.d_model})"
                    for b in ssms) + "; bf16 weights, paged bf16 KV")
    # untimed: the first use of every shape, and the kernels' inputs
    taps = {"fused_paged_verify": Tap(ops, "fused_paged_verify"),
            "fused_paged_decode": Tap(ops, "fused_paged_decode")}
    with taps["fused_paged_verify"], taps["fused_paged_decode"]:
        serve(llm, ssms, 6, 0.3, capacity=6)
    captured = {n: t.best for n, t in taps.items()}

    runs = []
    for _ in range(TIMED_RUNS):
        build.LAUNCHES.clear()
        eng, stats, wall = serve(llm, ssms, 6, 0.3, capacity=6)
        launches = dict(build.LAUNCHES)
        for name in SOURCES:
            check(launches.get(name, 0) > 0, f"{name} never launched")
        runs.append(dict(wall_s=wall, slots=len(eng.slot_log),
                         accepted_tokens=stats["accepted_tokens"],
                         launches=launches, stats=stats))
        del eng
    main = runs[0]
    walls = [r["wall_s"] for r in runs]
    wall_slot = statistics.median(r["wall_s"] / r["slots"] for r in runs)

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    eng, _, prof_wall = serve(llm, ssms, 6, 0.3, capacity=6, around=prof)
    busy_ms, per_name = device_time(prof)
    check(busy_ms > 0, "the profiler saw no device activity")
    busy_slot = busy_ms / len(eng.slot_log)
    line = dict(goodput_sim=main["stats"]["goodput_sim"],
                wall_s=walls, wall_spread=(max(walls) - min(walls))
                / statistics.median(walls),
                tokens_per_s_wall=[r["accepted_tokens"] / r["wall_s"]
                                   for r in runs],
                accepted_tokens=[r["accepted_tokens"] for r in runs],
                slots=[r["slots"] for r in runs],
                finished=main["stats"]["scheduler"]["finished"],
                launches=main["launches"],
                launches_per_slot={k: v / main["slots"]
                                   for k, v in main["launches"].items()},
                wall_ms_per_slot=wall_slot * 1e3,
                device_busy_ms_per_slot=busy_slot,
                device_busy_share=busy_slot / (wall_slot * 1e3),
                profiled_wall_ms_per_slot=prof_wall * 1e3 / len(eng.slot_log),
                llm_layers=llm.cfg.n_layers, depth_cut=False,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    log("main path stats (warm; launches from the first timed run; device "
        "busy time from a profiled run, over the timed runs' wall time) "
        + json.dumps(line))
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])
    shown = top[:8] + [kv for kv in top[8:] if "spin::" in kv[0]]
    log("main path device ms by kernel (profiled run) " + json.dumps(
        {k[:90]: {"device_ms": ms, "calls": n} for k, (ms, n) in shown}))
    report["main_path"] = line
    del eng, llm, ssms, prof
    torch.cuda.empty_cache()
    return main["launches"], captured


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


def lossless_run(llm, ssms, fused_kernels, refs=None):
    """Serve the float32 zoo and hold each request's tokens against plain
    greedy decoding (computed here unless ``refs`` are given); a
    divergence is the first differing token and the reference's top-2
    logit gap there."""
    build.LAUNCHES.clear()
    eng, _, wall = serve(llm, ssms, 6, 0.3, capacity=6,
                         fused_kernels=fused_kernels)
    launches = dict(build.LAUNCHES)
    if refs is None:
        refs = {r.rid: greedy_reference(llm, r.prompt, r.max_new)
                for r in eng.requests.values()}
    tokens, div = {}, []
    for r in eng.requests.values():
        want, gaps = refs[r.rid]
        got = tokens[r.rid] = r.emitted[:r.max_new]
        if got != want:
            i = next((i for i, (a, b) in enumerate(zip(got, want))
                      if a != b), len(got))
            div.append(dict(rid=r.rid, index=i, gap=gaps[i],
                            got=got[i] if i < len(got) else None,
                            want=want[i]))
    line = dict(fused_kernels=fused_kernels, requests=len(tokens),
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
    unit, _, _ = lossless_run(llm, ssms, "on")
    bad = [d for d in unit["divergences"] if d["gap"] >= 1e-4]
    check(not bad, f"tokens differ from greedy decoding at top-2 gaps "
          f">= 1e-4: {bad}")
    log("lossless (float32, LLM 4 layers, unit-scale attention) "
        + json.dumps(unit))
    report["lossless"] = dict(reference_init=ref_init, unit_attention=unit)
    del llm, ssms
    torch.cuda.empty_cache()


def phase_chunked(report):
    llm, ssms = full_zoo("bfloat16", llm_layers=4, ssm_layers=4)
    build.LAUNCHES.clear()
    eng, stats, wall = serve(llm, ssms, 4, 1.0, capacity=4,
                             prefill_chunk=64, kv_dtype="int8",
                             spec_shape="tree", spec_branch=2)
    launches = dict(build.LAUNCHES)
    for name in SOURCES:
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
    for n, r in logs.items():
        notes = [ln.strip() for ln in r["ptxas"].splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"  ptxas {n}: " + " | ".join(notes[:4]))
    report["build"] = {n: r["seconds"] for n, r in logs.items()}

    timer = Timer()

    def timed(phase, *args):
        t = time.perf_counter()
        out = phase(*args)
        log(f"{phase.__name__}: {time.perf_counter() - t:.1f} s")
        return out

    timed(phase_kernel_checks, timer, report)
    launches, captured = timed(phase_main_path, report)
    timed(phase_lossless, report)
    timed(phase_chunked, report)

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        a = captured[name]
        rec = measure(name, a, timer)
        errs = [c["max_abs_err"] for c in report["checks"]
                if c["kernel"] == name] + [rec["max_abs_err"]]
        log(f"main-path inputs {name} shape={json.dumps(shape_of(a))} "
            f"ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
            f"library_ms={rec['library_ms']:.4f} bound_ms="
            f"{rec['bound_ms']:.5f} ({rec['bound_by']}) "
            f"err={rec['max_abs_err']:.3g} max|plain|={rec['ref_max']:.3g} "
            f"tol={rec['tol']:.3g}")
        check(rec["ok"], f"{name} disagrees on the main path's inputs")
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=max(errs), ms=rec["ms"],
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec["library_ms"]))
        report[f"main_path_inputs_{name}"] = dict(shape=shape_of(a), **rec)
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
