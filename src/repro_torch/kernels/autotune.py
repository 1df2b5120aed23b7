"""Tile configs of the fused speculative-step kernels, tuned on the card.

The fused kernels (``fused_verify.fused_paged_verify``, #1, and
``fused_decode.fused_paged_decode``, #2) take their launch shape from a plan
at each call (``paged_attention.verify_plan``, ``fused_decode.decode_plan``).
A :class:`FusedConfig` overrides the plan's choices; its fields keep the
reference's names (``repro.kernels.autotune``) and map onto the knobs the
CUDA kernels take:

======  ===============================  ================================
field   #1 ``verify_plan``               #2 ``decode_plan``
======  ===============================  ================================
bq      no knob: nonzero raises (a CTA   query tokens per CTA
        holds a segment's queries)
bk      least list entries a chunk       warps per team of the split
        keeps per query token (where     layout (1, 2 or 4)
        a segment's entries split)
depth   ``cp.async`` stages              stages per team (split layout)
======  ===============================  ================================

0 in any field means the plan's own choice, so :data:`DEFAULT_CONFIG`
(all 0) launches exactly what the plan alone launches.  #1's ``bk``
launches at every list length (``verify_plan``: chunks = M // (Tq bk), at
most ``MAX_CHUNKS``).  A config the kernel cannot launch raises at the call
(``ValueError``); it is never clamped.  The plain versions (CPU tensors)
ignore the config, as the reference's XLA path does.

The tuner benchmarks a small candidate grid (:func:`candidate_configs`) on
the reference's synthetic pool shapes, or on calls the caller hands it (a
serving path's own, captured; a long-context one), and caches per tune
key the fastest candidate of those that beat the default on every call by
more than the default's own spread, else the default::

    (kind | H x Kh x D | gamma_max | block_size | linear/tree | kv dtype
     | backend)

in ``results/TUNE_cache_torch.json`` (the reference's format; ``backend``
is ``sm90`` on an H100, from the device's compute capability, and ``cpu``
on the CPU).  Keys written before the kv dtype component existed migrate
to ``kvbf16`` on load and malformed keys are dropped.  The serving engine
looks its configs up once, at construction (:func:`get_config`); a cache
miss NEVER tunes implicitly (tuning runs kernels; dispatch must stay cheap
and deterministic): it falls back to :data:`DEFAULT_CONFIG`, and
``CACHE_STATS`` records the miss.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

RESULTS = Path(__file__).resolve().parents[3] / "results"
CACHE_PATH = str(RESULTS / "TUNE_cache_torch.json")
# the port's dry-run records (python -m repro_torch.launch.dryrun --json)
ROOFLINE_PATH = str(RESULTS / "torch_dryrun_baseline.json")

# current key grammar (see tune_key); legacy = same minus the kv field
_KEY_FIELDS = (r"(verify|decode)", r"H\d+xKh\d+xD\d+", r"g\d+", r"bs\d+",
               r"(linear|tree)", r"kv\w+", r"\w+")
_KEY_RE = re.compile("^" + r"\|".join(_KEY_FIELDS) + "$")
_LEGACY_RE = re.compile(
    "^" + r"\|".join(_KEY_FIELDS[:5] + _KEY_FIELDS[6:]) + "$")

# consult/miss counters, reset-able by benchmarks and tests
CACHE_STATS: Dict[str, int] = {"hits": 0, "misses": 0}

# candidates a kind, at most
MAX_CANDIDATES = 12
# timed calls a candidate (the median is kept), after one warm-up
TIMED_CALLS = 7
# the spin that holds the card while the timed calls are enqueued (~25 ms
# at 2 GHz; quadrupled while the host falls behind)
SPIN_CYCLES = 50_000_000


@dataclasses.dataclass(frozen=True)
class FusedConfig:
    """Tile config of one fused kernel launch (module docstring: the knob
    each field sets; 0 = the plan's choice).  Frozen, so it is hashable."""
    bq: int = 0
    bk: int = 0
    depth: int = 0


DEFAULT_CONFIG = FusedConfig()


def _device(device) -> torch.device:
    """``device``, by default the card: a host with none raises (pass
    ``device="cpu"`` for the CPU), as every entry point of the port."""
    from repro_torch.models.transformer import resolve_device
    return resolve_device("cuda" if device is None else device)


def backend(device=None) -> str:
    """``sm<major><minor>`` for a CUDA device (``sm90`` on an H100), else
    the device type; the default device is the card."""
    device = _device(device)
    if device.type == "cuda":
        major, minor = torch.cuda.get_device_capability(device)
        return f"sm{major}{minor}"
    return device.type


def tune_key(kind: str, *, H: int, Kh: int, D: int, gamma_max: int,
             block_size: int, shape: str = "linear",
             kv_dtype: str = "bf16", device=None) -> str:
    """Cache key: kernel kind + model attention geometry + speculation
    depth cap + paging granularity + linear/tree + kv storage dtype +
    backend (:func:`backend` of ``device``)."""
    return (f"{kind}|H{H}xKh{Kh}xD{D}|g{gamma_max}|bs{block_size}"
            f"|{shape}|kv{kv_dtype}|{backend(device)}")


def _migrate_key(key: str) -> Optional[str]:
    """Current keys pass through; pre-kv-dtype keys (necessarily bf16
    pools) gain ``kvbf16``; anything else is corrupt and dropped (returns
    None)."""
    if _KEY_RE.match(key):
        return key
    if _LEGACY_RE.match(key):
        head, back = key.rsplit("|", 1)
        return f"{head}|kvbf16|{back}"
    return None


def load_cache(path: Optional[str] = None) -> dict:
    path = path or CACHE_PATH
    try:
        with open(path) as f:
            raw = json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}
    if not isinstance(raw, dict):
        return {}
    # current-format keys win over a legacy key migrating to the same slot
    cache = {k: v for k, v in raw.items()
             if _KEY_RE.match(k) and isinstance(v, dict)}
    for key, entry in raw.items():
        mig = _migrate_key(key)
        if mig is not None and mig != key and isinstance(entry, dict):
            cache.setdefault(mig, entry)
    return cache


def save_cache(cache: dict, path: Optional[str] = None) -> None:
    path = path or CACHE_PATH
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(cache, f, indent=2, sort_keys=True)


def lookup(key: str, path: Optional[str] = None) -> Optional[FusedConfig]:
    """Cached winner for ``key``, or None (counted in CACHE_STATS)."""
    entry = load_cache(path).get(key)
    if entry is None:
        CACHE_STATS["misses"] += 1
        return None
    CACHE_STATS["hits"] += 1
    return FusedConfig(bq=int(entry.get("bq", DEFAULT_CONFIG.bq)),
                       bk=int(entry.get("bk", DEFAULT_CONFIG.bk)),
                       depth=int(entry.get("depth", DEFAULT_CONFIG.depth)))


def get_config(kind: str, *, H: int, Kh: int, D: int, gamma_max: int = 0,
               block_size: int = 0, shape: str = "linear",
               kv_dtype: str = "bf16", path: Optional[str] = None,
               device=None) -> FusedConfig:
    """Construction-time lookup with the safe default fallback."""
    if kind not in ("verify", "decode"):
        raise ValueError(f"unknown fused kernel kind {kind!r}")
    cfg = lookup(tune_key(kind, H=H, Kh=Kh, D=D, gamma_max=gamma_max,
                          block_size=block_size, shape=shape,
                          kv_dtype=kv_dtype, device=device), path)
    return cfg if cfg is not None else DEFAULT_CONFIG


# ---------------------------------------------------------- candidates --

def _feasible(kind: str, cfg: FusedConfig, G: int, D: int,
              kv_bytes: int) -> bool:
    """Whether ``cfg`` launches at every call of its kind (what the tuner
    may offer), by the checks the plans make: rows a CTA, rows a warp,
    stages and their shared memory.  A decode config sets all three fields
    or none: the plan's query tile, and with it the layout, changes from
    call to call.  A verify config sets no ``bq`` and its stages fit at
    the longest list a CTA keeps, on every path its pools may take (an
    unquantized key's bf16 pools on the tensor cores, float32 ones on the
    CUDA cores; ``kv_bytes`` 4 stands for both)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import LIST_CAP, verify_plan
    if cfg == DEFAULT_CONFIG:
        return True
    if kind == "verify":
        paths = {4: ((4, 4), (2, 2)), 2: ((2, 2),), 1: ((2, 1),)}[kv_bytes]
        try:
            for q_bytes, kv in paths:
                verify_plan(LIST_CAP, G, 1, LIST_CAP, 16, D, q_bytes, kv, 1,
                            cfg)
        except ValueError:
            return False
        return True
    if not (cfg.bq and cfg.bk and cfg.depth):
        return False
    rows = cfg.bq * G
    if rows > build.MAX_ROWS:
        return False
    try:
        build.tile_pipeline(rows, 1, D, kv_bytes, 1, 1, wpt=cfg.bk,
                            stages=cfg.depth)
    except ValueError:
        return False
    return True


def roofline_candidates(kind: str, block_size: int,
                        path: Optional[str] = None) -> List[FusedConfig]:
    """Extra grid points from the port's dry-run records (``--roofline
    --json``, default ``results/torch_dryrun_baseline.json``).  Memory-bound
    cells reward deeper ``cp.async`` pipelining; compute- or
    collective-bound ones a finer split of long verify lists (more CTAs
    for the tensor cores) or, for decode, nothing new.  Missing/empty
    file -> no extra candidates."""
    try:
        with open(path or ROOFLINE_PATH) as f:
            records = json.load(f)
    except (OSError, json.JSONDecodeError):
        return []
    doms = set()
    for rec in records if isinstance(records, list) else []:
        if not isinstance(rec, dict):
            continue
        rf = rec.get("roofline") or {}
        if rec.get("status", "ok") == "ok" and rf.get("dominant"):
            doms.add(rf["dominant"])
    out = []
    if "memory" in doms:
        out += ([FusedConfig(depth=d) for d in (3, 4)] if kind == "verify"
                else [FusedConfig(bq=1, bk=4, depth=d) for d in (3, 4)])
    if ("compute" in doms or "collective" in doms) and kind == "verify":
        out.append(FusedConfig(bk=2))   # split long lists more finely
    return out


def candidate_configs(kind: str, block_size: int,
                      roofline_path: Optional[str] = None, *, G: int = 1,
                      D: int = 128, kv_bytes: int = 2) -> List[FusedConfig]:
    """At most :data:`MAX_CANDIDATES` configs feasible on the card at GQA
    group ``G``, head dim ``D`` and ``kv_bytes`` a K/V element, around the
    plan's own choice (:data:`DEFAULT_CONFIG` first):

    * verify: chunks of 4 and 16 list entries a query token (finer and
      coarser splits of long lists); 1 and 3 stages; the finer split with
      3 stages;
    * decode: one or two query tokens a CTA, teams of 1, 2 or 4 warps,
      1, 2 or 4 stages (the plan's draft step is one token, one-warp
      teams, two stages);

    then the roofline-derived points.  Kept small: tuning runs kernels."""
    if kind == "verify":
        grid = ([FusedConfig(bk=n) for n in (4, 16)]
                + [FusedConfig(depth=d) for d in (1, 3)]
                + [FusedConfig(bk=4, depth=3)])
    elif kind == "decode":
        grid = [FusedConfig(bq=b, bk=w, depth=s)
                for w, s in ((1, 2), (1, 1), (2, 2), (4, 1), (1, 4), (4, 2),
                             (2, 1))
                for b in (1, 2)]
    else:
        raise ValueError(f"unknown kernel kind {kind!r}")
    out = [DEFAULT_CONFIG]
    for cfg in grid + roofline_candidates(kind, block_size, roofline_path):
        if cfg not in out and _feasible(kind, cfg, G, D, kv_bytes):
            out.append(cfg)
    return out[:MAX_CANDIDATES]


# -------------------------------------------------------------- tuning --

def _synthetic_pool(H, Kh, D, gamma_max, block_size, seed=0, device="cpu"):
    """Tiny but representative paged state: 4 rows, 2 blocks each, the
    speculation window of the last row half-written.  The arrays are the
    reference's, drawn from the same numpy generator in the same order
    (float32 pools; ``rng`` continues for the queries)."""
    rng = np.random.default_rng(seed)
    bs = block_size
    B, nb = 4, 2
    N = B * nb + 2                                     # + free blocks
    k_pool = rng.standard_normal((N, bs, Kh, D))
    v_pool = rng.standard_normal((N, bs, Kh, D))
    bt = np.full((B, nb), -1, np.int32)
    seg = np.full((N, bs), -1, np.int32)
    pos = np.zeros((N, bs), np.int32)
    ids, owner = [], []
    ctx = bs + max(2, bs // 2)                         # straddles 2 blocks
    for b in range(B):
        for lb in range(nb):
            blk = b * nb + lb
            bt[b, lb] = blk
            ids.append(blk)
            owner.append(b)
            lo = lb * bs
            n = int(np.clip(ctx - lo, 0, bs))
            seg[blk, :n] = 0
            pos[blk] = lo + np.arange(bs)
    m = 1 << (len(ids) - 1).bit_length()
    ids += [0] * (m - len(ids))
    owner += [-1] * (m - len(owner))
    W = max(1, gamma_max)
    lens = np.full(B, ctx, np.int64)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    i32 = torch.int32
    return dict(k_pool=t(k_pool, torch.float32),
                v_pool=t(v_pool, torch.float32),
                pool_seg=t(seg, i32), pool_pos=t(pos, i32), bt=t(bt, i32),
                ids=t(ids, i32), owner=t(owner, i32),
                lens=lens, W=W, B=B, rng=rng)


def _tolerance(out, ref) -> float:
    """The kernels' tolerance (PERF.md §2): 2^-6 x max(1, max|plain|) for
    bf16 output, 1e-4 x max(1, max|plain|) for float32."""
    scale = max(1.0, ref.float().abs().max().item())
    return (2.0 ** -6 if out.dtype == torch.bfloat16 else 1e-4) * scale


def _times_us(fn, device, calls: int = TIMED_CALLS) -> List[float]:
    """``calls`` individually timed calls of ``fn`` after one warm-up, in
    µs: CUDA events on the card, with the L2 cache flushed before each call
    (the serving path finds a layer's KV cold) and a spin kernel holding
    the device while the host enqueues them all, so that each event pair
    reads the device's time of the call's own kernels, not the host's
    launch time; the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        ts = []
        for _ in range(calls):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e6)
        return ts
    flush = torch.empty(32 << 20, dtype=torch.float32, device=device)
    spin = SPIN_CYCLES
    for _ in range(4):
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(calls)]
        spun = torch.cuda.Event()
        torch.cuda._sleep(spin)
        spun.record()
        for s, e in ev:
            flush.zero_()
            s.record()
            fn()
            e.record()
        host_ahead = not spun.query()    # still spinning: host was ahead
        torch.cuda.synchronize(device)
        if host_ahead:
            return [s.elapsed_time(e) * 1e3 for s, e in ev]
        spin *= 4
    raise RuntimeError("the host could not enqueue the timed calls ahead "
                       "of the device")


def synthetic_call(kind, H, Kh, D, gamma_max, block_size, shape, kv_dtype,
                    seed, device) -> dict:
    """The kernel's arguments over :func:`_synthetic_pool`: bf16 queries on
    the card (float32 on the CPU) and pools of ``kv_dtype`` (bf16, or
    int8/fp8 with scales)."""
    from repro_torch.kernels import quant
    syn = _synthetic_pool(H, Kh, D, gamma_max, block_size, seed, device)
    B, W, rng = syn["B"], syn["W"], syn["rng"]
    cdt = torch.bfloat16 if device.type == "cuda" else torch.float32
    k_scale = v_scale = None
    qdt = quant.storage_dtype(kv_dtype)
    if qdt is not None:
        syn["k_pool"], k_scale = quant.quantize(syn["k_pool"], qdt)
        syn["v_pool"], v_scale = quant.quantize(syn["v_pool"], qdt)
    else:
        syn["k_pool"] = syn["k_pool"].to(cdt)
        syn["v_pool"] = syn["v_pool"].to(cdt)

    def i32(a):
        return torch.as_tensor(np.asarray(a), device=device).to(torch.int32)

    if kind == "verify":
        Tq = B * (W + 1)
        q = torch.as_tensor(rng.standard_normal((Tq, H, D)),
                            device=device).to(cdt)
        return dict(
            q=q, k_pool=syn["k_pool"], v_pool=syn["v_pool"],
            pool_seg=syn["pool_seg"], pool_pos=syn["pool_pos"],
            q_seg=i32(np.repeat(np.arange(B), W + 1)),
            q_pos=i32(np.concatenate([syn["lens"][b] + np.arange(W + 1)
                                      for b in range(B)])),
            block_ids=syn["ids"], block_owner=syn["owner"],
            q_anc=(torch.full((Tq,), -1, dtype=torch.int32, device=device)
                   if shape == "tree" else None),
            block_node=(torch.full((syn["ids"].shape[0], block_size), -1,
                                   dtype=torch.int32, device=device)
                        if shape == "tree" else None),
            k_scale=k_scale, v_scale=v_scale)
    if kind == "decode":
        T = W + 1
        q = torch.as_tensor(rng.standard_normal((B, T, H, D)),
                            device=device).to(cdt)
        return dict(
            q=q, k_pool=syn["k_pool"], v_pool=syn["v_pool"],
            pool_seg=syn["pool_seg"], pool_pos=syn["pool_pos"],
            q_seg=torch.zeros((B, T), dtype=torch.int32, device=device),
            q_pos=i32(syn["lens"][:, None] + np.arange(T)[None]),
            block_tables=syn["bt"], k_scale=k_scale, v_scale=v_scale)
    raise ValueError(f"unknown kernel kind {kind!r}")


def autotune(kind: str, *, H: int, Kh: int, D: int, gamma_max: int,
             block_size: int, shape: str = "linear",
             kv_dtype: str = "bf16", path: Optional[str] = None,
             seed: int = 0, device=None,
             calls: Optional[List[dict]] = None) -> FusedConfig:
    """Benchmark the candidate grid for one tune key on ``device`` (the
    card by default; a host without one raises), persist and return the
    config kept.  Safe to re-run
    (overwrites the entry).

    The candidates run on the synthetic pool (:func:`synthetic_call`), or
    on ``calls``: the kernel's arguments of calls to tune on (a serving
    path's own, captured; a long-context one), whose queries and pools
    have this key's geometry and kv dtype.  Every candidate's output is
    held to the plain version at the kernels' tolerance on every call
    before it may win, and one that disagrees raises.  A candidate beats
    the default on a call if its median there is below the default's
    fastest call, that is by more than the default's own spread.  Kept:
    of the candidates that beat the default on every call, the one of the
    least sum of medians; where none does, the default (a config faster on
    short calls can be slower on long ones).  On the CPU every candidate runs the plain version (the config is
    ignored there), so the cache round trip is testable.  The entry keeps
    the config kept, its time, the default's, the fastest candidate and
    every candidate's times (``trials``)."""
    from repro_torch.kernels import quant
    from repro_torch.kernels.fused_decode import (fused_paged_decode,
                                                  fused_paged_decode_plain)
    from repro_torch.kernels.fused_verify import (fused_paged_verify,
                                                  fused_paged_verify_plain)

    if kind == "verify":
        kern, plain = fused_paged_verify, fused_paged_verify_plain
    elif kind == "decode":
        kern, plain = fused_paged_decode, fused_paged_decode_plain
    else:
        raise ValueError(f"unknown kernel kind {kind!r}")
    qdt = quant.storage_dtype(kv_dtype)
    if calls:
        device = calls[0]["q"].device
        for a in calls:
            got = (a["q"].shape[-2], a["k_pool"].shape[2], a["q"].shape[-1],
                   a.get("k_scale") is not None)
            if got != (H, Kh, D, qdt is not None):
                raise ValueError(f"a call of (H, Kh, D, quantized) {got} "
                                 f"does not belong to the key's "
                                 f"{(H, Kh, D, kv_dtype)}")
        on = "calls"
    else:
        device = _device(device)
        calls = [synthetic_call(kind, H, Kh, D, gamma_max, block_size,
                                 shape, kv_dtype, seed, device)]
        on = "synthetic"

    refs = [plain(**a) for a in calls]
    # an unquantized key serves bf16 and float32 pools alike: its configs
    # must launch on float32 tiles too
    cands = candidate_configs(kind, block_size, G=H // Kh, D=D,
                              kv_bytes=1 if qdt is not None else 4)
    trials = []
    for cfg in cands:
        err = 0.0
        for a, ref in zip(calls, refs):
            out = kern(**a, config=cfg)
            e = (out.float() - ref.float()).abs().max().item()
            tol = _tolerance(out, ref)
            if not (bool(torch.isfinite(out.float()).all()) and e <= tol):
                raise RuntimeError(
                    f"{kind} candidate {cfg} disagrees with the plain "
                    f"version: max abs error {e:.3g} over the tolerance "
                    f"{tol:.3g}")
            err = max(err, e)
        times = [_times_us(lambda: kern(**a, config=cfg), device)
                 for a in calls]
        med = [statistics.median(t) for t in times]
        trials.append(dict(bq=cfg.bq, bk=cfg.bk, depth=cfg.depth,
                           us=sum(med), min_us=sum(min(t) for t in times),
                           us_calls=med, min_us_calls=[min(t) for t in times],
                           max_abs_err=err))
    default = trials[0]
    best = min(trials, key=lambda t: t["us"])
    beat = [t for t in trials[1:]
            if all(m < d for m, d in zip(t["us_calls"],
                                         default["min_us_calls"]))]
    kept = min(beat, key=lambda t: t["us"]) if beat else default
    key = tune_key(kind, H=H, Kh=Kh, D=D, gamma_max=gamma_max,
                   block_size=block_size, shape=shape, kv_dtype=kv_dtype,
                   device=device)
    cache = load_cache(path)
    cache[key] = {"bq": kept["bq"], "bk": kept["bk"], "depth": kept["depth"],
                  "us": round(kept["us"], 1),
                  "default_us": round(default["us"], 1),
                  "default_min_us": round(default["min_us"], 1),
                  "fastest": {k: best[k] for k in ("bq", "bk", "depth",
                                                   "us")},
                  "on": on, "candidates": len(cands), "trials": trials}
    save_cache(cache, path)
    return FusedConfig(bq=kept["bq"], bk=kept["bk"], depth=kept["depth"])
