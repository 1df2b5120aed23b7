"""The unfused paged attention kernels over a ``(N, bs, Kh, D)`` block pool
(bf16/f32, or int8/fp8 with ``(N, bs, Kh)`` float32 scales):

* ``paged_decode_attention``: one query token per row against the row's
  block table; slots valid iff their logical position is below
  ``lengths[b]``.  It runs ``decode_attention``'s run-of-tiles kernel
  (``csrc/decode_runs.cuh``) over the pool, sized by the same
  ``decode_attention.run_plan`` over the table's NB * bs slots;
* ``paged_verify_attention``: packed verification (Eq. 13) over a list of
  live blocks, the function of ``fused_verify.fused_paged_verify`` computed
  over runs of block entries (:func:`run_plan`): one CTA per (query tile,
  kv head, run); with more than one run, each writes a partial and the
  last of a (tile, head) merges them, in the same launch.
  :func:`verify_runs` launches that kernel (``csrc/verify_runs.cuh``) for
  both wrappers.

Both are public through ``kernels/ops.py``; the serving engine takes the
fused kernels instead.  On a CPU tensor each wrapper runs its plain version;
on a CUDA tensor it launches ``csrc/paged_attention.cu`` or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, decode_attention, ref

DECODE = "paged_decode_attention"
VERIFY = "paged_verify_attention"

# The plain versions: gather the blocks dense, then masked attention.
paged_decode_attention_plain = ref.paged_decode_attention_ref
paged_verify_attention_plain = ref.paged_verify_ref


RUN_CTAS_PER_SM = 2
MAX_RUNS = 32        # bounds the float32 partials' scratch
MAX_RUN_SLOTS = 1024  # a run's slots (32 tiles), where MAX_RUNS allows


def run_plan(Tq: int, G: int, Kh: int, M: int, bs: int, D: int,
             kv_bytes: int, sms: int, config=None):
    """(query tokens per CTA, block entries per run, runs, warps per team,
    stages) of one call.  A CTA holds one query row per warp where the
    GQA group allows it (``build.WARPS // G`` tokens, at least one; a
    request verifies W + 1 of them, so a tile spans one or two
    requests).  The runs bring the grid to about :data:`RUN_CTAS_PER_SM`
    CTAs per SM, each at most :data:`MAX_RUN_SLOTS` slots long as long as
    there are at most :data:`MAX_RUNS` runs; every entry lies in exactly
    one run and no run is empty (M = 0: one empty run, which writes
    zeros).

    ``config`` (``autotune.FusedConfig``; None or 0 in a field = the
    plan's choice) sets the query tokens per CTA (``bq``), the least block
    entries a run (``bk``: a list of more than :data:`MAX_RUNS` x ``bk``
    entries takes ceil(M / MAX_RUNS) a run, as the plan's own choice does,
    so that every bk launches at every M) and the stages (``depth``).  One
    the kernel cannot launch raises ``ValueError``: more than
    ``build.MAX_ROWS`` query rows a CTA, stages over
    ``build.tile_pipeline``'s budget."""
    bq_set, per_run_set, stages_set = (
        (config.bq, config.bk, config.depth) if config is not None
        else (0, 0, 0))
    bq = bq_set or max(1, build.WARPS // G)
    if bq * G > build.MAX_ROWS:
        raise ValueError(f"{bq} query tokens of GQA group {G} exceed "
                         f"{build.MAX_ROWS} rows a CTA")
    base = -(-Tq // bq) * Kh
    n = max(M, 1)
    if per_run_set:
        per_run = per_run_set
    else:
        want = max(1, round(RUN_CTAS_PER_SM * sms / base))
        per_run = min(-(-n // want), max(1, MAX_RUN_SLOTS // bs))
    per_run = max(per_run, -(-n // MAX_RUNS))
    runs = -(-n // per_run)
    tiles = -(-per_run * bs // build.KV_TILE)
    wpt, stages = build.tile_pipeline(bq * G, tiles, D, kv_bytes,
                                      base * runs, sms, stages=stages_set)
    return bq, per_run, runs, wpt, stages


def _c_fn(source, name, n_ptr, n_int):
    fn = getattr(build.load(source), "spin_" + name)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * n_ptr + [i] * n_int + [ctypes.c_float, p]
    fn.restype = i
    return fn


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths,
                           k_scale=None, v_scale=None):
    """q: (B, H, D); pools: (N, bs, Kh, D); block_tables: (B, NB) int32
    physical block per logical block (< 0 = unallocated: a live one reads
    block 0, as the reference does); lengths: (B,) int32 live prefix per
    row (at most the allocated blocks' slots).  Returns (B, H, D) in q's
    dtype; a row of length 0 gives zeros.  On the card: one launch over
    (row, kv head, run of 32-slot tiles), planned by
    ``decode_attention.run_plan`` over the NB * bs slots of a row (no host
    sync: the kernel reads the lengths); with more than one run, float32
    partials and a merge by each (row, kv head)'s last live run; one count
    in :data:`build.LAUNCHES` per call."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, block_tables,
                                            lengths, k_scale, v_scale)
    B, H, D = q.shape
    N, bs, Kh, _ = k_pool.shape
    NB = block_tables.shape[1]
    q_code, kv_code = build.check_pools(q, k_pool, v_pool, None, None,
                                        k_scale, v_scale)
    build.check_int("block_tables", block_tables, (B, NB), q.device)
    build.check_int("lengths", lengths, (B,), q.device)
    per_run, runs, wpt, stages = decode_attention.run_plan(
        B, NB * bs, H // Kh, Kh, D, k_pool.element_size(),
        build.sm_count(q.device))
    stream = build.stream_of(q)
    pm, pl, pacc, counters = build.run_scratch(runs, B, H, D, B * Kh,
                                               q.device, stream)
    out = torch.empty_like(q)
    ptr = build.ptr
    rc = _c_fn("paged_attention", DECODE, 12, 12)(
        ptr(q), ptr(k_pool), ptr(v_pool), ptr(block_tables), ptr(lengths),
        ptr(k_scale), ptr(v_scale), ptr(pm), ptr(pl), ptr(pacc),
        ptr(counters), ptr(out), B, H, Kh, D, bs, NB, per_run, runs, wpt,
        stages, q_code, kv_code, 1.0 / math.sqrt(D), stream)
    build.raise_on(rc, DECODE)
    build.LAUNCHES[DECODE] += 1
    return out


def paged_verify_attention(q, k_pool, v_pool, pool_seg, pool_pos, q_seg,
                           q_pos, block_ids, block_owner, q_anc=None,
                           block_node=None, k_scale=None, v_scale=None):
    """Packed verification over live pool blocks; arguments and result as
    ``fused_verify.fused_paged_verify``.  On the card: one launch over
    (query tile, kv head, run of block entries) (:func:`run_plan`); with
    more than one run, float32 partials and a merge by each (tile, head)'s
    last run; one count in :data:`build.LAUNCHES` per call."""
    if q.device.type == "cpu":
        return paged_verify_attention_plain(
            q, k_pool, v_pool, pool_seg, pool_pos, q_seg, q_pos, block_ids,
            block_owner, q_anc, block_node, k_scale, v_scale)
    return verify_runs("paged_attention", VERIFY, q, k_pool, v_pool,
                       pool_seg, pool_pos, q_seg, q_pos, block_ids,
                       block_owner, q_anc, block_node, k_scale, v_scale)


def verify_runs(source, name, q, k_pool, v_pool, pool_seg, pool_pos, q_seg,
                q_pos, block_ids, block_owner, q_anc, block_node, k_scale,
                v_scale, config=None):
    """One launch of the run-of-entries verify kernel
    (``csrc/verify_runs.cuh``) through entry ``spin_<name>`` of
    ``csrc/<source>.cu``: the argument checks, :func:`run_plan`, the
    float32 partials (only with more than one run) and the merge counters
    (:func:`build.merge_counters`); one count in :data:`build.LAUNCHES`
    under ``name``.  Shared by this module's ``paged_verify_attention`` and
    ``fused_verify.fused_paged_verify``; no host sync.  ``config`` (a
    tuned ``autotune.FusedConfig``, only from ``fused_paged_verify``) is
    applied over the plan by :func:`run_plan`."""
    if (q_anc is None) != (block_node is None):
        raise ValueError("q_anc and block_node come together")
    Tq, H, D = q.shape
    bs, Kh = k_pool.shape[1], k_pool.shape[2]
    M = block_ids.shape[0]
    q_code, kv_code = build.check_pools(q, k_pool, v_pool, pool_seg,
                                        pool_pos, k_scale, v_scale)
    for arg, t, shape in (("q_seg", q_seg, (Tq,)), ("q_pos", q_pos, (Tq,)),
                          ("q_anc", q_anc, (Tq,)),
                          ("block_ids", block_ids, (M,)),
                          ("block_owner", block_owner, (M,)),
                          ("block_node", block_node, (M, bs))):
        build.check_int(arg, t, shape, q.device)
    bq, per_run, runs, wpt, stages = run_plan(
        Tq, H // Kh, Kh, M, bs, D, k_pool.element_size(),
        build.sm_count(q.device), config)
    stream = build.stream_of(q)
    pm, pl, pacc, counters = build.run_scratch(runs, Tq, H, D,
                                               -(-Tq // bq) * Kh, q.device,
                                               stream)
    out = torch.empty_like(q)
    ptr = build.ptr
    rc = _c_fn(source, name, 18, 13)(
        ptr(q), ptr(k_pool), ptr(v_pool), ptr(pool_seg), ptr(pool_pos),
        ptr(q_seg), ptr(q_pos), ptr(q_anc), ptr(block_ids), ptr(block_owner),
        ptr(block_node), ptr(k_scale), ptr(v_scale), ptr(pm), ptr(pl),
        ptr(pacc), ptr(counters), ptr(out), Tq, H, Kh, D, bs, M, bq,
        per_run, runs, wpt, stages, q_code, kv_code, 1.0 / math.sqrt(D),
        stream)
    build.raise_on(rc, name)
    build.LAUNCHES[name] += 1
    return out
