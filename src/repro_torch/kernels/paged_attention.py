"""The unfused paged attention kernels over a ``(N, bs, Kh, D)`` block pool
(bf16/f32, or int8/fp8 with ``(N, bs, Kh)`` float32 scales):

* ``paged_decode_attention``: one query token per row against the row's
  block table; slots valid iff their logical position is below
  ``lengths[b]``.  It runs ``decode_attention``'s run-of-tiles kernel
  (``csrc/decode_runs.cuh``) over the pool, sized by the same
  ``decode_attention.run_plan`` over the table's NB * bs slots;
* ``paged_verify_attention``: packed verification (Eq. 13) over a list of
  live blocks, the function of ``fused_verify.fused_paged_verify`` by the
  same kernel: one CTA per (segment tile, kv head group, chunk), the segments
  found on the card, bf16 queries scored on the tensor cores
  (:func:`verify_plan`); with more than one chunk, each writes a partial
  and the last of a (tile, head) merges them, in the same launch.
  :func:`launch_verify` launches it (``csrc/verify_runs.cuh``) for both
  wrappers.

Both are public through ``kernels/ops.py``; the serving engine takes the
fused kernels instead.  On a CPU tensor each wrapper runs its plain version;
on a CUDA tensor it launches ``csrc/paged_attention.cu`` or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build, decode_attention, ref

DECODE = "paged_decode_attention"
VERIFY = "paged_verify_attention"

# The plain versions: gather the blocks dense, then masked attention.
paged_decode_attention_plain = ref.paged_decode_attention_ref
paged_verify_attention_plain = ref.paged_verify_ref


# The packed verify (csrc/verify_runs.cuh): one CTA per (segment tile, kv
# head, chunk).  Tensor cores (bf16 queries, bf16/int8/fp8 pools, D % 16
# == 0): up to MMA_ROWS query rows a CTA, K/V tiles of MMA_KEYS slots in
# MMA_STAGES cp.async buffers; else the CUDA cores' tile pipeline, up to
# build.MAX_ROWS rows.
MMA_ROWS = 64          # kMmaRows: four 16-row m-tiles
MMA_KEYS = 64          # kKeys: K/V rows of a tile (its slots x its heads)
SEG_TOKENS = 5         # a verify segment at the default depth (gamma 4)
MMA_STAGES = 2         # the plan's stages on the tensor cores
MMA_MAX_STAGES = 4     # kMaxStages
SPLIT_ENTRIES = 8      # list entries a token before a segment is split
MAX_CHUNKS = 16        # chunks a segment at most (bounds the partials)
LIST_CAP = 2048        # list entries a CTA keeps in shared memory
SCAN_BATCH = 1024      # kBatch: list entries a CTA reads a round
SMEM_PER_CTA = 227 * 1024


class VerifyPlan(NamedTuple):
    """The launch integers in the kernel's order, then its shared memory."""
    tokens: int    # query tokens a tile at most (its rows: tokens x G)
    span: int      # query tokens a CTA looks at for tiles
    chunks: int    # chunks a segment's entries are dealt to (1: no split)
    cap: int       # list entries a CTA keeps in shared memory
    mma: bool      # the tensor-core path
    heads: int     # kv heads a CTA (1 on the CUDA cores)
    wpt: int       # warps per team (CUDA cores; 0 on the tensor cores)
    stages: int    # cp.async buffers (a team's, on the CUDA cores)
    smem: int      # dynamic shared memory of a CTA, bytes (at most)


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def mma_smem(cap: int, D: int, kv_bytes: int, stages: int,
             tree: bool = True) -> int:
    """``vseg::mma_smem``: the list (blocks; entries for trees), the stages
    (K and V rows of the pool's type padded by 16 bytes; 64-word tag
    arrays: owner, seg, pos, node for trees, k/v scales for int8/fp8) and,
    for int8/fp8 pools, the tile widened to bf16; the key teams' merge
    buffer reuses the stages (the queries go straight to registers).  The
    plan counts a tree's (the most a call takes)."""
    tags = 3 + tree + 2 * (kv_bytes == 1)
    area = stages * (2 * MMA_KEYS * (D * kv_bytes + 16) + tags * MMA_KEYS * 4)
    if kv_bytes == 1:
        area += 2 * MMA_KEYS * (D + 8) * 2
    merge = 4 * MMA_ROWS * (D + 4)
    return (1 + tree) * _align16(4 * cap) + max(area, merge)


def verify_plan(Tq: int, G: int, Kh: int, M: int, bs: int, D: int,
                q_bytes: int, kv_bytes: int, sms: int,
                config=None) -> VerifyPlan:
    """The launch of one packed verify call, from what the host knows:
    the query tokens ``Tq``, the GQA group, the kv heads, the block list's
    length ``M``, the block size, the head dim, the element sizes, the SM
    count; nothing is read back from the card.

    A CTA takes a tile of one segment's queries for ``heads`` kv heads (at
    most MMA_ROWS rows, or build.MAX_ROWS with one head) and streams that
    segment's blocks once for them: the list scan, the slots' tags and the
    CTA's fixed costs are shared by its heads.  On the tensor cores
    ``heads`` is the most of 4, 2, 1 that divides Kh, leaves a tile
    SEG_TOKENS tokens (MMA_ROWS // (heads G) >= SEG_TOKENS: a verify
    segment at the serving path's default depth fits one tile; a longer
    run of one segment's tokens takes more tiles) and, counting a segment
    every SEG_TOKENS tokens, still gives a CTA an SM; one where the plan
    splits (long lists stream in bigger tiles).  A CTA looks at ``span`` =
    SEG_TOKENS - 1 tokens (at most a tile's) and takes every tile that
    starts among them, so that the grid has about one CTA a segment and
    kv head group, not one a token.  The
    segments are found on the card, so the plan sizes the split by the list
    entries a query token has, M / Tq: a segment of n tokens holds about n
    M / Tq entries.  Up to SPLIT_ENTRIES a token (a serving verify: a few
    blocks a request over W + 1 tokens) there is one chunk: no partials,
    no counters, no merge.  Beyond it (few segments with long lists) each
    segment's entries are dealt to ``chunks`` = M // (Tq SPLIT_ENTRIES)
    chunks, at most MAX_CHUNKS, so each chunk keeps about SPLIT_ENTRIES
    entries a token; a chunk's list holds ``cap`` = ceil(M / chunks)
    entries, at most LIST_CAP (a longer share streams in windows).

    ``config`` (``autotune.FusedConfig``; None or 0 in a field = the
    plan's choice): ``bk`` replaces SPLIT_ENTRIES (the least list entries a
    chunk keeps per query token), ``depth`` the stages.  ``bq`` has no
    knob (a CTA's tile is its segment's queries) and raises
    ``ValueError``, as any config the kernel cannot launch does: stages
    over MMA_MAX_STAGES or shared memory over a CTA's (tensor cores), or
    over ``build.tile_pipeline``'s budget (CUDA cores)."""
    bq, bk, depth = ((config.bq, config.bk, config.depth)
                     if config is not None else (0, 0, 0))
    if bq:
        raise ValueError(f"bq {bq}: the packed verify has no query-tile "
                         "knob (a CTA holds a tile of one segment's queries)")
    mma = q_bytes == 2 and kv_bytes in (1, 2) and D % 16 == 0
    per_token = bk or SPLIT_ENTRIES
    chunks = max(1, min(MAX_CHUNKS, M // (max(Tq, 1) * per_token)))
    cap = max(1, min(-(-M // chunks), LIST_CAP))
    if mma:
        segments = max(1, Tq // SEG_TOKENS)
        heads = next(n for n in (4, 2, 1) if n == 1 or (
            Kh % n == 0 and MMA_ROWS // (n * G) >= SEG_TOKENS
            and chunks == 1 and segments * (Kh // n) >= sms))
        tokens = MMA_ROWS // (heads * G)
        stages = depth or MMA_STAGES
        smem = mma_smem(cap, D, kv_bytes, stages)
        if stages > MMA_MAX_STAGES or smem > SMEM_PER_CTA:
            raise ValueError(
                f"{stages} stages take {smem} bytes of shared memory; the "
                f"budget is {SMEM_PER_CTA} (at most {MMA_MAX_STAGES} stages)")
        return VerifyPlan(tokens, min(SEG_TOKENS - 1, tokens), chunks, cap,
                          True, heads, 0, stages, smem)
    tokens = build.MAX_ROWS // G
    rows = tokens * G
    ctas = -(-Tq // tokens) * Kh * chunks
    wpt, stages = build.tile_pipeline(rows, -(-cap * bs // build.KV_TILE), D,
                                      kv_bytes, ctas, sms, stages=depth)
    teams = build.WARPS // wpt
    smem = (2 * _align16(4 * cap) + _align16(4 * rows * D)
            + max(teams * stages * build.stage_bytes(D, kv_bytes),
                  4 * teams * rows * (D + 2)))
    return VerifyPlan(tokens, min(SEG_TOKENS - 1, tokens), chunks, cap, False,
                      1, wpt, stages, smem)


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
                           block_node=None, k_scale=None, v_scale=None,
                           window=0):
    """Packed verification over live pool blocks; arguments and result as
    ``fused_verify.fused_paged_verify``.  On the card: the same launch
    (:func:`launch_verify`, :func:`verify_plan`) through this source's own
    entry; one count in :data:`build.LAUNCHES` per call."""
    if q.device.type == "cpu":
        return paged_verify_attention_plain(
            q, k_pool, v_pool, pool_seg, pool_pos, q_seg, q_pos, block_ids,
            block_owner, q_anc, block_node, k_scale, v_scale, window)
    return launch_verify("paged_attention", VERIFY, q, k_pool, v_pool,
                         pool_seg, pool_pos, q_seg, q_pos, block_ids,
                         block_owner, q_anc, block_node, k_scale, v_scale,
                         window=window)


def launch_verify(source, name, q, k_pool, v_pool, pool_seg, pool_pos,
                  q_seg, q_pos, block_ids, block_owner, q_anc, block_node,
                  k_scale, v_scale, config=None, window=0):
    """One launch of the packed verify (``csrc/verify_runs.cuh``) through
    entry ``spin_<name>`` of ``csrc/<source>.cu``: the argument checks,
    :func:`verify_plan`, and with more than one chunk the float32 partials
    and the merge counters (:func:`build.merge_counters`, one per (token,
    kv head group)); one count in :data:`build.LAUNCHES` under ``name``,
    and one in :data:`build.VERIFY_SPLITS` where the plan splits.  Shared
    by this module's ``paged_verify_attention`` and
    ``fused_verify.fused_paged_verify``; no host sync.  The segments'
    queries need not be contiguous (each run of tokens of one segment is
    tiled on its own).
    ``config`` (a tuned ``autotune.FusedConfig``, only from
    ``fused_paged_verify``) is applied by :func:`verify_plan`; ``window``
    (0: none) masks slots at or before q_pos - window."""
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
    plan = verify_plan(Tq, H // Kh, Kh, M, bs, D, q.element_size(),
                       k_pool.element_size(), build.sm_count(q.device),
                       config)
    stream = build.stream_of(q)
    pm, pl, pacc, counters = build.run_scratch(plan.chunks, Tq, H, D,
                                               Tq * Kh // plan.heads,
                                               q.device, stream)
    out = torch.empty_like(q)
    ptr = build.ptr
    rc = _c_fn(source, name, 18, 17)(
        ptr(q), ptr(k_pool), ptr(v_pool), ptr(pool_seg), ptr(pool_pos),
        ptr(q_seg), ptr(q_pos), ptr(q_anc), ptr(block_ids), ptr(block_owner),
        ptr(block_node), ptr(k_scale), ptr(v_scale), ptr(pm), ptr(pl),
        ptr(pacc), ptr(counters), ptr(out), Tq, H, Kh, D, bs, M,
        plan.tokens, plan.span, plan.chunks, plan.cap, int(plan.mma),
        plan.heads, plan.wpt, plan.stages, q_code, kv_code, int(window),
        1.0 / math.sqrt(D), stream)
    build.raise_on(rc, name)
    build.LAUNCHES[name] += 1
    if plan.chunks > 1:
        build.VERIFY_SPLITS += 1
    return out
