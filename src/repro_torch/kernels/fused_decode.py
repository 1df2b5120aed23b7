"""Fused paged decode: T query tokens per row attend the row's own blocks,
walked through its block table straight from the paged pool.

Serves SSM draft steps (T = 1), the SSM catch-up (T = W + 1), chunked
prefill appends (T = the bucketed chunk width) and unpacked verification.
``fused_paged_decode`` is the wrapper.  On a CPU tensor it runs the plain
version (:func:`fused_paged_decode_plain`: gather each row's blocks dense,
then masked attention).  On a CUDA tensor it launches the hand-written
kernel ``csrc/fused_decode.cu`` or raises; there is no fallback on the card.
:func:`decode_plan` picks the kernel's layout: a CTA with fewer query rows
than warps deals the row's tiles to its warps (the draft steps and the
catch-up); four rows or more keep the row layout, each warp scoring its
rows over every tile.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, ref

NAME = "fused_paged_decode"

# The plain version: gather each row's blocks dense, then masked attention.
fused_paged_decode_plain = ref.paged_seq_decode_ref


def decode_plan(B: int, T: int, G: int, Kh: int, NB: int, bs: int, D: int,
                kv_bytes: int, sms: int, config=None):
    """(query tokens per CTA, warps per team, stages) of one call.  The
    query tile is :func:`build.query_tile`'s (about two CTAs per SM).  A
    tile of fewer than four rows (``build.WARPS``) takes the split layout:
    the row's 32-slot tiles (at most ``ceil(NB * bs / 32)``) are dealt to
    teams of warps, sized by :func:`build.tile_pipeline`.  Otherwise warps
    per team is 0: the row layout, each warp scoring its rows over every
    tile.

    ``config`` (``autotune.FusedConfig``; None or 0 in a field = the
    plan's choice) sets the query tokens per CTA (``bq``), the warps per
    team of the split layout (``bk``: 1, 2 or 4; a nonzero one takes the
    split layout whatever the rows) and its stages (``depth``).  One the
    kernel cannot launch raises ``ValueError``: more than
    ``build.MAX_ROWS`` rows a CTA, more rows than the team's warps hold,
    stages over ``build.tile_pipeline``'s budget, stages for the row
    layout."""
    bq_set, wpt_set, stages_set = (
        (config.bq, config.bk, config.depth) if config is not None
        else (0, 0, 0))
    bq = bq_set or build.query_tile(T, G, B * Kh, sms)
    if bq * G > build.MAX_ROWS:
        raise ValueError(f"{bq} query tokens of GQA group {G} exceed "
                         f"{build.MAX_ROWS} rows a CTA")
    if not wpt_set and bq * G >= build.WARPS:
        if stages_set:
            raise ValueError(f"{bq * G} rows a CTA take the row layout, "
                             f"which has no stages")
        return bq, 0, 0
    wpt, stages = build.tile_pipeline(bq * G, -(-NB * bs // build.KV_TILE),
                                      D, kv_bytes, B * Kh * -(-T // bq), sms,
                                      wpt=wpt_set, stages=stages_set)
    return bq, wpt, stages


def _c_fn():
    fn = build.load("fused_decode").spin_fused_paged_decode
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 11 + [i] * 13 + [ctypes.c_float, p]
    fn.restype = i
    return fn


def fused_paged_decode(q, k_pool, v_pool, pool_seg, pool_pos, q_seg, q_pos,
                       block_tables, k_scale=None, v_scale=None, config=None,
                       window=0):
    """Multi-token paged decode.

    q: (B, T, H, D); pools: (N, bs, Kh, D); pool_seg/pool_pos: (N, bs)
    per-slot validity (-1 = not attendable) and absolute position;
    q_seg/q_pos: (B, T) (seg -1 = bucket padding, zero output);
    block_tables: (B, NB) physical block per logical block, -1 =
    unallocated (allocated as a prefix); optional (N, bs, Kh) float32 scales
    for int8/fp8 pools; ``config``: a tuned ``autotune.FusedConfig`` over
    :func:`decode_plan` (the plain version ignores it); ``window`` > 0
    masks the slots at or before q_pos - window too (0: none).  Returns
    (B, T, H, D) in q's dtype; a row with no blocks gives zeros."""
    if q.device.type == "cpu":
        return fused_paged_decode_plain(
            q, k_pool, v_pool, pool_seg, pool_pos, q_seg, q_pos,
            block_tables, k_scale, v_scale, window)
    B, T, H, D = q.shape
    NB = block_tables.shape[1]
    q_code, kv_code = build.check_pools(q, k_pool, v_pool, pool_seg,
                                        pool_pos, k_scale, v_scale)
    for name, t, shape in (("q_seg", q_seg, (B, T)), ("q_pos", q_pos, (B, T)),
                           ("block_tables", block_tables, (B, NB))):
        build.check_int(name, t, shape, q.device)
    out = torch.empty_like(q)
    _, bs, Kh, _ = k_pool.shape
    bq, wpt, stages = decode_plan(B, T, H // Kh, Kh, NB, bs, D,
                                  k_pool.element_size(),
                                  build.sm_count(q.device), config)
    ptr = build.ptr
    rc = _c_fn()(
        ptr(q), ptr(k_pool), ptr(v_pool), ptr(pool_seg), ptr(pool_pos),
        ptr(q_seg), ptr(q_pos), ptr(block_tables), ptr(k_scale),
        ptr(v_scale), ptr(out), B, T, H, Kh, D, bs, NB, bq, wpt, stages,
        q_code, kv_code, int(window), 1.0 / math.sqrt(D),
        build.stream_of(q))
    build.raise_on(rc, NAME)
    build.LAUNCHES[NAME] += 1
    return out
