"""Fused paged decode: T query tokens per row attend the row's own blocks,
walked through its block table straight from the paged pool.

Serves SSM draft steps (T = 1), the SSM catch-up (T = W + 1), chunked
prefill appends (T = the bucketed chunk width) and unpacked verification.
``fused_paged_decode`` is the wrapper.  On a CPU tensor it runs the plain
version (:func:`fused_paged_decode_plain`: gather each row's blocks dense,
then masked attention).  On a CUDA tensor it launches the hand-written
kernel ``csrc/fused_decode.cu`` or raises; there is no fallback on the card.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, ref

NAME = "fused_paged_decode"

# The plain version: gather each row's blocks dense, then masked attention.
fused_paged_decode_plain = ref.paged_seq_decode_ref


def _c_fn():
    fn = build.load("fused_decode").spin_fused_paged_decode
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 11 + [i] * 10 + [ctypes.c_float, p]
    fn.restype = i
    return fn


def fused_paged_decode(q, k_pool, v_pool, pool_seg, pool_pos, q_seg, q_pos,
                       block_tables, k_scale=None, v_scale=None):
    """Multi-token paged decode.

    q: (B, T, H, D); pools: (N, bs, Kh, D); pool_seg/pool_pos: (N, bs)
    per-slot validity (-1 = not attendable) and absolute position;
    q_seg/q_pos: (B, T) (seg -1 = bucket padding, zero output);
    block_tables: (B, NB) physical block per logical block, -1 =
    unallocated (allocated as a prefix); optional (N, bs, Kh) float32 scales
    for int8/fp8 pools.  Returns (B, T, H, D) in q's dtype; a row with no
    blocks gives zeros."""
    if q.device.type == "cpu":
        return fused_paged_decode_plain(
            q, k_pool, v_pool, pool_seg, pool_pos, q_seg, q_pos,
            block_tables, k_scale, v_scale)
    B, T, H, D = q.shape
    NB = block_tables.shape[1]
    q_code, kv_code = build.check_pools(q, k_pool, v_pool, pool_seg,
                                        pool_pos, k_scale, v_scale)
    for name, t, shape in (("q_seg", q_seg, (B, T)), ("q_pos", q_pos, (B, T)),
                           ("block_tables", block_tables, (B, NB))):
        build.check_int(name, t, shape, q.device)
    out = torch.empty_like(q)
    G = H // k_pool.shape[2]
    ptr = build.ptr
    rc = _c_fn()(
        ptr(q), ptr(k_pool), ptr(v_pool), ptr(pool_seg), ptr(pool_pos),
        ptr(q_seg), ptr(q_pos), ptr(block_tables), ptr(k_scale),
        ptr(v_scale), ptr(out), B, T, H, k_pool.shape[2], D,
        k_pool.shape[1], NB, build.query_tile(T, G, B * k_pool.shape[2],
                                              q.device),
        q_code, kv_code, 1.0 / math.sqrt(D), build.stream_of(q))
    build.raise_on(rc, NAME)
    build.LAUNCHES[NAME] += 1
    return out
