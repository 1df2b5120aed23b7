"""Fused paged verification: SPIN's packed Eq. (13) pass streaming K/V
straight from the paged block pool, one launch per attention layer.

``fused_paged_verify`` is the wrapper.  On a CPU tensor it runs the plain
version (:func:`fused_paged_verify_plain`: gather the live blocks into a
flat packed view, then direct masked attention).  On a CUDA tensor it
launches the hand-written kernel ``csrc/fused_verify.cu`` or raises; there
is no fallback on the card.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, ref

NAME = "fused_paged_verify"

# The plain version: gather the live blocks, then direct Eq. (13) attention.
fused_paged_verify_plain = ref.paged_verify_ref


def _c_fn():
    fn = build.load("fused_verify").spin_fused_paged_verify
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 14 + [i] * 9 + [ctypes.c_float, p]
    fn.restype = i
    return fn


def fused_paged_verify(q, k_pool, v_pool, pool_seg, pool_pos, q_seg, q_pos,
                       block_ids, block_owner, q_anc=None, block_node=None,
                       k_scale=None, v_scale=None):
    """Single-launch packed verification.

    q: (Tq, H, D); pools: (N, bs, Kh, D); pool_seg/pool_pos: (N, bs);
    q_seg/q_pos: (Tq,); block_ids/block_owner: (M,) live physical blocks and
    the segment owning each (-1 = padding entry, never read); optional tree
    topology q_anc (Tq,) / block_node (M, bs), indexed by gathered entry m;
    optional (N, bs, Kh) float32 scales for int8/fp8 pools.  Returns
    (Tq, H, D) in q's dtype."""
    if q.device.type == "cpu":
        return fused_paged_verify_plain(
            q, k_pool, v_pool, pool_seg, pool_pos, q_seg, q_pos, block_ids,
            block_owner, q_anc, block_node, k_scale, v_scale)
    if (q_anc is None) != (block_node is None):
        raise ValueError("q_anc and block_node come together")
    Tq, H, D = q.shape
    bs = k_pool.shape[1]
    M = block_ids.shape[0]
    q_code, kv_code = build.check_pools(q, k_pool, v_pool, pool_seg,
                                        pool_pos, k_scale, v_scale)
    for name, t, shape in (("q_seg", q_seg, (Tq,)), ("q_pos", q_pos, (Tq,)),
                           ("q_anc", q_anc, (Tq,)),
                           ("block_ids", block_ids, (M,)),
                           ("block_owner", block_owner, (M,)),
                           ("block_node", block_node, (M, bs))):
        build.check_int(name, t, shape, q.device)
    out = torch.empty_like(q)
    G = H // k_pool.shape[2]
    ptr = build.ptr
    rc = _c_fn()(
        ptr(q), ptr(k_pool), ptr(v_pool), ptr(pool_seg), ptr(pool_pos),
        ptr(q_seg), ptr(q_pos), ptr(q_anc), ptr(block_ids),
        ptr(block_owner), ptr(block_node), ptr(k_scale), ptr(v_scale),
        ptr(out), Tq, H, k_pool.shape[2], D, bs, M,
        build.query_tile(Tq, G, k_pool.shape[2], q.device), q_code, kv_code,
        1.0 / math.sqrt(D),
        build.stream_of(q))
    build.raise_on(rc, NAME)
    build.LAUNCHES[NAME] += 1
    return out
