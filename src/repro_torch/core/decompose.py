"""Packed-verification query layouts (paper §V-A).

The packed grid is *flattened*: every verified request contributes its
query tokens to one ``(1, Tq)`` row, and tokens carry (request-segment,
absolute-position) metadata; attention is segment-restricted and
position-causal, which computes exactly Eq. (13) — the denominator sums
over all packed tokens of the same request and nothing else.  Under the
paged layout the packed KV is the cohort's live blocks (serving/paged.py),
so only the query side needs a layout; the dense planner
(``plan_decomposition``/``make_attn_override``) waits in ROADMAP Queue 1
with the dense pool.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

# Tree speculation encodes each query's root-to-node path as a bitmask in
# one int32, so the node budget per request is the mask width.
ANCESTOR_MASK_BITS = 32


def max_tree_nodes() -> int:
    """Largest per-request tree node count (= sum of (depth_j + 1) over
    branches) the ancestor-bitmask verify kernel can express."""
    return ANCESTOR_MASK_BITS


def build_query_layout(lengths: Sequence[int], gamma):
    """Query tokens for verification: gamma_i+1 per request, positions
    lengths[i]..lengths[i]+gamma_i, segment = request index.  ``gamma`` is
    a scalar or a per-request sequence of draft depths.
    Returns (q_rows (Tq,), q_positions (1,Tq), q_segments (1,Tq))."""
    n = len(lengths)
    if np.ndim(gamma) == 0:
        gam = np.full(n, int(gamma), np.int32)
    else:
        gam = np.asarray(gamma, np.int32)
        if len(gam) != n:
            raise ValueError(
                f"per-request gamma has {len(gam)} entries for {n} requests")
    q_rows = np.repeat(np.arange(n, dtype=np.int32), gam + 1)
    offs = np.concatenate(
        [np.arange(g + 1, dtype=np.int32) for g in gam]) if n else \
        np.zeros(0, np.int32)
    q_pos = (np.asarray(lengths, np.int32)[q_rows] + offs)[None]
    q_seg = q_rows[None].astype(np.int32)
    return q_rows, q_pos, q_seg


def build_tree_row_layout(lengths: Sequence[int], W: int, tree_rows: dict):
    """Row-major tree-verify query layout over a full pool.

    Every pool row contributes ``W + 1`` queries at positions
    ``lengths[r] .. lengths[r] + W``.  ``tree_rows`` maps pool row ->
    ``(seg_row, offset, k)`` for rows that carry a tree branch: their
    queries take segment ``seg_row`` (the request's main row, so forked rows
    attend the shared prefix) and ancestor bitmask
    ``((1 << (min(d, k) + 1)) - 1) << offset``.  Rows absent from
    ``tree_rows`` get anc = -1 ("attend any node"), the linear semantics.

    Returns (q_rows (Tq,), q_pos (1, Tq), q_seg (1, Tq), q_anc (Tq,))."""
    n = len(lengths)
    q_rows = np.repeat(np.arange(n, dtype=np.int32), W + 1)
    d = np.tile(np.arange(W + 1, dtype=np.int32), n)
    q_pos = (np.asarray(lengths, np.int32)[q_rows] + d)[None]
    seg = np.arange(n, dtype=np.int64)
    anc = np.full((n, W + 1), -1, np.int64)
    dd = np.arange(W + 1, dtype=np.int64)
    for row, (seg_row, off, k) in tree_rows.items():
        seg[row] = seg_row
        anc[row] = ((1 << (np.minimum(dd, int(k)) + 1)) - 1) << int(off)
    q_seg = seg.astype(np.int32)[q_rows][None]
    q_anc = anc.astype(np.uint32).astype(np.int32).reshape(-1)
    return q_rows, q_pos, q_seg, q_anc


def split_tree_depths(k: int, branches: int) -> list:
    """Split a granted node budget ``k`` into per-branch draft depths:
    branch 0 (the main greedy chain) gets the deepest share, extra branches
    the remainder round-robin; ``branches`` is capped at ``k``."""
    b = max(1, min(int(branches), int(k)))
    base, rem = divmod(int(k), b)
    return [base + (1 if j < rem else 0) for j in range(b)]
