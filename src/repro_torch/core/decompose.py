"""Fast batch verification via request decomposition (paper §V-A).

The packed grid is *flattened*: every verified request contributes its
query tokens to one ``(1, Tq)`` row, and tokens carry (request-segment,
absolute-position) metadata; attention is segment-restricted and
position-causal, which computes exactly Eq. (13) — the denominator sums
over all packed tokens of the same request and nothing else.

Under the paged layout the packed KV is the cohort's live blocks
(serving/paged.py), so only the query side needs a layout.  Under the dense
layout the planner below is the paper's L-search: fix the width bound B
(max rows), then pick the KV-grid length L minimizing padded cells; the
requests' cache rows are gathered into one flat packed buffer and
``make_attn_override`` attends it through ``kernels.ops.verify_attention``
(on the card, the CUDA kernel ``csrc/verify_attention.cu``), which skips
KV tiles whose segment range cannot meet the query tile.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import attention
from repro_torch.serving import trace

# Tree speculation encodes each query's root-to-node path as a bitmask in
# one int32, so the node budget per request is the mask width.
ANCESTOR_MASK_BITS = 32


def max_tree_nodes() -> int:
    """Largest per-request tree node count (= sum of (depth_j + 1) over
    branches) the ancestor-bitmask verify kernel can express."""
    return ANCESTOR_MASK_BITS


@dataclasses.dataclass
class PackPlan:
    L: int                     # KV grid row length
    rows: int                  # number of rows (paper's width B)
    gather_b: np.ndarray       # (rows*L,) source request per packed cell
    gather_s: np.ndarray       # (rows*L,) source cache slot per packed cell
    valid: np.ndarray          # (rows*L,) bool
    lengths: np.ndarray        # (N,) request KV lengths packed
    padded_cells: int          # rows*L - sum(lengths)
    baseline_cells: int        # n_requests * max(lengths)  (padded scheme)

    @property
    def total(self) -> int:
        return self.rows * self.L

    @property
    def saving(self) -> float:
        return 1.0 - self.total / max(self.baseline_cells, 1)


def _pack_for_L(lengths: Sequence[int], L: int):
    rows_per_req = [max(1, math.ceil(n / L)) for n in lengths]
    rows = sum(rows_per_req)
    padding = rows * L - sum(lengths)
    return rows, padding


def plan_decomposition(lengths: Sequence[int], *, max_rows: int = 0,
                       align: int = 128,
                       slot_fn: Optional[Callable[[int, int], int]] = None
                       ) -> PackPlan:
    """Search L (paper §V-A): minimize total padded cells subject to the
    row/width bound.  lengths: per-request KV token counts; ``max_rows``
    0 = 4 x the request count (no Q replication here, so the bound only
    sizes the grid)."""
    lengths = [int(n) for n in lengths]
    n = len(lengths)
    max_len = max(lengths)
    if max_rows <= 0:
        max_rows = 4 * n
    cands = []
    L = align
    while L <= max(align, int(math.ceil(max_len / align) * align)):
        rows, padding = _pack_for_L(lengths, L)
        if rows <= max_rows:
            cands.append((rows * L, rows, L, padding))
        L += align
    if not cands:                              # fall back: one row per req
        L = int(math.ceil(max_len / align) * align)
        rows, padding = _pack_for_L(lengths, L)
        cands.append((rows * L, rows, L, padding))
    total, rows, L, padding = min(cands)

    gather_b = np.zeros(rows * L, np.int32)
    gather_s = np.zeros(rows * L, np.int32)
    valid = np.zeros(rows * L, bool)
    cell = 0
    for i, length in enumerate(lengths):
        for p in range(length):
            gather_b[cell] = i
            gather_s[cell] = slot_fn(i, p) if slot_fn else p
            valid[cell] = True
            cell += 1
        # round the request up to a full row boundary (fragment padding)
        cell += (L - (length % L)) % L
    return PackPlan(L=L, rows=rows, gather_b=gather_b, gather_s=gather_s,
                    valid=valid, lengths=np.array(lengths, np.int64),
                    padded_cells=padding, baseline_cells=n * max_len)


def packed_gather(cache_entry: dict, gather_b, gather_s, valid):
    """Gather one layer's dense cache entry {k, v, pos, seg: (B, S, ...)}
    into the packed flattened view (1, P, ...).  Valid cells take segment =
    source request index, padding cells -1.  ``gather_b``/``gather_s`` are
    int64 index tensors; slots past S clamp to the last slot, as the
    reference's gather does."""
    gs = torch.clamp(gather_s, max=cache_entry["k"].shape[1] - 1)
    k = cache_entry["k"][gather_b, gs][None]
    v = cache_entry["v"][gather_b, gs][None]
    pos = cache_entry["pos"][gather_b, gs][None]
    src_seg = cache_entry["seg"][gather_b, gs]
    seg = torch.where(valid & (src_seg >= 0), gather_b, -1).to(
        torch.int32)[None]
    pos = torch.where(seg >= 0, pos, -1)
    return k, v, pos, seg


def _to_device(a, device) -> torch.Tensor:
    with trace.sync():
        return torch.as_tensor(a, device=device)


def make_attn_override(gather_b, gather_s, valid, q_rows):
    """Returns an attention override for ``transformer._attn_block`` that
    implements packed verification: attend q over [packed KV ; new KV] and
    write the new K/V into the dense cache, in place.  q_rows: (Tq,) source
    request per query token.  The numpy plan moves to the queries' device
    at the first layer; the in-range writes are computed there once and
    shared by every layer (the reference's scatter drops writes past the
    cache row).

    Attention: ``kernels.ops.verify_attention`` on the flattened views for
    full-attention layers; a layer with a window (the model-wide
    ``sliding_window`` or its entry of ``layer_windows``) keeps the
    reference's ``layers.attention(..., window=w)`` (that kernel has no
    window term)."""
    host = (np.asarray(gather_b, np.int64), np.asarray(gather_s, np.int64),
            np.asarray(valid, bool), np.asarray(q_rows, np.int64))
    dev = {}

    def override(q, k_new, v_new, positions, segments, kv_cache, cfg, opts,
                 window=0):
        # q, k_new, v_new: (1, Tq, H/Kh, hd); positions/segments: (1, Tq)
        if "plan" not in dev:
            gb, gs, ok, qr = (_to_device(a, q.device) for a in host)
            wpos = positions[0].long()
            with trace.sync():
                inside = torch.nonzero(
                    (wpos >= 0) & (wpos < kv_cache["k"].shape[1]))[:, 0]
            dev["plan"] = (gb, gs, ok, qr[inside], wpos[inside], inside)
        gb, gs, ok, rows, slots, src = dev["plan"]
        pk, pv, ppos, pseg = packed_gather(kv_cache, gb, gs, ok)
        kk = torch.cat([pk, k_new], dim=1)
        vv = torch.cat([pv, v_new], dim=1)
        kpos = torch.cat([ppos, positions], dim=1)
        kseg = torch.cat([pseg, segments], dim=1)
        if window:
            o = attention(q, kk, vv, q_positions=positions, kv_positions=kpos,
                          q_segments=segments, kv_segments=kseg,
                          window=window, q_block=opts.q_block)
        else:
            o = ops.verify_attention(q[0], kk[0], vv[0], segments[0],
                                     positions[0], kseg[0], kpos[0])[None]
        # write the new K/V back into the dense cache rows
        kv_cache["k"][rows, slots] = k_new[0, src].to(kv_cache["k"].dtype)
        kv_cache["v"][rows, slots] = v_new[0, src].to(kv_cache["v"].dtype)
        kv_cache["pos"][rows, slots] = positions[0, src]
        kv_cache["seg"][rows, slots] = 0
        return o, kv_cache

    return override


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


def padding_stats(lengths: Sequence[int], plan: PackPlan) -> dict:
    return {
        "packed_cells": plan.total,
        "padded_cells": plan.baseline_cells,
        "saving_frac": plan.saving,
        "L": plan.L,
        "rows": plan.rows,
    }
