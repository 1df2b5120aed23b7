"""Plain-PyTorch versions of the attention kernels: direct (gather-then-)
attend formulations of the functions the CUDA kernels compute.  The
wrappers run them for CPU tensors; the tests and ``chip_smoke.py`` hold the
kernels against them on the card.  Every one keeps the Pallas kernels'
conventions: masked scores -1e30, ``m_safe = max(m, -1e29)``, zeros for a
query with no valid key."""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import quant

NEG = -1e30


def _maybe_dequant(pool, scale, idx):
    """Gather pool blocks by ``idx``; dequantize against the same-indexed
    scale sidecar when one is provided."""
    g = pool[idx]
    if scale is None:
        return g
    return quant.dequantize(g, scale[idx])


def tree_mask_term(q_anc, kv_node):
    """Topology-aware tree-speculation mask term.

    ``q_anc``: per-query int32 ancestor bitmask (bit ``n`` set iff tree
    node ``n`` is on the query's root-to-node path; -1 for non-tree
    queries).  ``kv_node``: per-KV-slot int32 node tag — -1 committed
    (always attendable), -2 dead (never), ``n >= 0`` attendable only along
    the query's path.  Shapes broadcast."""
    on_path = (torch.bitwise_right_shift(q_anc, kv_node.clamp(0, 31)) & 1) == 1
    return torch.where(kv_node == -1, True,
                       torch.where(kv_node < -1, False, on_path))


def verify_attention_ref(q, k, v, q_seg, q_pos, kv_seg, kv_pos,
                         q_anc=None, kv_node=None, window: int = 0):
    """SPIN packed verification attention — direct Eq. (13).

    q: (Tq, H, D); k, v: (Tkv, Kh, D); segs/pos: int32 1-D.  Causal
    masking ``kv_pos <= q_pos``, empty slots ``seg == -1``; optional tree
    term; ``window`` > 0 masks ``kv_pos <= q_pos - window`` too.  Rows
    with no valid key give zeros."""
    Tq, H, Dh = q.shape
    Kh = k.shape[1]
    G = H // Kh
    qf = q.float().reshape(Tq, Kh, G, Dh)
    s = torch.einsum("qkgd,skd->qkgs", qf, k.float()) / math.sqrt(Dh)
    mask = ((q_seg[:, None] == kv_seg[None, :]) & (kv_seg[None, :] >= 0)
            & (kv_pos[None, :] <= q_pos[:, None]))
    if window:
        mask &= kv_pos[None, :] > q_pos[:, None] - window
    if kv_node is not None:
        mask &= tree_mask_term(q_anc[:, None], kv_node[None, :])
    s = torch.where(mask[:, None, None, :], s, NEG)
    m = torch.clamp(torch.amax(s, dim=-1, keepdim=True), min=-1e29)
    p = torch.exp(s - m)
    p = p / torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("qkgs,skd->qkgd", p, v.float())
    o = torch.where(mask.any(-1)[:, None, None, None], o, 0.0)
    return o.reshape(Tq, H, Dh).to(q.dtype)


def paged_verify_ref(q, k_pool, v_pool, pool_seg, pool_pos, q_seg, q_pos,
                     block_ids, block_owner, q_anc=None, block_node=None,
                     k_scale=None, v_scale=None, window: int = 0):
    """Gather the live blocks into a flat packed view, then Eq. (13).
    ``block_node`` (M, bs) carries per-slot tree-node tags aligned with
    ``block_ids``; optional (N, bs, Kh) scale sidecars dequantize."""
    ids = torch.clamp(block_ids.long(), min=0)
    bs = k_pool.shape[1]
    k = _maybe_dequant(k_pool, k_scale, ids).reshape(-1, *k_pool.shape[2:])
    v = _maybe_dequant(v_pool, v_scale, ids).reshape(-1, *v_pool.shape[2:])
    slot_seg = pool_seg[ids].reshape(-1)
    kv_pos = pool_pos[ids].reshape(-1)
    owner = torch.repeat_interleave(block_owner, bs)
    kv_seg = torch.where((slot_seg >= 0) & (owner >= 0), owner, -1)
    kv_node = None if block_node is None else block_node.reshape(-1)
    return verify_attention_ref(q, k, v, q_seg, q_pos, kv_seg, kv_pos,
                                q_anc, kv_node, window)


def paged_seq_decode_ref(q, k_pool, v_pool, pool_seg, pool_pos, q_seg, q_pos,
                         block_tables, k_scale=None, v_scale=None,
                         window: int = 0):
    """Gather each row's block list dense, then segment/position-masked
    attention (``window`` > 0: slots at or before q_pos - window masked
    too).  q: (B, T, H, D); block_tables: (B, NB), -1 = unallocated;
    q_seg -1 = padding query (zero output)."""
    B, T, H, Dh = q.shape
    bs, Kh = k_pool.shape[1], k_pool.shape[2]
    G = H // Kh
    g = torch.clamp(block_tables.long(), min=0)
    k = _maybe_dequant(k_pool, k_scale, g).reshape(B, -1, Kh, Dh).float()
    v = _maybe_dequant(v_pool, v_scale, g).reshape(B, -1, Kh, Dh).float()
    seg = pool_seg[g].reshape(B, -1)
    kv_pos = pool_pos[g].reshape(B, -1)
    live = torch.repeat_interleave(block_tables >= 0, bs, dim=1)
    kv_seg = torch.where(live & (seg >= 0), seg, -1)
    qf = q.float().reshape(B, T, Kh, G, Dh)
    s = torch.einsum("btkgd,bskd->btkgs", qf, k) / math.sqrt(Dh)
    mask = ((q_seg[:, :, None] == kv_seg[:, None, :])
            & (kv_seg[:, None, :] >= 0)
            & (kv_pos[:, None, :] <= q_pos[:, :, None]))
    if window:
        mask &= kv_pos[:, None, :] > q_pos[:, :, None] - window
    s = torch.where(mask[:, :, None, None, :], s, NEG)
    m = torch.clamp(torch.amax(s, dim=-1, keepdim=True), min=-1e29)
    p = torch.where(mask[:, :, None, None, :], torch.exp(s - m), 0.0)
    denom = torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("btkgs,bskd->btkgd", p / denom, v)
    o = torch.where(mask.any(-1)[:, :, None, None, None], o, 0.0)
    return o.reshape(B, T, H, Dh).to(q.dtype)


def decode_attention_ref(q, k, v, lengths):
    """Dense GQA decode: one query per row against the row's cache, slots
    at or past ``lengths[b]`` masked; a row of length 0 gives zeros (the
    kernel's ``l = 0`` case).  q: (B, H, D); k, v: (B, S, Kh, D); lengths:
    (B,) int32."""
    B, H, Dh = q.shape
    S, Kh = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, Kh, H // Kh, Dh)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k.float()) / math.sqrt(Dh)
    mask = (torch.arange(S, device=q.device)[None, :]
            < lengths.to(q.device)[:, None])                      # (B, S)
    s = torch.where(mask[:, None, None, :], s, NEG)
    m = torch.clamp(torch.amax(s, dim=-1, keepdim=True), min=-1e29)
    p = torch.where(mask[:, None, None, :], torch.exp(s - m), 0.0)
    p = p / torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    o = torch.where(mask.any(-1)[:, None, None, None], o, 0.0)
    return o.reshape(B, H, Dh).to(q.dtype)


def paged_decode_attention_ref(q, k_pool, v_pool, block_tables, lengths,
                               k_scale=None, v_scale=None):
    """Gather each row's blocks (entries < 0 read block 0, as the
    reference's index map does) into a dense view, dequantize, then
    :func:`decode_attention_ref`.  q: (B, H, D); pools: (N, bs, Kh, D);
    block_tables: (B, NB); lengths: (B,)."""
    B = q.shape[0]
    g = torch.clamp(block_tables.long(), min=0)
    k = _maybe_dequant(k_pool, k_scale, g).reshape(B, -1, *k_pool.shape[2:])
    v = _maybe_dequant(v_pool, v_scale, g).reshape(B, -1, *v_pool.shape[2:])
    return decode_attention_ref(q, k, v, lengths)


def mha_ref(q, k, v, *, causal=True, window=0):
    """Plain (optionally sliding-window) causal attention, GQA: the whole
    (S, S) score matrix, masked at -1e30, float32 softmax.  q: (B, S, H,
    D); k, v: (B, S, Kh, D).  Returns q's dtype."""
    B, S, H, Dh = q.shape
    Kh = k.shape[2]
    qf = q.float().reshape(B, S, Kh, H // Kh, Dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) / math.sqrt(Dh)
    i = torch.arange(S, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= i[None, :] <= i[:, None]
    if window:
        mask &= i[None, :] > (i[:, None] - window)
    p = torch.softmax(torch.where(mask, s, NEG), dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, S, H, Dh).to(q.dtype)
