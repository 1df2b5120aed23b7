"""Core layers: RMSNorm, RoPE, chunked masked attention, SwiGLU MLP.

The attention here is the plain-PyTorch path used by prefill, dense decode
and the unfused paged path.  It is chunked over query blocks so no
``(S x S)`` score tensor larger than one block is materialized.  The CUDA
kernels in ``repro_torch.kernels`` compute the same math on the card and are
held against ``repro_torch.kernels.ref``, which mirrors this module.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (all_reduce_over, constrain,
                                              is_dtensor, on_shards,
                                              row_gather)

NEG_INF = -1e30


def rms_norm(x, weight, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * (1.0 + weight.float())).to(dt)


def rope(x, positions, theta: float = 10000.0):
    """Rotary embeddings (half-split rotation). x: (B, S, H, D);
    positions: (B, S)."""
    d = x.shape[-1]
    assert d % 2 == 0, f"RoPE needs even head_dim, got {d}"
    half = d // 2
    idx = torch.arange(0, half, dtype=torch.float32, device=x.device)
    freq = 1.0 / (theta ** (idx / half))
    ang = positions[:, :, None, None].float() * freq  # (B, S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def tree_term(q_anc, kv_node):
    """Tree-speculation topology mask term; shapes broadcast.  ``kv_node``
    -1 = committed (always attendable), < -1 = dead (never), n >= 0 =
    attendable iff bit n of the query's ancestor mask ``q_anc`` is set."""
    bit = torch.bitwise_right_shift(q_anc, kv_node.clamp(0, 31)) & 1
    return torch.where(
        kv_node == -1,
        torch.ones_like(bit, dtype=torch.bool),
        (kv_node >= 0) & (bit == 1),
    )


def _attn_block(q, k, v, q_pos, kv_pos, q_seg, kv_seg, window, scale,
                q_anc=None, kv_node=None, kv_split=None):
    """Attention for one query block against full K/V.

    q: (B, Qb, Kh, G, D)   k, v: (B, Skv, Kh, D)
    q_pos: (B, Qb)  kv_pos: (B, Skv)  segs same shapes (or None)
    q_anc / kv_node (optional, same shapes as segs): tree topology term.
    kv_split (mesh, mesh dims): K/V hold this device's shard of the
    sequence; the softmax's max and sum and the output are reduced over
    those mesh dims.
    """
    qf = q.float().permute(0, 2, 3, 1, 4)  # (B, Kh, G, Qb, D)
    kf = k.float().permute(0, 2, 3, 1)[:, :, None]  # (B, Kh, 1, D, S)
    s = torch.matmul(qf, kf) * scale  # (B, Kh, G, Qb, S)
    mask = kv_pos[:, None, :] <= q_pos[:, :, None]  # (B, Qb, S) causal
    if window:
        mask = mask & (kv_pos[:, None, :] > (q_pos[:, :, None] - window))
    if q_seg is not None:
        mask = mask & (q_seg[:, :, None] == kv_seg[:, None, :])
    if kv_node is not None:
        mask = mask & tree_term(q_anc[:, :, None], kv_node[:, None, :])
    s = torch.where(mask[:, None, None], s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    if kv_split:
        m = all_reduce_over(m, "max", *kv_split)
    # rows with no valid key (padding query) -> all NEG_INF; keep finite
    m = torch.clamp(m, min=-1e29)
    p = torch.exp(s - m)
    denom = torch.sum(p, dim=-1, keepdim=True)
    if kv_split:
        denom = all_reduce_over(denom, "sum", *kv_split)
    p = p / torch.clamp(denom, min=1e-30)
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]  # (B, Kh, 1, S, D)
    o = torch.matmul(p, vf)  # (B, Kh, G, Qb, D)
    if kv_split:
        o = all_reduce_over(o, "sum", *kv_split)
    return o.permute(0, 3, 1, 2, 4).to(v.dtype)


def _attn_block_sharded(q, k, v, q_pos, kv_pos, q_seg, kv_seg, window,
                        scale, q_anc=None, kv_node=None):
    """:func:`_attn_block` over DTensors laid out by a rule table, q (B,
    Qb, H, D) with its heads unsplit into groups: each device attends its
    shards.  K's layout (batch, and kv heads or the cache sequence) sets
    the queries', positions', segments' and tree terms'.  Where K's kv
    heads stay whole on a mesh dim (kv heads fewer than the dim, or not
    dividing it), each device takes its share of the query heads and the
    kv heads they read, as the reference's partitioner splits the heads:
    whole groups, or whole heads of one group, where the heads split
    evenly; else the heads padded up to a multiple of the dim, each
    device reading the kv head of each of its query heads and the padded
    heads' outputs dropped.  Where K's sequence is split, each device
    scores its slots and the softmax is merged over the split (the max,
    the sum and the output all-reduced, as the reference's partitioner
    reduces a softmax over a sharded dim); K/V are never gathered."""
    from torch.distributed.tensor import Replicate, Shard
    mesh, kp = k.device_mesh, tuple(k.placements)
    if tuple(v.placements) != kp or any(
            not (p.is_replicate() or type(p) is Shard and p.dim < 3)
            for p in kp):
        raise ValueError(f"attention over K laid out as {kp} and V as "
                         f"{tuple(v.placements)}: K and V must be split "
                         f"alike, on batch, sequence or kv heads only")
    H, Kh = q.shape[2], k.shape[2]
    G = H // Kh
    qp = [p if p in (Shard(0), Shard(2)) else Replicate() for p in kp]
    # one mesh dim splits the query heads where K's heads stay whole: each
    # device's heads read one kv head, or whole groups; else (padded) the
    # device picks its heads out of the replicated queries
    head_split, padded, Hp = None, False, H
    if Shard(2) not in kp:
        for m, p in enumerate(kp):
            n = mesh.size(m)
            if p.is_replicate() and n > 1:
                head_split = m
                padded = H % n != 0 or not (G % (H // n) == 0
                                            or (H // n) % G == 0)
                Hp = -(-H // n) * n
                if not padded:
                    qp[m] = Shard(2)
                break
    qp = tuple(qp)
    op = tuple(Shard(2) if m == head_split else p for m, p in enumerate(qp))
    q_row = tuple(Shard(0) if p == Shard(0) else Replicate() for p in kp)
    kv_row = tuple(p if p in (Shard(0), Shard(1)) else Replicate()
                   for p in kp)
    split = [m for m, p in enumerate(kp) if p == Shard(1)]

    def core(q, k, v, q_pos, kv_pos, q_seg, kv_seg, q_anc, kv_node):
        B, Qb, Hl, D = q.shape
        if padded:
            # this device's heads of the padded Hp, each with its kv head
            Hl = Hp // mesh.size(head_split)
            first = mesh.get_coordinate()[head_split] * Hl
            heads = torch.arange(first, first + Hl, device=q.device)
            q = q[:, :, heads.clamp(max=H - 1)]
            k, v = (t[:, :, heads.clamp(max=H - 1) // G] for t in (k, v))
        elif head_split is not None:
            n_kv = max(1, Hl // G)
            first = mesh.get_coordinate()[head_split] * Hl // G
            k, v = (t[:, :, first:first + n_kv] for t in (k, v))
        n_kv = k.shape[2]
        o = _attn_block(q.reshape(B, Qb, n_kv, Hl // n_kv, D), k, v, q_pos,
                        kv_pos, q_seg, kv_seg, window, scale, q_anc,
                        kv_node, kv_split=(mesh, split) if split else None)
        return o.reshape(B, Qb, Hl, D)

    o = on_shards(core, mesh,
                  (q, k, v, q_pos, kv_pos, q_seg, kv_seg, q_anc, kv_node),
                  (qp, kp, kp, q_row, kv_row, q_row, kv_row, q_row, kv_row),
                  op)
    return o[:, :, :H] if Hp != H else o


def attention(q, k, v, *, q_positions, kv_positions, q_segments=None,
              kv_segments=None, q_anc=None, kv_node=None, window: int = 0,
              q_block: int = 512):
    """GQA masked attention.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Kh, D).  Hq % Kh == 0.  Positions are
    absolute token indices (causality = kv_pos <= q_pos).  Segments
    (optional) restrict attention to equal segment ids — SPIN Eq. (13): the
    softmax denominator sums over all packed tokens of the same request and
    nothing else.  q_anc / kv_node (optional) add the tree-speculation
    topology term.  Queries are processed ``q_block`` at a time; each query
    row is independent, so the blocking never changes a result.  DTensors
    (a rule table's layouts) go through :func:`_attn_block_sharded`, the
    query heads laid out as the table lays out heads.
    """
    B, Sq, Hq, D = q.shape
    Kh = k.shape[2]
    G = Hq // Kh
    scale = 1.0 / math.sqrt(D)
    sharded = is_dtensor(k)
    if sharded:
        q = constrain(q, "batch", "seq", "heads")
    else:
        q = q.reshape(B, Sq, Kh, G, D)
    block = _attn_block_sharded if sharded else _attn_block
    outs = []
    for lo in range(0, Sq, q_block):
        hi = min(Sq, lo + q_block)
        outs.append(block(
            q[:, lo:hi], k, v, q_positions[:, lo:hi], kv_positions,
            None if q_segments is None else q_segments[:, lo:hi],
            kv_segments, window, scale,
            None if q_anc is None else q_anc[:, lo:hi], kv_node))
    o = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    if sharded:
        # laid out as the queries were (and so is its gradient)
        return constrain(o, "batch", "seq", "heads")
    return o.reshape(B, Sq, Hq, D)


def swiglu(x, w_gate, w_up, w_down):
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def embed(tokens, table):
    # an embedding op, not indexing; a table laid out over a mesh (its
    # vocab split over model) is looked up shard by shard
    if is_dtensor(table):
        return row_gather(table, tokens)
    return F.embedding(tokens.long(), table)


def softmax_cross_entropy(logits, labels, mask=None, vocab_size: int = 0):
    """Mean cross-entropy over the valid positions (``mask``; all when
    None), in float32.  Logits past ``vocab_size`` (vocab padding) are
    pushed to ``NEG_INF`` before the log-sum-exp."""
    logits = logits.float()
    if vocab_size and logits.shape[-1] > vocab_size:
        pad = torch.zeros(logits.shape[-1], dtype=torch.float32,
                          device=logits.device)
        pad[vocab_size:] = NEG_INF
        logits = logits + pad
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())
    nll = (logz[..., None] - ll)[..., 0]
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
