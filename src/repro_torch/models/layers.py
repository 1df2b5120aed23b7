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
                q_anc=None, kv_node=None):
    """Attention for one query block against full K/V.

    q: (B, Qb, Kh, G, D)   k, v: (B, Skv, Kh, D)
    q_pos: (B, Qb)  kv_pos: (B, Skv)  segs same shapes (or None)
    q_anc / kv_node (optional, same shapes as segs): tree topology term.
    """
    qf = q.float().permute(0, 2, 3, 1, 4)  # (B, Kh, G, Qb, D)
    kf = k.float().permute(0, 2, 3, 1)[:, :, None]  # (B, Kh, 1, D, S)
    s = torch.matmul(qf, kf) * scale  # (B, Kh, G, Qb, S)
    mask = kv_pos[:, None, :] <= q_pos[:, :, None]  # (B, Qb, S) causal
    if window:
        mask &= kv_pos[:, None, :] > (q_pos[:, :, None] - window)
    if q_seg is not None:
        mask &= q_seg[:, :, None] == kv_seg[:, None, :]
    if kv_node is not None:
        mask &= tree_term(q_anc[:, :, None], kv_node[:, None, :])
    s = torch.where(mask[:, None, None], s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    # rows with no valid key (padding query) -> all NEG_INF; keep finite
    m = torch.clamp(m, min=-1e29)
    p = torch.exp(s - m)
    denom = torch.sum(p, dim=-1, keepdim=True)
    p = p / torch.clamp(denom, min=1e-30)
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]  # (B, Kh, 1, S, D)
    o = torch.matmul(p, vf)  # (B, Kh, G, Qb, D)
    return o.permute(0, 3, 1, 2, 4).to(v.dtype)


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
    row is independent, so the blocking never changes a result.
    """
    B, Sq, Hq, D = q.shape
    Kh = k.shape[2]
    G = Hq // Kh
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, Kh, G, D)
    outs = []
    for lo in range(0, Sq, q_block):
        hi = min(Sq, lo + q_block)
        outs.append(_attn_block(
            qg[:, lo:hi], k, v, q_positions[:, lo:hi], kv_positions,
            None if q_segments is None else q_segments[:, lo:hi],
            kv_segments, window, scale,
            None if q_anc is None else q_anc[:, lo:hi], kv_node))
    o = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return o.reshape(B, Sq, Hq, D)


def swiglu(x, w_gate, w_up, w_down):
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def embed(tokens, table):
    return table[tokens.long()]
