"""Paged-KV attention plumbing for the serving engine.

The paged pool stores each model's KV in a block pool ``(L, num_blocks,
block_size, Kh, D)``; requests own ordered lists of physical blocks (block
tables).  The model forward never sees a dense ``(rows, max_len)`` grid: the
override closures below route every attention layer through the block
table —

* **write**: new K/V is scattered straight into the owning request's tail
  block(s) (``flat = table[row, pos // bs] * bs + pos % bs``), in place.
  Rows without an allocated block (idle pool rows, padding) have no valid
  slot; the reference's scatter drops such updates, here they are filtered
  out before the write (once per forward, shared by every layer);
* **read**: two formulations.  The gather overrides (``--fused-kernels
  off``) gather the live blocks into a dense view and run
  ``layers.attention``; the fused overrides (``on``) hand the pool and the
  block tables to one ``kernels.ops`` call per layer, which on the card is
  the CUDA kernel streaming K/V straight from the pool.

Invariants (owned by ``serving/pool.py``): a KV slot is readable only when
its block is in a live table AND its ``seg >= 0``; before decode/verify
writes land, each participating row's table covers the speculation window;
rollback scrubs rejected slots.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import ops, quant
from repro_torch.models import config as C
from repro_torch.models import transformer as T
from repro_torch.models.layers import attention


def pool_dims(cache) -> Tuple[int, int]:
    """(num_blocks, block_size) of a paged cache dict."""
    return cache["k"].shape[1], cache["k"].shape[2]


def _flat_write_idx(block_tables, positions, bs: int):
    """Flat pool slot per (row, position); -1 where unmapped (idle row /
    position beyond the row's allocated blocks)."""
    nb = block_tables.shape[1]
    lb = torch.div(positions, bs, rounding_mode="floor")
    phys = torch.gather(block_tables, 1, lb.clamp(0, nb - 1).long())
    ok = (positions >= 0) & (lb < nb) & (phys >= 0)
    return torch.where(ok, phys * bs + positions % bs, -1)


class _Writes:
    """The in-range writes of one forward: destination flat slots and the
    source token indices.  Computed at the first layer (one host sync per
    forward, for the nonzero) and reused by the others."""

    def __init__(self, make_flat_idx):
        self._make = make_flat_idx
        self.dst = self.src = None

    def get(self, positions):
        if self.dst is None:
            flat = self._make(positions).reshape(-1)
            self.src = torch.nonzero(flat >= 0).squeeze(1)
            self.dst = flat[self.src].long()
        return self.dst, self.src


def _write_kv(kv, dst, src, k_new, v_new, positions, segments):
    """Write new K/V (+pos/seg) into the layer's pool views in place.
    Quantized pools (``k_scale``/``v_scale`` present) quantize each new
    token's K/V per (slot, head) on the way in."""
    N, bs, Kh, hd = kv["k"].shape
    for leaf, new in (("k", k_new), ("v", v_new)):
        x = new.reshape(-1, Kh, hd)[src]
        pool = kv[leaf].view(N * bs, Kh, hd)
        if leaf + "_scale" in kv:
            x, scale = quant.quantize(x, pool.dtype)
            kv[leaf + "_scale"].view(N * bs, Kh)[dst] = scale
        pool[dst] = x.to(pool.dtype)
    kv["pos"].view(-1)[dst] = positions.reshape(-1)[src].to(torch.int32)
    kv["seg"].view(-1)[dst] = segments.reshape(-1)[src].to(torch.int32)


def _gather_dequant(kv, leaf, slot, dtype):
    """Gather pool slots ``slot`` of ``leaf`` ('k'/'v'); a quantized pool
    is dequantized after the gather."""
    N, bs, Kh, hd = kv[leaf].shape
    g = kv[leaf].view(N * bs, Kh, hd)[slot]
    if leaf + "_scale" not in kv:
        return g
    sc = kv[leaf + "_scale"].view(N * bs, Kh)[slot]
    return quant.dequantize(g, sc, dtype)


def _decode_writes(block_tables, bs):
    return _Writes(lambda pos: _flat_write_idx(block_tables, pos, bs))


def make_paged_decode_override(block_tables, bs: int):
    """Attention override for decode/draft/verify-padded over a paged pool.
    block_tables: (B, nb_max) int32, -1 = unallocated.  Queries of row b
    attend the gathered view of row b's blocks (write-then-read, so the new
    tokens attend each other causally like the dense path)."""
    bt = block_tables.to(torch.int32)
    writes = _decode_writes(bt, bs)

    def override(q, k_new, v_new, positions, segments, kv, cfg, opts):
        B = positions.shape[0]
        dst, src = writes.get(positions)
        _write_kv(kv, dst, src, k_new, v_new, positions, segments)
        nb_max = bt.shape[1]
        ar = torch.arange(bs, device=bt.device)
        slot = ((bt.clamp(min=0).long() * bs)[:, :, None] + ar)
        slot = slot.reshape(B, nb_max * bs)
        kg = _gather_dequant(kv, "k", slot, k_new.dtype)
        vg = _gather_dequant(kv, "v", slot, v_new.dtype)
        posg = kv["pos"].view(-1)[slot]
        live = torch.repeat_interleave(bt >= 0, bs, dim=1)
        segg = torch.where(live, kv["seg"].view(-1)[slot], -1)
        o = attention(q, kg, vg, q_positions=positions, kv_positions=posg,
                      q_segments=segments, kv_segments=segg,
                      window=cfg.sliding_window, q_block=opts.q_block)
        return o, kv

    return override


def make_fused_decode_override(block_tables, bs: int, fused_cfg):
    """Fused variant of :func:`make_paged_decode_override`: the write is
    unchanged, the read is ONE ``ops.fused_paged_decode`` call streaming
    the rows' blocks straight from the pool."""
    bt = block_tables.to(torch.int32).contiguous()
    writes = _decode_writes(bt, bs)

    def override(q, k_new, v_new, positions, segments, kv, cfg, opts):
        dst, src = writes.get(positions)
        _write_kv(kv, dst, src, k_new, v_new, positions, segments)
        o = ops.fused_paged_decode(
            q.contiguous(), kv["k"], kv["v"], kv["seg"], kv["pos"],
            segments.to(torch.int32).contiguous(),
            positions.to(torch.int32).contiguous(), bt,
            k_scale=kv.get("k_scale"), v_scale=kv.get("v_scale"),
            config=fused_cfg)
        return o.to(q.dtype), kv

    return override


def _verify_writes(q_rows, block_tables, bs):
    def flat(positions):
        pos = positions[0]
        nb = block_tables.shape[1]
        lb = torch.div(pos, bs, rounding_mode="floor")
        phys = block_tables[q_rows.long(), lb.clamp(0, nb - 1).long()]
        ok = (pos >= 0) & (lb < nb) & (phys >= 0)
        return torch.where(ok, phys * bs + pos % bs, -1)
    return _Writes(flat)


def make_paged_verify_override(q_rows, block_tables, block_ids, block_owner,
                               bs: int, q_anc=None, block_node=None):
    """Attention override for SPIN packed verification over a paged pool.

    q_rows: (Tq,) pool row per flattened query token; block_ids /
    block_owner: (M,) live physical blocks of the verified cohort and the
    segment owning each (-1 owner = padding entry).  Optional tree topology:
    ``q_anc`` (Tq,) per-query ancestor bitmask and ``block_node`` (M, bs)
    per-slot tree-node tags; omitted reduces to the linear Eq. 13 mask."""
    bt = block_tables.to(torch.int32)
    writes = _verify_writes(q_rows, bt, bs)
    ids = block_ids.long().clamp(min=0)
    owner = block_owner.to(torch.int32)
    M = ids.shape[0]
    anc = None if q_anc is None else q_anc.to(torch.int32).reshape(1, -1)
    node = (None if block_node is None
            else block_node.to(torch.int32).reshape(1, M * bs))

    def override(q, k_new, v_new, positions, segments, kv, cfg, opts):
        # q/k_new/v_new: (1, Tq, ., hd); positions/segments: (1, Tq) with
        # segments = owning row (Eq. 13 segment ids); pool slots store
        # seg = 0 (valid), mirroring the dense cache
        dst, src = writes.get(positions)
        _write_kv(kv, dst, src, k_new, v_new, positions,
                  torch.zeros_like(segments))
        ar = torch.arange(bs, device=ids.device)
        slot = ((ids * bs)[:, None] + ar).reshape(M * bs)
        kg = _gather_dequant(kv, "k", slot, k_new.dtype)[None]
        vg = _gather_dequant(kv, "v", slot, v_new.dtype)[None]
        posg = kv["pos"].view(-1)[slot][None]
        own = torch.repeat_interleave(owner, bs)
        segg = torch.where((kv["seg"].view(-1)[slot] >= 0) & (own >= 0),
                           own, -1)[None]
        o = attention(q, kg, vg, q_positions=positions, kv_positions=posg,
                      q_segments=segments, kv_segments=segg,
                      window=cfg.sliding_window, q_block=opts.q_block,
                      q_anc=anc, kv_node=node)
        return o, kv

    return override


def make_fused_verify_override(q_rows, block_tables, block_ids, block_owner,
                               bs: int, q_anc=None, block_node=None,
                               fused_cfg=None):
    """Fused variant of :func:`make_paged_verify_override`: one
    ``ops.fused_paged_verify`` call replaces the fragment gather + packed
    attention pair, for linear and tree shapes alike."""
    bt = block_tables.to(torch.int32)
    writes = _verify_writes(q_rows, bt, bs)
    ids = block_ids.to(torch.int32).contiguous()
    owner = block_owner.to(torch.int32).contiguous()
    anc = None if q_anc is None else q_anc.to(torch.int32).contiguous()
    node = (None if block_node is None
            else block_node.to(torch.int32).contiguous())

    def override(q, k_new, v_new, positions, segments, kv, cfg, opts):
        dst, src = writes.get(positions)
        _write_kv(kv, dst, src, k_new, v_new, positions,
                  torch.zeros_like(segments))
        o = ops.fused_paged_verify(
            q[0].contiguous(), kv["k"], kv["v"], kv["seg"], kv["pos"],
            segments[0].to(torch.int32).contiguous(),
            positions[0].to(torch.int32).contiguous(), ids, owner, anc, node,
            k_scale=kv.get("k_scale"), v_scale=kv.get("v_scale"),
            config=fused_cfg)
        return o[None].to(q.dtype), kv

    return override


# ------------------------------------------------------- model entrypoints --

def decode_step_paged(params, cfg, cache, *, tokens, lengths, block_tables,
                      segments=None, fused_cfg=None, opts: T.Opts = T.Opts()):
    """Paged analogue of ``transformer.decode_step``: T new tokens per row,
    K/V written to / read from the rows' block tables.  ``segments``
    (optional, (B, T)) marks padding query tokens with -1 (chunked-prefill
    bucket padding): their KV writes land seg-invalidated and their outputs
    are ignored.  ``fused_cfg`` (a ``kernels.autotune.FusedConfig``) routes
    the read side through the fused kernel; None keeps the gather path."""
    bs = pool_dims(cache)[1]
    if fused_cfg is not None:
        override = make_fused_decode_override(block_tables, bs, fused_cfg)
    else:
        override = make_paged_decode_override(block_tables, bs)
    return T.decode_step(params, cfg, cache, tokens=tokens, lengths=lengths,
                         segments=segments, opts=opts, attn_override=override)


def verify_step_paged(params, cfg, cache, *, tokens, positions, segments,
                      q_rows, block_tables, block_ids, block_owner,
                      q_anc=None, block_node=None, fused_cfg=None,
                      opts: T.Opts = T.Opts()):
    """Paged analogue of ``transformer.verify_step_packed``; optional
    ``q_anc``/``block_node`` add the token-tree topology mask term."""
    bs = pool_dims(cache)[1]
    if fused_cfg is not None:
        override = make_fused_verify_override(
            q_rows, block_tables, block_ids, block_owner, bs, q_anc=q_anc,
            block_node=block_node, fused_cfg=fused_cfg)
    else:
        override = make_paged_verify_override(
            q_rows, block_tables, block_ids, block_owner, bs, q_anc=q_anc,
            block_node=block_node)
    return T.verify_step_packed(params, cfg, cache, tokens=tokens,
                                positions=positions, segments=segments,
                                attn_override=override, opts=opts)


def paged_compatible(cfg) -> bool:
    """Paged layout supports attention-family blocks (KV grids) only;
    recurrent state and sliding-window ring buffers stay dense."""
    kinds = set(cfg.unit) | set(cfg.tail)
    return (kinds <= {C.ATTN, C.MOE, C.SHARED_ATTN}
            and not cfg.sliding_window)
