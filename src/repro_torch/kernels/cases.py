"""Synthetic inputs for the attention kernels, made on the CPU from a
``torch.Generator`` and moved to ``device``: the geometry of the serving
path (fragmented block placement, idle rows, bucket-padding queries,
trailing padding entries, rolled-back slots, tree node tags and 32-bit
ancestor masks; for the dense kernels interleaved packed fragments,
padding cells, the dense plan's 128-cell rows, zero-length rows; for
prefill attention ragged lengths and windows) for checking a kernel
against its plain version.  Test support only: ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` use it, no serving code imports it, and it
is not part of the package's API.  ``kv`` names the pool storage:
"bf16", "f32" (the query takes the same float type), "int8" or "fp8"
(bf16 queries, float32 scale sidecars).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.decompose import plan_decomposition
from repro_torch.kernels import quant


def _quantized(x, kv):
    if kv in ("bf16", "f32"):
        return x.to(torch.bfloat16 if kv == "bf16" else torch.float32), None
    return quant.quantize(x, {"int8": torch.int8,
                              "fp8": torch.float8_e4m3fn}[kv])


def verify_inputs(gen, lens, W, H, Kh, D, bs, kv, tree, idle_rows=2,
                  pad_queries=2, shuffle=False, n_entries=None,
                  device="cuda"):
    """Packed verify over a fragmented pool: len(lens) requests with W + 1
    queries each, idle rows (queries, no blocks), padding queries (seg -1),
    trailing padding entries; tree cases carry random node tags in
    [-2, 31] on speculative slots and random 32-bit ancestor masks.
    ``shuffle`` permutes the block list (owners no longer grouped or
    sorted, padding entries among them); ``n_entries`` cuts or pads the
    list to that length (a cut block is simply not attended)."""
    nblk = [math.ceil((L + W + 1) / bs) for L in lens]
    N = sum(nblk) + 4
    perm = torch.randperm(N, generator=gen).tolist()
    pool_seg = torch.full((N, bs), -1, dtype=torch.int32)
    pool_pos = torch.full((N, bs), -1, dtype=torch.int32)
    ids, owner, node = [], [], []
    for r, L in enumerate(lens):
        for k in range(nblk[r]):
            b = perm.pop()
            pos = k * bs + torch.arange(bs)
            live = pos < L + W + 1
            pool_seg[b] = torch.where(live, 0, -1)
            pool_pos[b] = torch.where(live, pos, -1)
            ids.append(b)
            owner.append(r)
            tag = torch.randint(-2, 32, (bs,), generator=gen)
            node.append(torch.where(pos >= L, tag, -1))
    drop = torch.rand((N, bs), generator=gen) < 0.05    # rolled-back slots
    pool_seg[drop] = -1
    M = 1 << (len(ids) - 1).bit_length() if n_entries is None else n_entries
    ids = (ids + [0] * M)[:M]
    owner = (owner + [-1] * M)[:M]
    node = (node + [torch.full((bs,), -1)] * M)[:M]
    if shuffle:
        perm = torch.randperm(M, generator=gen).tolist()
        ids, owner, node = ([x[i] for i in perm] for x in (ids, owner, node))
    n_rows = len(lens) + idle_rows
    q_seg = [r for r in range(n_rows) for _ in range(W + 1)] + \
        [-1] * pad_queries
    q_pos = [(lens[r] if r < len(lens) else 0) + d for r in range(n_rows)
             for d in range(W + 1)] + [-1] * pad_queries
    Tq = len(q_seg)
    q_anc = torch.randint(-2**31, 2**31 - 1, (Tq,), generator=gen)
    x = torch.randn((2, N, bs, Kh, D), generator=gen)
    k, ks = _quantized(x[0], kv)
    v, vs = _quantized(x[1], kv)
    q = torch.randn((Tq, H, D), generator=gen).to(
        torch.float32 if kv == "f32" else torch.bfloat16)
    i32 = lambda t: torch.as_tensor(t, dtype=torch.int32)  # noqa: E731
    out = dict(q=q, k_pool=k, v_pool=v, pool_seg=pool_seg, pool_pos=pool_pos,
               q_seg=i32(q_seg), q_pos=i32(q_pos), block_ids=i32(ids),
               block_owner=i32(owner),
               q_anc=i32(q_anc) if tree else None,
               block_node=i32(torch.stack(node)) if tree else None,
               k_scale=ks, v_scale=vs)
    return {n: None if t is None else t.to(device).contiguous()
            for n, t in out.items()}


def decode_inputs(gen, lens, T, H, Kh, D, bs, kv, pad_queries=True,
                  device="cuda"):
    """Per-row decode: prefix-allocated tables (length 0 = idle row, no
    blocks), a few rolled-back slots, bucket-padding queries (seg -1)."""
    B = len(lens)
    need = [math.ceil((L + T) / bs) if L else 0 for L in lens]
    NB = 1 << (max(need) - 1).bit_length()
    N = sum(need) + 3
    perm = torch.randperm(N, generator=gen).tolist()
    bt = torch.full((B, NB), -1, dtype=torch.int32)
    pool_seg = torch.full((N, bs), -1, dtype=torch.int32)
    pool_pos = torch.full((N, bs), -1, dtype=torch.int32)
    for r, L in enumerate(lens):
        for k in range(need[r]):
            b = perm.pop()
            bt[r, k] = b
            pos = k * bs + torch.arange(bs)
            live = pos < L + T
            pool_seg[b] = torch.where(live, 0, -1)
            pool_pos[b] = torch.where(live, pos, -1)
    pool_seg[torch.rand((N, bs), generator=gen) < 0.05] = -1
    q_pos = torch.as_tensor([[L + t for t in range(T)] for L in lens],
                            dtype=torch.int32)
    q_seg = torch.zeros((B, T), dtype=torch.int32)
    if pad_queries and T > 1:
        q_seg[:, T - max(1, T // 4):] = -1
    x = torch.randn((2, N, bs, Kh, D), generator=gen)
    k, ks = _quantized(x[0], kv)
    v, vs = _quantized(x[1], kv)
    q = torch.randn((B, T, H, D), generator=gen).to(
        torch.float32 if kv == "f32" else torch.bfloat16)
    out = dict(q=q, k_pool=k, v_pool=v, pool_seg=pool_seg, pool_pos=pool_pos,
               q_seg=q_seg, q_pos=q_pos, block_tables=bt, k_scale=ks,
               v_scale=vs)
    return {n: None if t is None else t.to(device).contiguous()
            for n, t in out.items()}


def _floats(gen, shape, kv):
    return torch.randn(shape, generator=gen).to(
        torch.float32 if kv == "f32" else torch.bfloat16)


def dense_verify_inputs(gen, lens, W, H, Kh, D, kv, tree, pad_cells=12,
                        device="cuda"):
    """Flat packed buffer for ``verify_attention``: each request's context
    cut into up to four fragments, the fragments of all requests shuffled
    (interleaved segments) with padding cells (seg -1, pos -1) among them,
    then every request's W + 1 new slots.  Queries: W + 1 per request and
    two padding queries (seg -1), one at pos -1 so that it meets the
    padding cells causally.  Tree cases tag the new slots with node ids in
    [-2, 31] and give every query a random 32-bit ancestor mask.  ``kv``:
    "bf16" or "f32" (K/V and queries)."""
    frags = []
    for i, L in enumerate(lens):
        cuts = sorted(torch.randperm(max(L - 1, 1), generator=gen)[:3]
                      .add(1).tolist()) if L > 1 else []
        for lo, hi in zip([0, *cuts], [*cuts, L]):
            frags.append([(i, p, -1) for p in range(lo, hi)])
    frags += [[(-1, -1, -1)] for _ in range(pad_cells)]
    frags = [frags[j] for j in torch.randperm(len(frags),
                                              generator=gen).tolist()]
    cells = [c for f in frags for c in f]
    tags = torch.randint(-2, 32, (len(lens) * (W + 1),), generator=gen)
    cells += [(i, L + d, int(tags[i * (W + 1) + d]))
              for i, L in enumerate(lens) for d in range(W + 1)]
    kv_seg, kv_pos, kv_node = (list(c) for c in zip(*cells))
    q_seg = [i for i in range(len(lens)) for _ in range(W + 1)] + [-1, -1]
    q_pos = [L + d for L in lens for d in range(W + 1)] + [-1, 3]
    Tq, Tkv = len(q_seg), len(kv_seg)
    i32 = lambda t: torch.as_tensor(t, dtype=torch.int32)  # noqa: E731
    out = dict(q=_floats(gen, (Tq, H, D), kv),
               k=_floats(gen, (Tkv, Kh, D), kv),
               v=_floats(gen, (Tkv, Kh, D), kv),
               q_seg=i32(q_seg), q_pos=i32(q_pos),
               kv_seg=i32(kv_seg), kv_pos=i32(kv_pos),
               q_anc=(i32(torch.randint(-2**31, 2**31 - 1, (Tq,),
                                        generator=gen)) if tree else None),
               kv_node=i32(kv_node) if tree else None)
    return {n: None if t is None else t.to(device).contiguous()
            for n, t in out.items()}


def plan_verify_inputs(gen, lens, W, H, Kh, D, kv, tree, device="cuda"):
    """Flat buffer for ``verify_attention`` laid out as the dense layout's
    packed verify lays it: ``core.decompose.plan_decomposition`` packs each
    request's context into rows of 128-cell multiples (the rest of a row
    is padding, seg -1), then every request's W + 1 new slots follow.
    Queries: W + 1 per request at positions L .. L + W.  Tree cases tag the
    new slots with node ids in [-2, 31] and give every query a random
    32-bit ancestor mask.  ``kv``: "bf16" or "f32"."""
    plan = plan_decomposition(lens)
    kv_seg = np.where(plan.valid, plan.gather_b, -1).tolist()
    kv_pos = np.where(plan.valid, plan.gather_s, -1).tolist()
    kv_node = [-1] * len(kv_seg)
    tags = torch.randint(-2, 32, (len(lens) * (W + 1),), generator=gen)
    q_seg, q_pos = [], []
    for i, L in enumerate(lens):
        for d in range(W + 1):
            kv_seg.append(i)
            kv_pos.append(L + d)
            kv_node.append(int(tags[i * (W + 1) + d]))
            q_seg.append(i)
            q_pos.append(L + d)
    Tq, Tkv = len(q_seg), len(kv_seg)
    i32 = lambda t: torch.as_tensor(t, dtype=torch.int32)  # noqa: E731
    out = dict(q=_floats(gen, (Tq, H, D), kv),
               k=_floats(gen, (Tkv, Kh, D), kv),
               v=_floats(gen, (Tkv, Kh, D), kv),
               q_seg=i32(q_seg), q_pos=i32(q_pos),
               kv_seg=i32(kv_seg), kv_pos=i32(kv_pos),
               q_anc=(i32(torch.randint(-2**31, 2**31 - 1, (Tq,),
                                        generator=gen)) if tree else None),
               kv_node=i32(kv_node) if tree else None)
    return {n: None if t is None else t.to(device).contiguous()
            for n, t in out.items()}


def dense_decode_inputs(gen, lens, S, H, Kh, D, kv, device="cuda"):
    """``decode_attention`` over a (B, S, Kh, D) cache: one query per row,
    lengths ``lens`` (0 = a row with no live slot)."""
    B = len(lens)
    out = dict(q=_floats(gen, (B, H, D), kv),
               k=_floats(gen, (B, S, Kh, D), kv),
               v=_floats(gen, (B, S, Kh, D), kv),
               lengths=torch.as_tensor(lens, dtype=torch.int32))
    return {n: t.to(device).contiguous() for n, t in out.items()}


def paged_decode_inputs(gen, lens, H, Kh, D, bs, kv, device="cuda"):
    """``paged_decode_attention``: prefix-allocated tables over a shuffled
    pool with an unallocated tail (-1) on every row; length 0 = a row with
    no block."""
    B = len(lens)
    need = [math.ceil(L / bs) for L in lens]
    NB = max(need) + 2
    N = sum(need) + 3
    perm = torch.randperm(N, generator=gen).tolist()
    bt = torch.full((B, NB), -1, dtype=torch.int32)
    for r, n in enumerate(need):
        for k in range(n):
            bt[r, k] = perm.pop()
    x = torch.randn((2, N, bs, Kh, D), generator=gen)
    k, ks = _quantized(x[0], kv)
    v, vs = _quantized(x[1], kv)
    out = dict(q=_floats(gen, (B, H, D), kv), k_pool=k, v_pool=v,
               block_tables=bt,
               lengths=torch.as_tensor(lens, dtype=torch.int32),
               k_scale=ks, v_scale=vs)
    return {n: None if t is None else t.to(device).contiguous()
            for n, t in out.items()}


def flash_inputs(gen, B, S, H, Kh, D, kv, window=0, device="cuda"):
    """``flash_attention``: random q (B, S, H, D) and k, v (B, S, Kh, D) of
    one float type, and the window (0 = causal only)."""
    out = dict(q=_floats(gen, (B, S, H, D), kv),
               k=_floats(gen, (B, S, Kh, D), kv),
               v=_floats(gen, (B, S, Kh, D), kv))
    return {n: t.to(device).contiguous() for n, t in out.items()} | dict(
        window=window)
