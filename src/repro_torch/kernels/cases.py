"""Synthetic inputs for the paged attention kernels, made on the CPU from a
``torch.Generator`` and moved to ``device``: the geometry of the serving
path (fragmented block placement, idle rows, bucket-padding queries,
trailing padding entries, rolled-back slots, tree node tags and 32-bit
ancestor masks) for checking a kernel against its plain version.  Test
support only: ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` use it, no
serving code imports it, and it is not part of the package's API.  ``kv``
names the pool
storage: "bf16", "f32" (the query takes the same float type), "int8" or
"fp8" (bf16 queries, float32 scale sidecars).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import quant


def _quantized(x, kv):
    if kv in ("bf16", "f32"):
        return x.to(torch.bfloat16 if kv == "bf16" else torch.float32), None
    return quant.quantize(x, {"int8": torch.int8,
                              "fp8": torch.float8_e4m3fn}[kv])


def verify_inputs(gen, lens, W, H, Kh, D, bs, kv, tree, idle_rows=2,
                  pad_queries=2, device="cuda"):
    """Packed verify over a fragmented pool: len(lens) requests with W + 1
    queries each, idle rows (queries, no blocks), padding queries (seg -1),
    trailing padding entries; tree cases carry random node tags in
    [-2, 31] on speculative slots and random 32-bit ancestor masks."""
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
    M = 1 << (len(ids) - 1).bit_length()
    ids += [0] * (M - len(ids))
    owner += [-1] * (M - len(owner))
    node += [torch.full((bs,), -1)] * (M - len(node))
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
