"""Dropless grouped experts: every routed (token, choice) pair through its
expert's SwiGLU, weighted by its routing weight and summed per token.

Replaces no TPU kernel: the JAX package computes its experts over a
capacity-bounded (E, C) grid by batched matmuls (``models/moe.py``, left
to XLA); a capacity drops pairs, and a dropped pair breaks SPIN's promise
that the served tokens are the LLM's greedy ones.  The kernel is
``csrc/moe_experts.cu`` (what bounds it and what its design does about
it: the note there), built and bound as the others (``build.py``).

The pairs are sorted by expert on the card and cut into tiles of ``bm``
pairs of one expert (:func:`plan`: a sort, a count, prefix sums and a
search; no host sync, no per-expert loop); one C call launches gate/up
with the SwiGLU, then down with the routing weight, each pair's row
written at the pair's own index in float32, so that the wrapper sums a
token's ``top_k`` rows in a fixed order.

``moe_experts`` is the wrapper: the plain version (:func:`moe_experts_plain`,
the same plan walked tile by tile in PyTorch) on a CPU tensor, the CUDA
kernel on the card.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

NAME = "moe_experts"


def tile_rows(pairs: int, experts: int) -> int:
    """Pairs a tile (16, 32 or 64) from the mean pairs an expert."""
    mean = pairs / max(experts, 1)
    return 16 if mean <= 16 else (32 if mean <= 32 else 64)


def plan(ids, n_experts: int, bm: int):
    """The pairs of ``ids`` (T, k) sorted by expert and cut into tiles.

    Returns ``order`` (P,), the pair indices (t * k + j) sorted by expert,
    stable; and per tile of at most ``bm`` sorted pairs of one expert its
    ``expert`` (-1 past the real tiles), its first sorted row ``start`` and
    the end of its expert's rows ``end``, over a host-known upper bound of
    tiles, min(P, (P + E (bm - 1)) // bm).  All on ``ids``' device, with
    no host sync."""
    flat = ids.reshape(-1).long()
    P, E, dev = flat.numel(), n_experts, flat.device
    order = torch.sort(flat, stable=True).indices
    counts = torch.zeros(E, dtype=torch.long, device=dev).index_add_(
        0, flat, torch.ones_like(flat))
    ends = torch.cumsum(counts, 0)
    tiles = (counts + bm - 1) // bm
    tile_ends = torch.cumsum(tiles, 0)
    n = max(1, min(P, (P + E * (bm - 1)) // bm))
    i = torch.arange(n, device=dev)
    e = torch.searchsorted(tile_ends, i, right=True)
    ec = e.clamp(max=E - 1)
    start = ends[ec] - counts[ec] + (i - (tile_ends[ec] - tiles[ec])) * bm
    expert = torch.where(e < E, e, -1)
    return (order, expert.to(torch.int32), start.to(torch.int32),
            ends[ec].to(torch.int32))


def moe_experts_plain(x, ids, weights, w_gate, w_up, w_down):
    """:func:`moe_experts` in PyTorch: the same plan, each tile's pairs
    through their expert, float32 sums, the SwiGLU rounded to x's dtype
    before the down projection as the kernel stores it."""
    T, k = ids.shape
    E = w_gate.shape[0]
    bm = tile_rows(T * k, E)
    order, expert, start, end = plan(ids, E, bm)
    y = torch.zeros(T * k, x.shape[1], dtype=torch.float32, device=x.device)
    wts = weights.reshape(-1).float()
    for e, lo, hi in zip(expert.tolist(), start.tolist(), end.tolist()):
        if e < 0:
            continue
        pairs = order[lo:min(lo + bm, hi)]
        xa = x[pairs // k].float()
        h = F.silu(xa @ w_gate[e].float()) * (xa @ w_up[e].float())
        y[pairs] = (h.to(x.dtype).float() @ w_down[e].float()) \
            * wts[pairs, None]
    return y.view(T, k, -1).sum(1).to(x.dtype)


def _c_fn():
    fn = build.load(NAME).spin_moe_experts
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 11 + [i] * 6 + [p]
    fn.restype = i
    return fn


def moe_experts(x, ids, weights, w_gate, w_up, w_down):
    """Dropless routed experts.

    x: (T, d); ids: (T, k) integer expert of each (token, choice);
    weights: (T, k) its routing weight (float32); w_gate / w_up: (E, d,
    ff), w_down: (E, ff, d).  Returns (T, d) in x's dtype: for each token
    the sum over its k choices of weight x SwiGLU of its expert, summed in
    float32.  On the card: :func:`plan` and one call of the CUDA kernel (bf16
    on the tensor cores, float32 on the CUDA cores), one count in :data:`build.LAUNCHES` per
    call; no host sync."""
    if x.device.type == "cpu":
        return moe_experts_plain(x, ids, weights, w_gate, w_up, w_down)
    T, d = x.shape
    k = ids.shape[1]
    E, _, ff = w_gate.shape
    if (w_up.shape != w_gate.shape or w_down.shape != (E, ff, d)
            or ids.shape != weights.shape or ids.shape[0] != T
            or w_gate.dtype != x.dtype or x.dtype not in (torch.bfloat16,
                                                          torch.float32)):
        raise ValueError(
            f"moe_experts: x {tuple(x.shape)} {x.dtype}, ids "
            f"{tuple(ids.shape)}, weights {tuple(weights.shape)}, w_gate "
            f"{tuple(w_gate.shape)} {w_gate.dtype}, w_down "
            f"{tuple(w_down.shape)}")
    if x.dtype == torch.bfloat16 and (d % 8 or ff % 8):
        raise ValueError(f"moe_experts: bf16 rows of d {d} and ff {ff} "
                         f"must be whole 16-byte chunks (multiples of 8)")
    bm = tile_rows(T * k, E)
    order, expert, start, end = plan(ids, E, bm)
    x, w_gate, w_up, w_down = (t.contiguous() for t in (x, w_gate, w_up,
                                                       w_down))
    wts = weights.float().contiguous()
    order = order.to(torch.int32)
    h = torch.empty(T * k, ff, dtype=x.dtype, device=x.device)
    y = torch.empty(T * k, d, dtype=torch.float32, device=x.device)
    build.raise_on(_c_fn()(
        x.data_ptr(), order.data_ptr(), expert.data_ptr(), start.data_ptr(),
        end.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
        wts.data_ptr(), h.data_ptr(), y.data_ptr(), expert.shape[0], d, ff,
        k, bm, int(x.dtype == torch.bfloat16), build.stream_of(x)), NAME)
    build.LAUNCHES[NAME] += 1
    return y.view(T, k, d).sum(1).to(x.dtype)
