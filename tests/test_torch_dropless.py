"""The serving path's dropless experts and per-layer windows on the CPU.

* ``kernels.moe_experts``: its plan (every pair in exactly one tile of its
  own expert, the grid's bound) and its plain version against a plain
  per-expert loop, with an expert that no token chose and one that every
  token chose, at each tile height;
* ``models.moe.dropless`` against the capacity-bounded ``moe_ffn`` where
  nothing is dropped, and its tracer counters; a forward that would take
  ``moe_ffn`` for a model it cannot compute (sigmoid routing, a shared
  expert) raises;
* the window term of the fused kernels' plain versions (``ops.
  fused_paged_verify``, ``ops.fused_paged_decode``) against a direct
  per-query softmax over the keys the window keeps;
* a bf16 forward with ``float32_stream`` against the float32 forward.

Tolerances: float32 on both sides, sums in another order: 1e-5 of values
of order 1."""

import dataclasses
import math
import types

import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import cases, moe_experts as K, ops
from repro_torch.models import moe
from repro_torch.serving import trace


def per_expert_loop(x, ids, w, wg, wu, wd):
    out = torch.zeros_like(x)
    for e in range(wg.shape[0]):
        rows, choice = (ids == e).nonzero(as_tuple=True)
        h = F.silu(x[rows] @ wg[e]) * (x[rows] @ wu[e])
        out.index_add_(0, rows, w[rows, choice, None] * (h @ wd[e]))
    return out


def inputs(T, E, k, d=24, ff=16, seed=0, all_to=None, none_to=None):
    g = torch.Generator().manual_seed(seed)
    ids = torch.stack([torch.randperm(E, generator=g)[:k] for _ in range(T)])
    if none_to is not None:          # expert none_to gets no pair
        ids = torch.where(ids == none_to, (none_to + 1) % E, ids)
        ids[:, 1] = torch.where(ids[:, 0] == ids[:, 1], (ids[:, 1] + 2) % E,
                                ids[:, 1])
    if all_to is not None:           # every token's first choice
        ids[:, 0] = all_to
        ids[:, 1:] = torch.where(ids[:, 1:] == all_to, (all_to + 1) % E,
                                 ids[:, 1:])
    w = torch.rand(T, k, generator=g)
    wg, wu = (torch.randn(E, d, ff, generator=g) / math.sqrt(d)
              for _ in range(2))
    wd = torch.randn(E, ff, d, generator=g) / math.sqrt(ff)
    return torch.randn(T, d, generator=g), ids, w, wg, wu, wd


# (T, E, k): one token; tiles of 16, 32 and 64 pairs
SHAPES = [(1, 8, 2), (9, 8, 2), (40, 4, 2), (100, 4, 2)]


@pytest.mark.parametrize("T,E,k", SHAPES)
def test_plan_covers_every_pair_once(T, E, k):
    _, ids, *_ = inputs(T, E, k)
    bm = K.tile_rows(T * k, E)
    assert bm == (16 if T * k / E <= 16 else 32 if T * k / E <= 32 else 64)
    order, expert, start, end = K.plan(ids, E, bm)
    assert expert.shape[0] == max(1, min(T * k, (T * k + E * (bm - 1))
                                         // bm))
    seen = []
    flat = ids.reshape(-1)
    for e, lo, hi in zip(expert.tolist(), start.tolist(), end.tolist()):
        if e < 0:
            continue
        pairs = order[lo:min(lo + bm, hi)]
        assert 0 < len(pairs) <= bm and (flat[pairs] == e).all()
        seen += pairs.tolist()
    assert sorted(seen) == list(range(T * k))


@pytest.mark.parametrize("case", ["random", "no_pairs", "every_token"]
                         + [f"shape{i}" for i in range(len(SHAPES))])
def test_grouped_matches_per_expert_loop(case):
    if case.startswith("shape"):
        a = inputs(*SHAPES[int(case[5:])])
    else:
        a = inputs(24, 8, 2, all_to=5 if case == "every_token" else None,
                   none_to=3 if case == "no_pairs" else None)
    ids = a[1]
    if case == "no_pairs":
        assert not (ids == 3).any()
    if case == "every_token":
        assert (ids == 5).any(1).all()
    got = ops.moe_experts(*a)
    torch.testing.assert_close(got, per_expert_loop(*a), atol=1e-5,
                               rtol=1e-5)


def test_dropless_matches_moe_ffn_when_nothing_drops():
    """Softmax routing at a capacity (128 slots an expert) no expert
    reaches: the dropless path is the capacity-bounded one's function."""
    x, _, _, wg, wu, wd = inputs(20, 4, 2, seed=4)
    router = torch.randn(24, 4, generator=torch.Generator().manual_seed(5))
    cfg = types.SimpleNamespace(router="softmax", top_k=2,
                                n_shared_experts=0)
    p = {"router": router, "w_gate": wg, "w_up": wu, "w_down": wd}
    want, _, _ = moe.moe_ffn(x, router, wg, wu, wd, top_k=2, cf=1.25)
    tr = trace.Tracer()
    tr.on = True
    with tr.span("step"):
        got = moe.dropless(x, p, cfg)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    counts = tr.drain()["spans"][0]["counts"]
    assert counts == {"moe_calls": 1, "moe_pairs": 40}


def _tiny_afmoe(**change):
    from repro_torch.models.config import ATTN, MOE, ModelConfig
    cfg = ModelConfig(
        name="tiny-afmoe", family="moe", n_layers=2, d_model=32, n_heads=4,
        n_kv_heads=2, d_ff=16, vocab_size=64, head_dim=8, n_experts=4,
        top_k=2, capacity_factor=2.0, router="sigmoid", route_scale=2.0,
        n_shared_experts=1, dense_ff=48, unit=(ATTN, MOE),
        layer_windows=(4, 0), layer_rope=(True, False), gated=True,
        dtype="float32")
    return dataclasses.replace(cfg, **change)


@pytest.mark.parametrize("case", ["sharded_sigmoid", "sharded_shared",
                                  "training_softmax_shared"])
def test_capacity_moe_refuses_models_it_cannot_compute(case, monkeypatch):
    """``moe_ffn`` routes by softmax and has no shared expert: a sharded
    forward (the DTensor branch, reached here by a patched test) of a
    sigmoid-routed or shared-expert model, or a training forward of a
    softmax model with a shared expert, raises instead of computing
    another model.  (A training forward of a sigmoid model runs dropless
    and matches the reference: ``h100bench/test_h100bench_afmoe.py``.)"""
    from repro_torch.models import transformer as T
    cfg = {"sharded_sigmoid": _tiny_afmoe(n_shared_experts=0),
           "sharded_shared": _tiny_afmoe(router="softmax"),
           "training_softmax_shared": _tiny_afmoe(router="softmax")}[case]
    if case.startswith("sharded"):
        monkeypatch.setattr(T, "is_dtensor", lambda t: True)
    params = T.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="capacity-bounded"):
        T.apply(params, cfg, tokens=torch.zeros(1, 4, dtype=torch.long))


def test_float32_stream_keeps_a_bf16_forward_near_float32():
    """``float32_stream``: a bf16 forward of gated blocks whose stream
    enters 45 times above each normed update (AFMoE's scale, sqrt(d) x
    embeddings of std 1) adds every update to a float32 stream and returns
    float32 logits; against the float32 forward of the same weights its
    logits err a quarter as much as a bf16 stream's (0.23-0.26 over twelve
    seeds of this model: the bound 0.5 leaves twice that).  Dense blocks,
    so that no near-tied expert selection flips and the ratio measures the
    stream alone."""
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ATTN
    cfg = _tiny_afmoe(n_layers=8, d_model=64, unit=(ATTN,) * 8,
                      layer_windows=(4, 4, 4, 0) * 2,
                      layer_rope=(True, True, True, False) * 2,
                      embed_scale=8.0, vocab_size=256)
    p = T.init_params(cfg, seed=1, device="cpu")
    p["embed"] = p["embed"] / p["embed"].std() * 45 / 8
    bf = torch.utils._pytree.tree_map(lambda t: t.bfloat16(), p)
    toks = torch.randint(0, 256, (2, 24),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = T.apply(torch.utils._pytree.tree_map(lambda t: t.float(), bf),
                       cfg, tokens=toks)[0]
        err = {}
        for f32 in (False, True):
            got = T.apply(bf, dataclasses.replace(
                cfg, dtype="bfloat16", float32_stream=f32), tokens=toks)[0]
            assert got.dtype == (torch.float32 if f32 else torch.bfloat16)
            err[f32] = float((got.float() - want).pow(2).mean().sqrt()
                             / want.std())
    assert err[True] < 0.5 * err[False], err


def _masked_softmax(q, k, v, ok):
    """One query's heads (H, D) over keys (S, H, D) where ok (S,)."""
    if not ok.any():
        return torch.zeros_like(q)
    s = torch.einsum("hd,shd->hs", q, k[ok]) / math.sqrt(q.shape[-1])
    return torch.einsum("hs,shd->hd", torch.softmax(s, -1), v[ok])


@pytest.mark.parametrize("window", [0, 6, 40])
def test_verify_window_plain(window):
    g = torch.Generator().manual_seed(7)
    a = cases.verify_inputs(g, [9, 50, 23], 4, 4, 2, 16, 8, "f32", False,
                            device="cpu")
    got = ops.fused_paged_verify(**a, window=window)
    ids = a["block_ids"].long().clamp(min=0)
    bs = a["k_pool"].shape[1]
    G = a["q"].shape[1] // a["k_pool"].shape[2]
    k = a["k_pool"][ids].reshape(-1, *a["k_pool"].shape[2:])
    v = a["v_pool"][ids].reshape(-1, *a["v_pool"].shape[2:])
    k, v = (t.repeat_interleave(G, dim=1) for t in (k, v))
    seg = torch.where((a["pool_seg"][ids].reshape(-1) >= 0)
                      & (a["block_owner"].repeat_interleave(bs) >= 0),
                      a["block_owner"].repeat_interleave(bs), -1)
    pos = a["pool_pos"][ids].reshape(-1)
    for t in range(a["q"].shape[0]):
        qs, qp = int(a["q_seg"][t]), int(a["q_pos"][t])
        ok = (seg == qs) & (seg >= 0) & (pos <= qp)
        if window:
            ok &= pos > qp - window
        torch.testing.assert_close(got[t], _masked_softmax(a["q"][t], k, v,
                                                           ok),
                                   atol=1e-5, rtol=1e-5)
    if window == 6:   # the term binds at these contexts
        assert not torch.allclose(got, ops.fused_paged_verify(**a),
                                  atol=1e-3)


@pytest.mark.parametrize("window", [0, 5])
def test_decode_window_plain(window):
    g = torch.Generator().manual_seed(8)
    a = cases.decode_inputs(g, [30, 0, 13], 3, 4, 2, 16, 8, "f32",
                            device="cpu")
    got = ops.fused_paged_decode(**a, window=window)
    bs = a["k_pool"].shape[1]
    G = a["q"].shape[2] // a["k_pool"].shape[2]
    for b in range(a["q"].shape[0]):
        bt = a["block_tables"][b]
        ids = bt.long().clamp(min=0)
        live = (bt >= 0).repeat_interleave(bs)
        k = a["k_pool"][ids].reshape(-1, *a["k_pool"].shape[2:])
        v = a["v_pool"][ids].reshape(-1, *a["v_pool"].shape[2:])
        k, v = (t.repeat_interleave(G, dim=1) for t in (k, v))
        seg = torch.where(live, a["pool_seg"][ids].reshape(-1), -1)
        pos = a["pool_pos"][ids].reshape(-1)
        for t in range(a["q"].shape[1]):
            qs, qp = int(a["q_seg"][b, t]), int(a["q_pos"][b, t])
            ok = (seg == qs) & (seg >= 0) & (pos <= qp)
            if window:
                ok &= pos > qp - window
            torch.testing.assert_close(
                got[b, t], _masked_softmax(a["q"][b, t], k, v, ok),
                atol=1e-5, rtol=1e-5)
