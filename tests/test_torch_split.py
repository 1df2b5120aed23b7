"""Host-side logic of the redesigned attention kernels, on the CPU.

* ``verify_attention.split_plan``: the split-KV grid of the dense packed
  verify covers every 32-slot tile exactly once, leaves no run empty and
  stays inside CUDA's grid limits up to 64k slots;
* ``paged_attention.verify_plan``: the packed verify's chunks (by a model
  of the kernel's scan) give every entry a segment owns to exactly one
  chunk, leave no chunk with entries empty and no list overflowing, stay
  inside CUDA's grid limits and shared memory; the benchmark cells' calls
  are not split, long lists a token are; the route by dtype; the split
  counter; the plain version needs no contiguous segments;
* ``fused_verify.fused_paged_verify`` sizes and launches its call as
  ``paged_verify_attention`` does (the same ``verify_plan``, the shared
  kernel) at the serving path's geometries;
* ``decode_attention.run_plan``: the runs of the dense decode cover every
  32-slot tile of a row once (and, by the kernel's rule, every live slot
  once; a row of length 0 is one empty run), fill the card at a long row
  and a small batch, and respect the run cap and shared memory;
* ``paged_attention.paged_decode_attention``'s plan, ``decode_attention``'s
  run planner at S = NB * bs: its runs cover every 32-slot tile of a row
  once and, by the kernel's rule (each run's slice of the block table),
  every live slot once for block sizes 8 to 64 and lengths that stop
  mid-block and mid-tile; a row of length 0 is one empty run; the stages,
  the queries and the table slice fit in shared memory; a stubbed-card
  test holds the paged and the dense decode to the same plan;
* ``fused_decode.decode_plan`` and ``build.tile_pipeline``: the split
  layout exactly where a CTA has fewer query rows than warps, at most four
  rows a warp, stages within their byte budget, and the stage layout of
  ``csrc/tile_pipeline.cuh``;
* ``flash_attention.route``: bf16 goes to the tensor-core kernel, float32
  to the CUDA-core kernel, explicitly, and anything else raises;
* ``cases.plan_verify_inputs`` (the dense plan's 128-cell rows, the
  layout the card's split-KV checks use): the port's wrapper on the CPU
  against the reference's Pallas ``verify_attention`` in interpret mode,
  at the tolerances of ``tests/test_torch_attention.py``;
* ``build.ptxas_entries``: the registers and spills ``chip_smoke.py``
  reports from the compiler's output."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels.verify_attention import verify_attention as j_verify
import collections

from repro_torch.kernels import build, cases, decode_attention, ops
from repro_torch.kernels import paged_attention
from repro_torch.kernels.flash_attention import MMA_HEAD_DIMS, route
from repro_torch.kernels.fused_decode import decode_plan
from repro_torch.kernels.fused_verify import fused_paged_verify
from repro_torch.kernels.paged_attention import (MAX_CHUNKS, MMA_ROWS,
                                                 SCAN_BATCH, SEG_TOKENS,
                                                 SMEM_PER_CTA, SPLIT_ENTRIES,
                                                 mma_smem, verify_plan)
from repro_torch.kernels.verify_attention import (KV_TILE, MAX_RUNS,
                                                  TAG_GROUP, split_plan)

SLOTS = [0, 1, 31, 32, 33, 127, 128, 129, 542, 2000, 2374, 4096, 4097,
         10_000, 65_536]
GEOMETRIES = [(30, 1, 32), (30, 6, 8), (1, 16, 1), (192, 4, 8), (7, 7, 2)]


@pytest.mark.parametrize("Tq,G,Kh", GEOMETRIES)
@pytest.mark.parametrize("Tkv", SLOTS)
def test_split_plan_covers_every_tile_once(Tq, G, Kh, Tkv):
    bq, per_run, runs = split_plan(Tq, G, Kh, Tkv, sms=132)
    tiles = -(-Tkv // KV_TILE)
    covered = [t for z in range(runs)
               for t in range(z * per_run, min(tiles, (z + 1) * per_run))]
    assert covered == list(range(tiles))
    assert all(z * per_run < tiles for z in range(runs)), "an empty run"
    assert per_run >= TAG_GROUP and runs <= MAX_RUNS
    # CUDA: grid x < 2^31, y and z <= 65535; the CTA holds <= 16 rows
    assert 1 <= bq and bq * G <= build.MAX_ROWS
    assert -(-Tq // bq) < 2**31 and Kh <= 65535 and runs <= 65535


def test_split_plan_fills_the_card_at_the_dense_path_shape():
    """q (30, 32, 128) over 542 slots: more than two CTAs per SM, each
    walking at most one pass of tags instead of 17 tiles in a row."""
    bq, per_run, runs = split_plan(30, 1, 32, 542, sms=132)
    assert per_run == TAG_GROUP and runs == 5
    assert -(-30 // bq) * 32 * runs >= 2 * 132


def _align16(n):
    return -(-n // 16) * 16


def _pipeline_smem(rows, D, kv_bytes, wpt, stages):
    """Dynamic shared memory of the stages (or of the teams' merge buffer,
    which reuses them): csrc/tile_pipeline.cuh, ``stages_smem``."""
    teams = build.WARPS // wpt
    return max(teams * stages * build.stage_bytes(D, kv_bytes),
               4 * teams * rows * (D + 2))


def _check_pipeline(rows, D, kv_bytes, wpt, stages, extra):
    assert wpt in (1, 2, 4) and rows <= build.ROWS_PER_WARP * wpt
    assert 1 <= stages <= build.MAX_STAGES
    teams = build.WARPS // wpt
    assert (stages == 1 or teams * stages * build.stage_bytes(D, kv_bytes)
            <= build.STAGE_BUDGET)
    assert extra + _pipeline_smem(rows, D, kv_bytes, wpt, stages) \
        <= SMEM_PER_CTA


ENTRIES = [0, 1, 2, 15, 16, 17, 63, 64, 65, 1000, 2049, 4095, 4096]
RUN_GEOMETRIES = [(1, 1, 32), (30, 1, 32), (192, 1, 32), (30, 6, 8),
                  (7, 8, 8), (192, 8, 8), (192, 6, 1), (640, 5, 8)]


def _owners(M, Tq, seed):
    """A block list of M entries over max(1, Tq // 5) segments in no
    order: segment 0 owns about half (a long request), the others the
    rest, about one entry in ten is padding (-1)."""
    rng = np.random.default_rng(seed)
    n_seg = max(1, Tq // 5)
    own = np.where(rng.random(M) < 0.5, 0, rng.integers(0, n_seg, M))
    return np.where(rng.random(M) < 0.1, -1, own), n_seg


def _deal(owner, seg, z, chunks, cap):
    """The kernel's scan (csrc/verify_runs.cuh ``scan_window``): the
    windows of entries chunk z of segment ``seg`` lists, in list order,
    and the segment's entries.  Rounds of SCAN_BATCH entries; a round that
    could overflow ``cap`` starts a new window; each listed entry's slot
    in its window is checked to lie in [0, cap)."""
    M = len(owner)
    match = np.asarray(owner) == seg

    def share(n):
        return (n - z + chunks - 1) // chunks if n > z else 0

    pos = n_seg = before = 0
    windows = []
    while True:
        n_list, listed = 0, []
        while pos < M:
            take = min(SCAN_BATCH, M - pos)
            if n_list > 0 and (n_list + share(n_seg + take) - share(n_seg)
                               > cap):
                break
            idx = pos + np.nonzero(match[pos:pos + take])[0]
            ranks = n_seg + np.arange(len(idx))
            mine = ranks % chunks == z
            k = ranks[mine] // chunks - before
            assert list(k) == list(range(n_list, n_list + len(k)))
            assert (k < cap).all()
            listed += idx[mine].tolist()
            n_seg += len(idx)
            n_list = share(n_seg) - before
            pos += take
        windows.append(listed)
        before += n_list
        if pos >= M:
            return windows, n_seg


@pytest.mark.parametrize("Tq,G,Kh", RUN_GEOMETRIES)
@pytest.mark.parametrize("M", ENTRIES)
def test_verify_plan_deals_every_entry_to_one_chunk(Tq, G, Kh, M):
    """Every entry a segment owns is streamed by exactly one chunk of its
    tile, min(chunks, entries) chunks hold one or more and the rest none
    (they exit before any partial); no window of a chunk with entries is
    empty and none overflows the list; the grid, the rows and the shared
    memory stay inside CUDA's limits and the plan's own formula."""
    plan = verify_plan(Tq, G, Kh, M, 16, 128, 2, 2, 132)
    owner, n_seg = _owners(M, Tq, seed=Tq * 7919 + M)
    for seg in {0, n_seg - 1, n_seg}:      # n_seg: a segment with no entry
        got = []
        for z in range(plan.chunks):
            windows, n = _deal(owner, seg, z, plan.chunks, plan.cap)
            entries = [e for w in windows for e in w]
            assert (len(entries) > 0) == (z < min(plan.chunks, n))
            assert all(windows) or windows == [[]]
            got += entries
        assert sorted(got) == np.nonzero(owner == seg)[0].tolist()
    assert plan.mma and plan.tokens == MMA_ROWS // (G * plan.heads)
    assert Kh % plan.heads == 0 and plan.tokens >= min(SEG_TOKENS,
                                                       MMA_ROWS // G)
    assert 1 <= plan.chunks <= MAX_CHUNKS
    assert plan.cap * plan.chunks >= min(M, SCAN_BATCH) and plan.cap >= 1
    # CUDA: grid x < 2^31, y and z <= 65535
    assert Tq < 2**31 and Kh <= 65535 and plan.chunks <= 65535
    assert plan.smem == mma_smem(plan.cap, 128, 2, plan.stages)
    assert plan.smem <= SMEM_PER_CTA


def test_verify_plan_keeps_the_cells_whole():
    """The benchmark cells' calls (Qwen2.5-14B: 128 requests x 5 tokens, G
    5, a list of 1024; InternLM2-20B: 64 x 5, G 6, 512): one chunk -- no
    partials, no counters, no merge -- a request's five tokens of two kv
    heads in one tile on the tensor cores, and two CTAs an SM by shared
    memory."""
    for Tq, G, M in ((640, 5, 1024), (320, 6, 512)):
        plan = verify_plan(Tq, G, 8, M, 16, 128, 2, 2, 132)
        assert plan.chunks == 1 and plan.mma and plan.heads == 2
        assert plan.tokens >= 5
        assert plan.cap == M and 2 * (plan.smem + 1024) <= 228 * 1024


@pytest.mark.parametrize("Tq,G,Kh,M", [(42, 1, 32, 4096), (30, 1, 32, 4096),
                                       (80, 5, 8, 4096), (16, 5, 8, 2048)])
def test_verify_plan_splits_long_lists(Tq, G, Kh, M):
    """Few segments over long lists (chip_smoke's 4096-entry LLaMA-7B
    call, a long-prompt cohort of 16 requests): the segments' entries are
    dealt to several chunks, about SPLIT_ENTRIES entries a query token
    each, so no CTA streams a whole request alone."""
    plan = verify_plan(Tq, G, Kh, M, 16, 128, 2, 2, 132)
    assert plan.chunks == min(MAX_CHUNKS, M // (Tq * SPLIT_ENTRIES)) > 1
    assert plan.cap == -(-M // plan.chunks)


@pytest.mark.parametrize("Tq,G,Kh,M,heads", [
    (652, 5, 8, 1024, 2), (332, 6, 8, 512, 2), (212, 1, 32, 256, 4),
    (212, 2, 8, 256, 2), (30, 1, 32, 16, 1), (42, 1, 32, 4096, 1),
    (652, 16, 8, 1024, 1), (652, 5, 5, 1024, 1), (80, 5, 8, 200, 1),
    (320, 6, 8, 512, 2), (42, 6, 8, 64, 1)])
def test_verify_plan_heads_a_cta(Tq, G, Kh, M, heads):
    """Kv heads a tensor-core CTA: the most of 4, 2, 1 that divides Kh,
    leaves a tile SEG_TOKENS tokens and, at a segment every SEG_TOKENS
    tokens, a CTA an SM; one where the plan splits."""
    plan = verify_plan(Tq, G, Kh, M, 16, 128, 2, 2, 132)
    assert plan.heads == heads
    assert plan.tokens == MMA_ROWS // (G * heads)


def test_verify_plan_without_entries_is_one_chunk():
    plan = verify_plan(30, 1, 32, 0, 16, 128, 2, 2, 132)
    assert plan.chunks == 1 and plan.cap == 1


@pytest.mark.parametrize("q_bytes,kv_bytes,D,mma", [
    (2, 2, 128, True), (2, 1, 128, True), (2, 2, 64, True), (2, 1, 96, True),
    (2, 2, 16, True), (4, 4, 128, False), (2, 4, 128, False),
    (4, 2, 128, False), (2, 2, 12, False), (2, 2, 40, False),
    (2, 1, 8, False)])
def test_verify_plan_routes_by_dtype(q_bytes, kv_bytes, D, mma):
    """bf16 queries over bf16/int8/fp8 pools at a head dim of whole 16-wide
    k-steps score on the tensor cores; float32 queries or pools, or
    another head dim, on the CUDA cores (float32 arithmetic), whose rows,
    teams and stages stay inside the tile pipeline's limits."""
    plan = verify_plan(30, 4, 8, 64, 16, D, q_bytes, kv_bytes, 132)
    assert plan.mma == mma
    if mma:
        assert plan.wpt == 0 and plan.tokens * 4 * plan.heads <= MMA_ROWS
    else:
        rows = plan.tokens * 4
        assert rows == build.MAX_ROWS
        _check_pipeline(rows, D, kv_bytes, plan.wpt, plan.stages,
                        2 * _align16(4 * plan.cap) + _align16(4 * rows * D))


def test_fused_verify_sizes_its_call_as_paged_verify(monkeypatch):
    """At the paged path's verify geometries (LLaMA-7B q (30, 32, 128),
    dbrx q (30, 48, 128) over a Kh 8 pool, 16 entries of 16 slots; the
    Qwen cell's q (640, 40, 128) over 1024 entries) both wrappers take the
    same plan, launch the same kernel arguments through their own entries
    (``fused_verify.cu``, ``paged_attention.cu``) and count one launch
    each under their own names.  The card's pieces are stubbed: meta
    tensors carry the shapes."""
    plans, calls = [], []
    real = paged_attention.verify_plan

    def plan(*a):
        plans.append(real(*a))
        return plans[-1]

    def c_fn(source, name, n_ptr, n_int):
        return lambda *args: calls.append((source, name, args[n_ptr:])) or 0

    monkeypatch.setattr(paged_attention, "verify_plan", plan)
    monkeypatch.setattr(paged_attention, "_c_fn", c_fn)
    monkeypatch.setattr(build, "check_pools", lambda *a: (1, 1))
    monkeypatch.setattr(build, "sm_count", lambda device: 132)
    monkeypatch.setattr(build, "stream_of", lambda t: 0)
    monkeypatch.setattr(build, "ptr", lambda t: None)
    monkeypatch.setattr(build, "LAUNCHES", collections.Counter())
    for Tq, H, Kh, M in ((30, 32, 32, 16), (30, 48, 8, 16),
                         (640, 40, 8, 1024)):
        a = _meta_verify_args(Tq, H, Kh, M)
        fused_paged_verify(**a)
        paged_attention.paged_verify_attention(**a)
    assert plans[0::2] == plans[1::2]
    # one tile a request on the tensor cores, one chunk (no merge); two kv
    # heads a CTA where the grid stays full (the Qwen cell), else one
    assert [p[:6] for p in plans[0::2]] == [
        (64, 4, 1, 16, True, 1), (10, 4, 1, 16, True, 1),
        (6, 4, 1, 1024, True, 2)]
    assert [c[:2] for c in calls] == [
        ("fused_verify", "fused_paged_verify"),
        ("paged_attention", "paged_verify_attention")] * 3
    for i in range(3):
        assert calls[2 * i][2] == calls[2 * i + 1][2]
        assert calls[2 * i][2][6:14] == tuple(plans[2 * i][:8])
    assert build.LAUNCHES == {"fused_paged_verify": 3,
                              "paged_verify_attention": 3}


def _meta_verify_args(Tq, H, Kh, M, N=96):
    meta = dict(device="meta")
    i32 = dict(dtype=torch.int32, **meta)
    a = dict(q=torch.empty(Tq, H, 128, dtype=torch.bfloat16, **meta),
             k_pool=torch.empty(N, 16, Kh, 128, dtype=torch.bfloat16,
                                **meta),
             pool_seg=torch.empty(N, 16, **i32),
             pool_pos=torch.empty(N, 16, **i32),
             q_seg=torch.empty(Tq, **i32), q_pos=torch.empty(Tq, **i32),
             block_ids=torch.empty(M, **i32),
             block_owner=torch.empty(M, **i32))
    a["v_pool"] = a["k_pool"]
    return a


def test_split_counter_counts_only_split_calls(monkeypatch):
    """``build.VERIFY_SPLITS`` counts the #1/#4 calls whose plan split a
    segment's entries (where the merge runs): none at the two cells'
    shapes, one a call on chip_smoke's 4096-entry list.  Stubbed card, as
    above."""
    monkeypatch.setattr(paged_attention, "_c_fn",
                        lambda *a: (lambda *args: 0))
    monkeypatch.setattr(build, "check_pools", lambda *a: (1, 1))
    monkeypatch.setattr(build, "sm_count", lambda device: 132)
    monkeypatch.setattr(build, "stream_of", lambda t: 0)
    monkeypatch.setattr(build, "ptr", lambda t: None)
    monkeypatch.setattr(build, "LAUNCHES", collections.Counter())
    monkeypatch.setattr(build, "VERIFY_SPLITS", 0)
    for Tq, H, M in ((640, 40, 1024), (320, 48, 512)):
        fused_paged_verify(**_meta_verify_args(Tq, H, 8, M))
        paged_attention.paged_verify_attention(
            **_meta_verify_args(Tq, H, 8, M))
    assert build.VERIFY_SPLITS == 0
    fused_paged_verify(**_meta_verify_args(42, 32, 32, 4096, N=4100))
    paged_attention.paged_verify_attention(
        **_meta_verify_args(42, 32, 32, 4096, N=4100))
    assert build.VERIFY_SPLITS == 2
    assert build.LAUNCHES == {"fused_paged_verify": 3,
                              "paged_verify_attention": 3}


def _find_tiles(q_seg, span, TQ):
    """The kernel's tile finding (csrc/verify_runs.cuh ``load_window`` and
    ``find_tile``), lane by lane: the tiles (first token, tokens) the
    CTAs of ``span`` tokens start, and the padding tokens they zero."""
    Tq, OUT = len(q_seg), -2**31
    seg_at = lambda i: q_seg[i] if 0 <= i < Tq else OUT  # noqa: E731
    tiles, zeroed = [], []
    for base in range(0, Tq, span):
        w0 = [seg_at(base - 32 + ln) for ln in range(32)]
        w1 = [seg_at(base + ln) for ln in range(32)]
        w2 = [seg_at(base + 32 + ln) for ln in range(32)]
        for j in range(min(span, Tq - base)):
            t, seg = base + j, w1[j]
            if seg < 0:
                zeroed.append(t)
                continue
            b1 = [ln for ln in range(32) if ln < j and w1[ln] != seg]
            b0 = [ln for ln in range(32) if w0[ln] != seg]
            if b1:
                start = base + max(b1) + 1
            elif b0:
                start = base - 32 + max(b0) + 1
            else:
                b = base - 33
                while True:
                    bal = [ln for ln in range(32)
                           if b - ln < 0 or q_seg[b - ln] != seg]
                    if bal:
                        start = b - min(bal) + 1
                        break
                    b -= 32
            if (t - start) % TQ:
                continue
            end = min(t + TQ, Tq)
            e1 = [ln for ln in range(32) if ln > j and w1[ln] != seg]
            e2 = [ln for ln in range(32) if w2[ln] != seg]
            if e1:
                end = min(end, base + min(e1))
            elif e2:
                end = min(end, base + 32 + min(e2))
            else:
                b2 = base + 64
                while b2 < end:
                    e = [ln for ln in range(32) if b2 + ln < end and (
                        b2 + ln >= Tq or q_seg[b2 + ln] != seg)]
                    if e:
                        end = b2 + min(e)
                        break
                    b2 += 32
            tiles.append((t, end - t))
    return tiles, zeroed


def _layout(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "serving":     # 5 tokens a request, idle rows, padding
        return [r for r in range(40) for _ in range(5)] + [-1] * 3
    if kind == "spread":      # the same queries in no order
        q = [r for r in range(40) for _ in range(5)] + [-1] * 3
        return list(rng.permutation(q))
    if kind == "long runs":   # chunked prefill: runs of 1-200 tokens
        return [int(s) for s, n in enumerate(rng.integers(1, 200, 12))
                for _ in range(n)]
    return [int(x) for x in rng.integers(-1, 3, 150)]   # short, repeating


@pytest.mark.parametrize("kind", ["serving", "spread", "long runs", "mixed"])
@pytest.mark.parametrize("span,TQ", [(1, 4), (4, 4), (4, 5), (4, 6),
                                     (4, 16), (4, 64), (1, 64)])
def test_find_tile_covers_every_query_once(kind, span, TQ):
    """By the kernel's rule every query of a segment lies in exactly one
    tile (a run of one segment's tokens cut every TQ tokens from its
    start), whatever the order of the queries, and every padding query
    is zeroed once."""
    q_seg = _layout(kind, seed=TQ * 31 + span)
    tiles, zeroed = _find_tiles(q_seg, span, TQ)
    want = []
    t = 0
    while t < len(q_seg):
        e = t
        while e < len(q_seg) and q_seg[e] == q_seg[t]:
            e += 1
        if q_seg[t] >= 0:
            want += [(s, min(TQ, e - s)) for s in range(t, e, TQ)]
        t = e
    assert sorted(tiles) == want
    assert zeroed == [i for i, x in enumerate(q_seg) if x < 0]


@pytest.mark.parametrize("tree", [False, True])
def test_plain_verify_needs_no_contiguous_segments(tree):
    """The plain version (the kernels' oracle) gives each query the same
    row whether a segment's queries are contiguous or spread over the
    call (the serving path's layout has them contiguous; the kernel tiles
    each run of one segment's tokens on its own)."""
    a = cases.verify_inputs(torch.Generator().manual_seed(5),
                            [37, 5, 90, 20], 4, 8, 4, 32, 16, "f32", tree,
                            shuffle=True, device="cpu")
    want = paged_attention.paged_verify_attention_plain(**a)
    perm = torch.randperm(a["q"].shape[0],
                          generator=torch.Generator().manual_seed(6))
    b = dict(a)
    for k in ("q", "q_seg", "q_pos", "q_anc"):
        if a[k] is not None:
            b[k] = a[k][perm].contiguous()
    assert (a["q_seg"][perm][1:] != a["q_seg"][perm][:-1]).sum() > 8
    got = paged_attention.paged_verify_attention_plain(**b)
    torch.testing.assert_close(got, want[perm], rtol=0, atol=0)


DENSE_GEOMETRIES = [  # B, G, Kh, D, kv bytes
    (6, 1, 32, 128, 2), (6, 1, 32, 128, 4), (1, 6, 8, 128, 2),
    (1, 1, 32, 128, 2), (6, 4, 4, 96, 4), (6, 1, 12, 64, 2),
    (1, 2, 8, 128, 2), (1, 3, 4, 64, 4), (64, 8, 8, 128, 2),
    (3, 1, 7, 96, 2), (1, 16, 1, 128, 4)]
DENSE_S = [0, 1, 31, 32, 33, 250, 256, 2048, 4096, 8192, 100_000]


def _live_runs(length, S, per_run):
    """The runs of a row that do work, and the slots each reads: the
    kernel's rule (csrc/decode_attention.cu), the live prefix min(length,
    S) cut at run_slots = 32 per_run; a row of length 0 is one run of no
    slot."""
    live = min(max(length, 0), S)
    run_slots = per_run * build.KV_TILE
    n = max(1, -(-live // run_slots))
    return [range(z * run_slots, min(live, (z + 1) * run_slots))
            for z in range(n)]


@pytest.mark.parametrize("B,G,Kh,D,kv_bytes", DENSE_GEOMETRIES)
@pytest.mark.parametrize("S", DENSE_S)
def test_dense_decode_plan_covers_every_tile_once(B, G, Kh, D, kv_bytes, S):
    per_run, runs, wpt, stages = decode_attention.run_plan(
        B, S, G, Kh, D, kv_bytes, sms=132)
    tiles = -(-S // build.KV_TILE)
    covered = [t for z in range(runs)
               for t in range(z * per_run, min(tiles, (z + 1) * per_run))]
    assert covered == list(range(tiles))
    assert all(z * per_run < max(tiles, 1) for z in range(runs)), \
        "an empty run"
    assert 1 <= runs <= decode_attention.MAX_RUNS
    # CUDA: grid y and z <= 65535; shared memory: the queries and stages
    assert Kh <= 65535 and runs <= 65535
    _check_pipeline(G, D, kv_bytes, wpt, stages, _align16(4 * G * D))
    # every live slot of a row of any length lies in exactly one live run
    for length in {0, 1, S // 3, S - 1, S, S + 5}:
        spans = _live_runs(length, S, per_run)
        assert len(spans) <= runs
        assert [s for r in spans for s in r] == list(range(min(max(length, 0),
                                                                S)))


def test_dense_decode_row_of_length_zero_is_one_empty_run():
    per_run, runs, _, _ = decode_attention.run_plan(6, 256, 1, 32, 128, 2,
                                                    sms=132)
    assert [list(r) for r in _live_runs(0, 256, per_run)] == [[]]
    per_run, runs, _, _ = decode_attention.run_plan(1, 0, 1, 8, 64, 2,
                                                    sms=132)
    assert runs == 1 and _live_runs(0, 0, per_run) == [range(0)]


@pytest.mark.parametrize("G,Kh", [(6, 8), (1, 8), (1, 32)])
def test_dense_decode_plan_fills_the_card_at_a_long_row(G, Kh):
    """B 1, S 8192: at least one CTA per SM, at most MAX_RUNS runs."""
    per_run, runs, _, _ = decode_attention.run_plan(1, 8192, G, Kh, 128, 2,
                                                    sms=132)
    assert Kh * runs >= 132
    assert runs <= decode_attention.MAX_RUNS


def test_dense_decode_plan_keeps_a_short_grid_whole():
    """The ops path's q (6, 32, 128) over a (6, 256, 32, 128) grid: one run
    per (row, kv head) -- no partials, no merge -- its tiles dealt to four
    teams of one warp."""
    per_run, runs, wpt, _ = decode_attention.run_plan(6, 256, 1, 32, 128, 2,
                                                      sms=132)
    assert runs == 1 and per_run == 8 and wpt == 1


PAGED_GEOMETRIES = [  # B, G, Kh, D, kv bytes
    (6, 1, 16, 96, 2), (1, 6, 8, 128, 2), (1, 1, 32, 128, 2),
    (4, 1, 32, 128, 1), (1, 1, 32, 128, 4), (6, 4, 4, 96, 4),
    (64, 8, 8, 128, 2), (1, 16, 1, 128, 4)]
PAGED_BLOCKS = [0, 1, 3, 4, 17, 129, 514, 2048]


def _table_words(run_slots, bs):
    """The table entries run_slots consecutive slots can touch at any
    offset: csrc/decode_runs.cuh, ``PagedRow::table_words``."""
    return (run_slots + bs - 2) // bs + 1


def _paged_run_slots(length, NB, bs, per_run):
    """The logical slots each live run of a paged row reads, by the
    kernel's rule (csrc/decode_runs.cuh, ``PagedRow`` and
    ``pipe::PagedRowMap``): run z copies the table entries from e0 = z
    run_slots // bs (at most table_words of them, none past NB) and reads
    its slot c through entry (first + c) // bs of that slice, first = z
    run_slots - e0 bs."""
    live = min(max(length, 0), NB * bs)
    run_slots = per_run * build.KV_TILE
    out = []
    for z in range(max(1, -(-live // run_slots))):
        e0 = z * run_slots // bs
        n = min(NB - e0, _table_words(run_slots, bs))
        c = np.arange(max(0, min(run_slots, live - z * run_slots)))
        s = z * run_slots - e0 * bs + c
        e = s // bs
        assert (e < n).all(), "a slot past the run's table slice"
        out.append((e0 + e) * bs + s % bs)
    return out


@pytest.mark.parametrize("B,G,Kh,D,kv_bytes", PAGED_GEOMETRIES)
@pytest.mark.parametrize("bs", [8, 16, 32, 64])
@pytest.mark.parametrize("NB", PAGED_BLOCKS)
def test_paged_decode_plan_covers_every_live_slot_once(B, G, Kh, D,
                                                       kv_bytes, bs, NB):
    """The runs over a row's NB * bs slots cover every 32-slot tile once,
    none empty, at most MAX_RUNS; every live slot of a row of any length
    (ending mid-block, mid-tile, at the table's end) is read once, through
    its own table entry; the stages, the queries and the run's table
    slice fit in shared memory."""
    S = NB * bs
    per_run, runs, wpt, stages = decode_attention.run_plan(
        B, S, G, Kh, D, kv_bytes, sms=132)
    tiles = -(-S // build.KV_TILE)
    covered = [t for z in range(runs)
               for t in range(z * per_run, min(tiles, (z + 1) * per_run))]
    assert covered == list(range(tiles))
    assert all(z * per_run < max(tiles, 1) for z in range(runs)), \
        "an empty run"
    assert 1 <= runs <= decode_attention.MAX_RUNS
    _check_pipeline(G, D, kv_bytes, wpt, stages,
                    _align16(4 * G * D)
                    + _align16(4 * _table_words(per_run * build.KV_TILE,
                                                bs)))
    for length in {0, 1, bs - 1, bs + 1, 33, S // 3, S - 1, S, S + 5}:
        spans = _paged_run_slots(length, NB, bs, per_run)
        assert len(spans) <= runs
        got = np.concatenate(spans) if spans else np.zeros(0, int)
        assert got.tolist() == list(range(min(max(length, 0), S)))


def test_paged_decode_row_of_length_zero_is_one_empty_run():
    """The ops path's shape (B 6, G 1, Kh 16, D 96, 4 blocks of 16) and an
    empty table: a row of length 0 is one run of no slot (it writes
    zeros)."""
    for NB in (4, 0):
        per_run, runs, _, _ = decode_attention.run_plan(
            6, NB * 16, 1, 16, 96, 2, sms=132)
        assert [s.tolist() for s in _paged_run_slots(0, NB, 16, per_run)] \
            == [[]]
    assert runs == 1


def test_paged_decode_sizes_its_call_as_decode_attention(monkeypatch):
    """At the ops path's input (q (6, 16, 96) over 4 blocks of 16) and a
    long row (q (1, 48, 128), GQA 6, over 514 blocks of 16) the paged
    decode takes ``decode_attention.run_plan`` at S = NB * bs and passes
    the same plan as the dense decode over (B, NB * bs, Kh, D); one count
    each under its own name, the float32 partials only with more than one
    run.  The card's pieces are stubbed: meta tensors carry the shapes."""
    plans, calls = [], []
    real = decode_attention.run_plan

    def plan(*a):
        plans.append(real(*a))
        return plans[-1]

    def recorder(n_ptr):
        def fn(*args):
            calls.append((args[:n_ptr], args[n_ptr:]))
            return 0
        return fn

    monkeypatch.setattr(decode_attention, "run_plan", plan)
    monkeypatch.setattr(decode_attention, "_c_fn", lambda: recorder(9))
    monkeypatch.setattr(paged_attention, "_c_fn",
                        lambda source, name, n_ptr, n_int: recorder(n_ptr))
    monkeypatch.setattr(build, "check_pools", lambda *a: (1, 1))
    monkeypatch.setattr(build, "check_dense", lambda *a: (1, 1))
    monkeypatch.setattr(build, "sm_count", lambda device: 132)
    monkeypatch.setattr(build, "stream_of", lambda t: 0)
    monkeypatch.setattr(build, "ptr", lambda t: None if t is None else 1)
    monkeypatch.setattr(build, "_COUNTERS", {})
    monkeypatch.setattr(build, "LAUNCHES", collections.Counter())
    meta = dict(device="meta")
    i32 = dict(dtype=torch.int32, **meta)
    bf16 = dict(dtype=torch.bfloat16, **meta)
    for B, H, Kh, D, NB in ((6, 16, 16, 96, 4), (1, 48, 8, 128, 514)):
        q = torch.empty(B, H, D, **bf16)
        lengths = torch.empty(B, **i32)
        pool = torch.empty(NB * B + 3, 16, Kh, D, **bf16)
        paged_attention.paged_decode_attention(
            q, pool, pool, torch.empty(B, NB, **i32), lengths)
        dense = torch.empty(B, NB * 16, Kh, D, **bf16)
        decode_attention.decode_attention(q, dense, dense, lengths)
    assert plans[0] == plans[1] and plans[2] == plans[3]
    assert plans[0][1] == 2 and plans[2][1] > 1      # runs: both split
    # (ptrs, ints): paged ints B H Kh D bs NB per_run runs wpt stages ...;
    # dense ints B S H Kh D per_run runs wpt stages ...
    for (pp, pi), (dp, di), p in ((calls[0], calls[1], plans[0]),
                                  (calls[2], calls[3], plans[2])):
        assert pi[6:10] == di[5:9] == p
        assert pi[4] * pi[5] == di[1]
        assert pp[7:11] == dp[4:8] == (1, 1, 1, 1)   # partials, counters
    assert build.LAUNCHES == {"paged_decode_attention": 2,
                              "decode_attention": 2}


DECODE_GEOMETRIES = [  # B, T, G, Kh, NB, bs
    (6, 1, 1, 12, 16, 16), (6, 5, 1, 16, 16, 16), (1, 1, 1, 16, 64, 16),
    (6, 1, 1, 16, 8, 32), (6, 1, 1, 16, 32, 8), (1, 64, 1, 32, 8, 16),
    (6, 5, 1, 32, 16, 16), (6, 2, 6, 8, 16, 16), (6, 1, 6, 8, 16, 16),
    (1, 1, 1, 1, 1, 16), (64, 1, 1, 16, 4096, 16), (6, 5, 2, 8, 16, 16)]


@pytest.mark.parametrize("D,kv_bytes", [(64, 2), (96, 2), (128, 4),
                                        (128, 1)])
@pytest.mark.parametrize("B,T,G,Kh,NB,bs", DECODE_GEOMETRIES)
def test_decode_plan_layouts(B, T, G, Kh, NB, bs, D, kv_bytes):
    bq, wpt, stages = decode_plan(B, T, G, Kh, NB, bs, D, kv_bytes, sms=132)
    assert bq == build.query_tile(T, G, B * Kh, 132)
    rows = bq * G
    assert 1 <= rows <= build.MAX_ROWS
    assert B < 2**31 and Kh <= 65535 and -(-T // bq) <= 65535
    if rows >= build.WARPS:              # the row layout, as before
        assert wpt == stages == 0
    else:                                # the split layout
        _check_pipeline(rows, D, kv_bytes, wpt, stages,
                        _align16(4 * NB) + _align16(4 * rows * D))
        assert wpt >= rows, "a warp scores one row"


def test_decode_plan_splits_the_draft_step_over_every_warp():
    """A LLaMA-68M draft step (B 6, T 1, 12 heads, 16 blocks of 16): one
    row per CTA, four teams of one warp, two stages each (8 tiles)."""
    assert decode_plan(6, 1, 1, 12, 16, 16, 64, 2, sms=132) == (1, 1, 2)
    # the catch-up's 480 CTAs are resident at once only at one stage
    assert decode_plan(6, 5, 1, 16, 16, 16, 96, 2, sms=132) == (1, 1, 1)


@pytest.mark.parametrize("D,kv_bytes", [(64, 2), (96, 2), (128, 2),
                                        (128, 4), (96, 1), (36, 2)])
def test_stage_layout_pads_k_rows_to_odd_chunks(D, kv_bytes):
    """32 K rows padded to an odd number of 16-byte chunks (eight lanes'
    16-byte reads fall on distinct banks), 32 V rows in whole chunks, six
    32-word tag arrays."""
    chunks = -(-D * kv_bytes // 16)
    k_row = (build.stage_bytes(D, kv_bytes) - 6 * 32 * 4) // 32 - 16 * chunks
    assert k_row % 16 == 0 and (k_row // 16) % 2 == 1
    assert chunks <= k_row // 16 <= chunks + 1


@pytest.mark.parametrize("D", MMA_HEAD_DIMS)
def test_flash_route_by_dtype(D):
    assert route(torch.bfloat16, D) == "mma"
    assert route(torch.float32, D) == "scalar"


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 80),
                                     (torch.bfloat16, 32),
                                     (torch.float32, 160),
                                     (torch.float16, 128)])
def test_flash_route_rejects(dtype, D):
    with pytest.raises(ValueError, match="flash_attention takes"):
        route(dtype, D)


def _jax(t):
    if t is None:
        return None
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("kv,tree", [("f32", False), ("bf16", False),
                                     ("f32", True)])
def test_plan_layout_verify_matches_reference(kv, tree):
    """Requests of 20, 150 and 5 tokens in 128-cell rows (384 packed cells,
    mostly padding) plus W + 1 = 5 new slots each."""
    a = cases.plan_verify_inputs(torch.Generator().manual_seed(3),
                                 [20, 150, 5], 4, 4, 2, 16, kv, tree,
                                 device="cpu")
    assert a["k"].shape[0] == 4 * 128 + 15
    assert int((a["kv_seg"] >= 0).sum()) == 175 + 15
    got = ops.verify_attention(**a)
    j = {n: _jax(t) for n, t in a.items()}
    want = j_verify(j["q"], j["k"], j["v"], j["q_seg"], j["q_pos"],
                    j["kv_seg"], j["kv_pos"], j["q_anc"], j["kv_node"],
                    bq=8, bk=16, interpret=True)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if kv == "bf16":
        tol = 2.0 ** -6 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                                   rtol=0)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_ptxas_entries_reads_registers_and_spills():
    text = """\
ptxas info    : Compiling entry function '_ZN4spin5flash3mma16flash_mma_kernelILi128EEEvPK13__nv_bfloat16' for 'sm_90a'
ptxas info    : Function properties for _ZN4spin5flash3mma16flash_mma_kernelILi128EEEvPK13__nv_bfloat16
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 198 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN4spin21verify_partial_kernelIffLb1EEEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _ZN4spin21verify_partial_kernelIffLb1EEEvPKT_
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 1552 bytes smem, 400 bytes cmem[0]
"""
    got = build.ptxas_entries(text)
    assert [(e["entry"][:16], e["registers"], e["spill_bytes"],
             e["static_smem"]) for e in got] == [
        ("flash_mma_kernel", 198, 0, 0), ("verify_partial_k", 168, 16, 1552)]
