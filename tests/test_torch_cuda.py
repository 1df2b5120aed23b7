"""The CUDA kernels against their plain versions on the card.  Needs an
NVIDIA card with the CUDA toolkit (the kernels build with nvcc at first
use); without one every test skips.  On the card:
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build, cases, paged_attention
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.fused_decode import (fused_paged_decode,
                                              fused_paged_decode_plain)
from repro_torch.kernels.fused_verify import (fused_paged_verify,
                                              fused_paged_verify_plain)
from repro_torch.kernels.verify_attention import (verify_attention,
                                                  verify_attention_plain)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.Generator().manual_seed(0)


def _check(kernel, plain, name, a):
    before = build.LAUNCHES[name]
    out = kernel(**a)
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == before + 1
    ref = plain(**a)
    # bf16 outputs round an f32 result: one bf16 ulp of the largest value
    tol = (2.0 ** -6 if out.dtype == torch.bfloat16 else 1e-4) * max(
        1.0, ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("kv,tree,G", [
    ("f32", False, 1), ("bf16", True, 2), ("int8", False, 4),
    ("fp8", True, 1)])
def test_fused_verify_matches_plain(gen, kv, tree, G):
    a = cases.verify_inputs(gen, [37, 5, 90], 4, 4 * G, 4, 96, 16, kv, tree)
    _check(fused_paged_verify, fused_paged_verify_plain,
           "fused_paged_verify", a)


# the run-of-entries kernel's edge geometries: block lists in no order
# (owners shuffled, padding entries among them) of 1, 17 and 64 entries,
# block sizes 8 and 32, and the dbrx geometry (H 48, Kh 8, G 6)
@pytest.mark.parametrize("kv,tree,n,bs,H,Kh", [
    ("bf16", False, 1, 16, 32, 32), ("int8", True, 17, 16, 32, 32),
    ("fp8", True, 64, 16, 32, 32), ("bf16", True, None, 8, 32, 32),
    ("int8", False, None, 32, 32, 32), ("f32", True, 17, 16, 32, 32),
    ("bf16", False, None, 16, 48, 8), ("f32", True, None, 16, 48, 8)])
def test_fused_verify_shuffled_entries(gen, kv, tree, n, bs, H, Kh):
    a = cases.verify_inputs(gen, [37, 180, 95, 12, 230, 61], 4, H, Kh, 128,
                            bs, kv, tree, shuffle=True, n_entries=n)
    _check(fused_paged_verify, fused_paged_verify_plain,
           "fused_paged_verify", a)


VERIFY_KERNELS = {
    "fused_paged_verify": (fused_paged_verify, fused_paged_verify_plain),
    "paged_verify_attention": (paged_attention.paged_verify_attention,
                               paged_attention.paged_verify_attention_plain)}
# the benchmark cells' verify geometries: (requests, H, Kh); W + 1 = 5
# tokens a request, contexts 8-256, D 128, block size 16
CELLS = {"qwen2.5-14b": (128, 40, 8), "internlm2-20b": (64, 48, 8)}


@pytest.mark.parametrize("name", sorted(VERIFY_KERNELS))
@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("kv,tree", [
    ("bf16", False), ("bf16", True), ("int8", False), ("int8", True),
    ("fp8", False), ("fp8", True)])
def test_verify_at_the_cells(gen, name, cell, kv, tree):
    """#1 and #4 at the cells' shapes (Qwen: 128 requests x 5 tokens, H 40,
    Kh 8; InternLM2: 64 x 5, H 48, Kh 8; contexts 8-256) on the tensor
    cores: owners shuffled, padding entries among them, idle rows and
    padding queries; one chunk, so no split."""
    n, H, Kh = CELLS[cell]
    lens = torch.randint(8, 257, (n,), generator=gen).tolist()
    a = cases.verify_inputs(gen, lens, 4, H, Kh, 128, 16, kv, tree,
                            shuffle=True)
    splits = build.VERIFY_SPLITS
    _check(*VERIFY_KERNELS[name], name, a)
    assert build.VERIFY_SPLITS == splits


@pytest.mark.parametrize("name", sorted(VERIFY_KERNELS))
@pytest.mark.parametrize("kv,tree", [("bf16", False), ("int8", True),
                                     ("fp8", False)])
def test_verify_four_heads_a_cta(gen, name, kv, tree):
    """G 1 over 40 requests (LLaMA-7B heads): four kv heads a CTA, their
    K/V rows and int8/fp8 scales in one tile."""
    lens = torch.randint(8, 300, (40,), generator=gen).tolist()
    a = cases.verify_inputs(gen, lens, 4, 32, 32, 128, 16, kv, tree,
                            shuffle=True)
    assert paged_attention.verify_plan(
        a["q"].shape[0], 1, 32, a["block_ids"].shape[0], 16, 128, 2,
        a["k_pool"].element_size(), build.sm_count(a["q"].device)).heads == 4
    _check(*VERIFY_KERNELS[name], name, a)


@pytest.mark.parametrize("name", sorted(VERIFY_KERNELS))
@pytest.mark.parametrize("kv,tree", [("bf16", False), ("int8", True)])
def test_verify_splits_a_long_list(gen, name, kv, tree):
    """chip_smoke's long-context call (LLaMA-7B heads, six requests of
    2.5-8k tokens, a list of 4096 entries): the plan splits each segment's
    entries into chunks merged in the launch."""
    a = cases.verify_inputs(gen, [8000, 6500, 5000, 7000, 4500, 2500], 4,
                            32, 32, 128, 16, kv, tree, shuffle=True)
    splits = build.VERIFY_SPLITS
    _check(*VERIFY_KERNELS[name], name, a)
    assert build.VERIFY_SPLITS == splits + 1


@pytest.mark.parametrize("name", sorted(VERIFY_KERNELS))
def test_verify_streams_a_long_segment_in_windows(gen, name):
    """One request of 50k tokens among 105 short ones (a list of 4096
    entries, one chunk): its CTAs' share is longer than a list in shared
    memory holds, so it streams in windows."""
    a = cases.verify_inputs(gen, [50000] + [10] * 105, 4, 8, 8, 64, 16,
                            "bf16", False, shuffle=True)
    splits = build.VERIFY_SPLITS
    _check(*VERIFY_KERNELS[name], name, a)
    assert build.VERIFY_SPLITS == splits


@pytest.mark.parametrize("name", sorted(VERIFY_KERNELS))
@pytest.mark.parametrize("kv,tree", [("bf16", True), ("f32", False)])
def test_verify_segments_need_not_be_contiguous(gen, name, kv, tree):
    """The queries of a call in no order (each segment's tokens spread
    over it): every run of one segment's tokens is a tile of its own."""
    a = cases.verify_inputs(gen, [37, 180, 95, 12, 230, 61, 5, 140], 4, 24,
                            4, 128, 16, kv, tree, shuffle=True)
    perm = torch.randperm(a["q"].shape[0], generator=gen).to(a["q"].device)
    for k in ("q", "q_seg", "q_pos", "q_anc"):
        if a[k] is not None:
            a[k] = a[k][perm].contiguous()
    _check(*VERIFY_KERNELS[name], name, a)


@pytest.mark.parametrize("kv,T,G", [
    ("f32", 5, 1), ("bf16", 1, 2), ("int8", 64, 1), ("fp8", 3, 4)])
def test_fused_decode_matches_plain(gen, kv, T, G):
    a = cases.decode_inputs(gen, [40, 0, 130, 7], T, 4 * G, 4, 64, 16, kv)
    _check(fused_paged_decode, fused_paged_decode_plain,
           "fused_paged_decode", a)


# the split layout (fewer query rows than warps): draft steps over rows
# of 0, 1, 3, 5 and 64 blocks of 16 (B 6 and B 1), block sizes 8 and 32
@pytest.mark.parametrize("lens,H,D,bs,kv", [
    ([0, 15, 47, 79, 1023, 20], 12, 64, 16, "bf16"),
    ([0, 15, 47, 79, 1023, 20], 16, 96, 16, "f32"),
    ([1023], 16, 96, 16, "int8"), ([15], 12, 64, 16, "fp8"),
    ([40, 0, 150, 7, 96, 230], 16, 96, 8, "bf16"),
    ([40, 0, 150, 7, 96, 230], 16, 96, 32, "fp8")])
def test_fused_decode_split_layout(gen, lens, H, D, bs, kv):
    a = cases.decode_inputs(gen, lens, 1, H, H, D, bs, kv)
    _check(fused_paged_decode, fused_paged_decode_plain,
           "fused_paged_decode", a)


def test_wrapper_rejects_bad_inputs(gen):
    a = cases.decode_inputs(gen, [10, 3], 1, 4, 4, 64, 16, "int8")
    with pytest.raises(ValueError, match="k_scale"):
        fused_paged_decode(**{**a, "k_scale": None, "v_scale": None})
    with pytest.raises(ValueError, match="int32"):
        fused_paged_decode(**{**a, "q_pos": a["q_pos"].long()})


@pytest.mark.parametrize("kv,tree,H,Kh,D", [
    ("bf16", False, 32, 32, 128), ("f32", True, 16, 8, 96),
    ("bf16", True, 12, 12, 64), ("f32", False, 8, 1, 64)])
def test_verify_attention_matches_plain(gen, kv, tree, H, Kh, D):
    a = cases.dense_verify_inputs(gen, [37, 5, 90, 1], 4, H, Kh, D, kv,
                                  tree)
    _check(verify_attention, verify_attention_plain, "verify_attention", a)


@pytest.mark.parametrize("kv,tree,H,Kh,D", [
    ("bf16", False, 32, 32, 128), ("f32", False, 32, 32, 128),
    ("bf16", True, 16, 8, 96), ("f32", True, 12, 12, 64)])
def test_verify_attention_split_kv(gen, kv, tree, H, Kh, D):
    """Many tiles: ~2000 slots in the dense plan's 128-cell rows (mostly
    padding), and contexts up to 230 tokens interleaved."""
    lens = [20, 35, 230, 12, 100, 77, 5, 150, 60, 210, 31, 8]
    a = cases.plan_verify_inputs(gen, lens, 4, H, Kh, D, kv, tree)
    _check(verify_attention, verify_attention_plain, "verify_attention", a)
    a = cases.dense_verify_inputs(gen, [37, 180, 95, 12, 230, 61], 4, H, Kh,
                                  D, kv, tree)
    _check(verify_attention, verify_attention_plain, "verify_attention", a)


@pytest.mark.parametrize("kv,H,Kh,D", [
    ("bf16", 32, 32, 128), ("f32", 16, 4, 96), ("bf16", 12, 12, 64)])
def test_decode_attention_matches_plain(gen, kv, H, Kh, D):
    a = cases.dense_decode_inputs(gen, [0, 37, 250, 131, 1], 250, H, Kh, D,
                                  kv)
    _check(decode_attention, decode_attention_plain, "decode_attention", a)


# rows split over runs of tiles: long rows at B = 1 (LLaMA-7B's heads,
# GQA group 6 at Kh 8, float32), and unequal rows whose runs past the
# length exit (0, 1, 700 and 2048 live slots)
@pytest.mark.parametrize("kv,lens,S,H,Kh", [
    ("bf16", [4001], 4096, 32, 32), ("bf16", [8190], 8192, 48, 8),
    ("f32", [1999], 2048, 32, 32), ("bf16", [0, 1, 700, 2048], 2048, 32, 32),
    ("f32", [0, 1, 700, 2048], 2048, 16, 4)])
def test_decode_attention_long_rows(gen, kv, lens, S, H, Kh):
    a = cases.dense_decode_inputs(gen, lens, S, H, Kh, 128, kv)
    _check(decode_attention, decode_attention_plain, "decode_attention", a)


@pytest.mark.parametrize("kv,G", [("bf16", 1), ("int8", 2), ("fp8", 4),
                                  ("f32", 1)])
def test_paged_decode_attention_matches_plain(gen, kv, G):
    a = cases.paged_decode_inputs(gen, [40, 0, 150, 7, 96], 4 * G, 4, 96,
                                  16, kv)
    _check(paged_attention.paged_decode_attention,
           paged_attention.paged_decode_attention_plain,
           "paged_decode_attention", a)


# the run-of-tiles kernel over a block pool: long rows at B = 1 (LLaMA-7B's
# heads, GQA 6 at Kh 8, float32), unequal int8 rows whose runs past the
# length exit, block sizes 8 (fp8) and 64 (bf16) with rows ending
# mid-block and mid-tile, LLaMA-616M's draft rows (D 96)
@pytest.mark.parametrize("kv,lens,H,Kh,D,bs", [
    ("bf16", [4001], 32, 32, 128, 16), ("bf16", [8190], 48, 8, 128, 16),
    ("f32", [1999], 32, 32, 128, 16),
    ("int8", [0, 1, 700, 2048], 32, 32, 128, 16),
    ("fp8", [0, 37, 700, 2047], 32, 32, 128, 8),
    ("bf16", [63, 0, 700, 4095], 48, 8, 128, 64),
    ("bf16", [0, 15, 47, 79, 1023, 20], 16, 16, 96, 16)])
def test_paged_decode_attention_long_rows(gen, kv, lens, H, Kh, D, bs):
    a = cases.paged_decode_inputs(gen, lens, H, Kh, D, bs, kv)
    _check(paged_attention.paged_decode_attention,
           paged_attention.paged_decode_attention_plain,
           "paged_decode_attention", a)


def test_paged_decode_attention_reads_block_0_for_a_hole(gen):
    """An unallocated entry (-1) inside a live prefix reads physical block
    0, as the reference's index map does."""
    a = cases.paged_decode_inputs(gen, [700, 33], 16, 16, 96, 16, "bf16")
    a["block_tables"][0, 3] = -1
    _check(paged_attention.paged_decode_attention,
           paged_attention.paged_decode_attention_plain,
           "paged_decode_attention", a)


@pytest.mark.parametrize("kv,tree,G", [
    ("bf16", False, 1), ("int8", True, 2), ("fp8", False, 4),
    ("f32", True, 1)])
def test_paged_verify_attention_matches_plain(gen, kv, tree, G):
    a = cases.verify_inputs(gen, [37, 5, 90], 4, 4 * G, 4, 64, 16, kv, tree)
    _check(paged_attention.paged_verify_attention,
           paged_attention.paged_verify_attention_plain,
           "paged_verify_attention", a)


# block lists in no order (owners shuffled, padding among them) of 1,
# 17 and 64 entries; block sizes 8 and 32
@pytest.mark.parametrize("kv,tree,n,bs", [
    ("bf16", False, 1, 16), ("int8", True, 17, 16), ("fp8", True, 64, 16),
    ("bf16", True, None, 8), ("int8", False, None, 32),
    ("f32", True, 17, 16)])
def test_paged_verify_attention_shuffled_entries(gen, kv, tree, n, bs):
    a = cases.verify_inputs(gen, [37, 180, 95, 12, 230, 61], 4, 32, 32, 128,
                            bs, kv, tree, shuffle=True, n_entries=n)
    _check(paged_attention.paged_verify_attention,
           paged_attention.paged_verify_attention_plain,
           "paged_verify_attention", a)


@pytest.mark.parametrize("kv,S,H,Kh,D,window", [
    ("bf16", 200, 8, 8, 64, 0), ("f32", 200, 12, 2, 96, 0),
    ("bf16", 333, 14, 2, 128, 100), ("f32", 77, 4, 4, 128, 32),
    ("bf16", 130, 48, 8, 128, 64)])
def test_flash_attention_matches_plain(gen, kv, S, H, Kh, D, window):
    """Causal and windowed prefill, G = 1, 6 and 7, S not a multiple of
    the tile."""
    a = cases.flash_inputs(gen, 2, S, H, Kh, D, kv, window)
    _check(flash_attention, flash_attention_plain, "flash_attention", a)


@pytest.mark.parametrize("S,H,Kh,D,window", [
    (200, 8, 8, 64, 0), (45, 6, 1, 64, 7), (130, 56, 8, 96, 0),
    (333, 64, 8, 128, 32), (63, 32, 32, 128, 0), (64, 7, 1, 96, 0),
    (1, 48, 8, 128, 0), (257, 48, 8, 128, 7), (100, 16, 16, 96, 32)])
def test_flash_attention_bf16_tensor_cores(gen, S, H, Kh, D, window):
    """The tensor-core kernel (bf16): D 64 / 96 / 128, G 1 / 6 / 7 / 8,
    S below one 64-key tile and not a multiple of it, windows narrower
    than a tile, B = 2."""
    a = cases.flash_inputs(gen, 2, S, H, Kh, D, "bf16", window)
    _check(flash_attention, flash_attention_plain, "flash_attention", a)


def test_dense_engine_launches_verify_attention(gen):
    """One dense-layout serving run on the card (reduced zoo): every
    request finishes and every packed verify layer launched the kernel."""
    from repro_torch.launch.serve import build_zoo, make_selector
    from repro_torch.data.workloads import make_workload
    from repro_torch.serving.engine import EngineConfig, SpinEngine

    llm, ssms = build_zoo(256, 0, 3, "cuda")
    reqs = make_workload("mix", 4, 256, seed=0, scale=0.25)
    sel = make_selector("lbss", len(ssms), 4)
    eng = SpinEngine(llm, ssms, sel, EngineConfig(capacity=4,
                                                  kv_layout="dense"))
    eng.add_requests(reqs)
    build.LAUNCHES.clear()
    stats = eng.run(max_slots=200)
    assert stats["kv_layout"] == "dense"
    assert all(r.done for r in eng.requests.values())
    verified = sum(1 for rec in eng.slot_log if rec.get("active"))
    assert build.LAUNCHES["verify_attention"] == \
        verified * llm.cfg.n_layers > 0


def test_router_over_two_cuda_engines(gen):
    """A two-replica fleet on the card (reduced zoo, paged KV, fused
    kernels, built as the serve launcher builds one): every request
    finishes, both replicas serve, and the fleet launched both fused
    kernels."""
    from repro_torch.data.workloads import make_workload
    from repro_torch.launch.serve import build_fleet, build_zoo
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.router import Router, RouterConfig

    llm, ssms = build_zoo(256, 0, 3, "cuda")
    reqs = make_workload("mix", 6, 256, seed=0, scale=0.25,
                         arrival_rate=300.0)
    engines = build_fleet(llm, ssms, reqs, EngineConfig(
        capacity=6, fused_kernels="on"), ["general", "general"])
    router = Router(engines, RouterConfig(policy="p2c", steal="on"))
    router.submit(reqs)
    build.LAUNCHES.clear()
    stats = router.run(max_slots=400)
    assert stats["finished"] == 6
    assert all(n > 0 for n in stats["dispatched"])
    assert build.LAUNCHES["fused_paged_verify"] > 0
    assert build.LAUNCHES["fused_paged_decode"] > 0


def test_train_step_on_cuda(gen):
    """One training step of a reduced qwen2 on the card: a finite loss
    that falls on a second step over the same batch."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamW

    cfg = dataclasses.replace(registry.reduced_for("qwen2-0.5b"),
                              dtype="float32")
    params = T.init_params(cfg, 0, device="cuda")
    opt = AdamW(lr=1e-3)
    step = T.make_train_step(cfg, opt, T.Opts(remat="dots"))
    toks = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen)
    batch = {"tokens": toks.cuda(), "labels": toks.roll(-1, 1).cuda()}
    state = opt.init(params)
    params, state, m0 = step(params, state, batch)
    params, state, m1 = step(params, state, batch)
    assert torch.isfinite(m0["loss"]) and float(m1["loss"]) < float(m0["loss"])


@pytest.mark.parametrize("name", sorted(VERIFY_KERNELS))
@pytest.mark.parametrize("kv", ["bf16", "f32"])
def test_verify_window(gen, name, kv):
    """#1 and #4 under a window at Trinity-Mini's geometry (D 128, H 32,
    Kh 4: GQA 8), contexts on both sides of it (window 64, contexts
    12-300), on the tensor cores (bf16) and the CUDA cores (f32)."""
    lens = [12, 300, 63, 64, 65, 150, 40, 230]
    a = cases.verify_inputs(gen, lens, 4, 32, 4, 128, 16, kv, False,
                            shuffle=True)
    a["window"] = 64
    _check(*VERIFY_KERNELS[name], name, a)
    # the term binds: the window's output is not the full one's
    full = VERIFY_KERNELS[name][0](**{**a, "window": 0}).float()
    assert (full - VERIFY_KERNELS[name][0](**a).float()).abs().max() > 1e-2


@pytest.mark.parametrize("T,H,Kh", [(1, 12, 12), (5, 32, 4), (16, 32, 4)])
def test_fused_decode_window(gen, T, H, Kh):
    """#2 under a window (64) in both layouts (the split one at one query
    token, the row one at 5 and 16), D 128, rows on both sides of it."""
    a = cases.decode_inputs(gen, [40, 0, 130, 300], T, H, Kh, 128, 16,
                            "bf16")
    a["window"] = 64
    _check(fused_paged_decode, fused_paged_decode_plain,
           "fused_paged_decode", a)


@pytest.mark.parametrize("T,dt,shape", [
    (1, "bfloat16", None), (95, "bfloat16", None), (640, "bfloat16", None),
    (95, "float32", None), (33, "bfloat16", (200, 72, 8, 2)),
    (33, "float32", (200, 72, 8, 2))])
def test_moe_experts_matches_plain(gen, T, dt, shape):
    """The grouped experts at Trinity-Mini's widths (d 2048, ff 1024, 128
    experts, top-8) for 1, 95 and 640 tokens, and at widths that end in
    part of a 64-wide tile (d 200, ff 72, 8 experts, top-2), against the
    plain version (the same rounding of the SwiGLU to the input type,
    float32 sums); float32 on the CUDA cores, without TF32."""
    from repro_torch.kernels import moe_experts as K
    d, ff, E, k = shape or (2048, 1024, 128, 8)
    dev, dt = torch.device("cuda"), getattr(torch, dt)
    x = torch.randn(T, d, generator=gen).to(dev, dt)
    ids = torch.stack([torch.randperm(E, generator=gen)[:k]
                       for _ in range(T)]).to(dev)
    w = torch.rand(T, k, generator=gen).to(dev)
    ws = [(torch.randn(E, d, ff, generator=gen) / d ** 0.5).to(dev, dt)
          for _ in range(2)]
    wd = (torch.randn(E, ff, d, generator=gen) / ff ** 0.5).to(dev, dt)
    before = build.LAUNCHES[K.NAME]
    got = K.moe_experts(x, ids, w, *ws, wd)
    torch.cuda.synchronize()
    assert build.LAUNCHES[K.NAME] == before + 1
    want = K.moe_experts_plain(x, ids, w, *ws, wd)
    # the kernel and the plain version sum in float32 in other orders, and
    # a SwiGLU value may round to the neighbouring bf16: a few bf16 ulps of
    # the largest output; in float32 sums of 2048 terms in another order
    # (TF32 would miss by ~1e-3)
    tol = (2.0 ** -5 if dt == torch.bfloat16 else 1e-5) * max(
        1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= tol
