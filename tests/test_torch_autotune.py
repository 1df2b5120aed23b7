"""The port's tile-config cache and tuner (``kernels/autotune.py``) against
the reference's on the CPU, and the configs' way into the fused kernels'
launches (on a stubbed card, as ``test_torch_split.py``)."""

import collections
import json

import numpy as np
import pytest
import torch

from repro.kernels import autotune as jat
from repro_torch.kernels import autotune as at
from repro_torch.kernels import build, fused_decode, fused_verify
from repro_torch.kernels import paged_attention
from repro_torch.kernels.fused_decode import decode_plan
from repro_torch.kernels.paged_attention import verify_plan


def run_plan(Tq, G, Kh, M, bs, D, kv_bytes, sms, config=None):
    """#1's plan with the queries of the pools' float type (float32 pools
    take float32 queries, bf16 and int8/fp8 pools bf16 ones)."""
    return verify_plan(Tq, G, Kh, M, bs, D, 4 if kv_bytes == 4 else 2,
                       kv_bytes, sms, config)

GEOM = dict(H=32, Kh=32, D=128, gamma_max=4, block_size=16)


@pytest.fixture(autouse=True)
def fresh_stats():
    at.CACHE_STATS.update(hits=0, misses=0)
    jat.CACHE_STATS.update(hits=0, misses=0)


@pytest.mark.parametrize("kind,shape,kv", [("verify", "linear", "bf16"),
                                           ("decode", "tree", "int8"),
                                           ("verify", "tree", "fp8")])
def test_tune_key_matches_reference(kind, shape, kv):
    kw = dict(GEOM, shape=shape, kv_dtype=kv)
    assert at.tune_key(kind, device="cpu", **kw) == jat.tune_key(kind, **kw)
    assert at.backend("cpu") == "cpu"


@pytest.mark.parametrize("key", [
    "verify|H32xKh32xD128|g4|bs16|linear|kvbf16|sm90",
    "decode|H12xKh12xD64|g4|bs16|tree|cpu",
    "verify|H4xKh2xD16|g4|bs16|linear|tpu",
    "garbage",
    "verify|H4xKh2|g4|bs16|linear|kvbf16|cpu",
    "mystery|H4xKh2xD16|g4|bs16|linear|kvbf16|cpu"])
def test_migrate_key_matches_reference(key):
    assert at._migrate_key(key) == jat._migrate_key(key)


def test_cache_round_trip_matches_reference(tmp_path):
    raw = {"verify|H4xKh2xD16|g4|bs16|linear|kvbf16|cpu": {"bq": 8},
           "verify|H4xKh2xD16|g4|bs16|linear|cpu": {"bq": 2},
           "decode|H4xKh2xD16|g4|bs16|linear|cpu": {"depth": 2},
           "nonsense": {"bq": 1},
           "verify|H8xKh8xD16|g4|bs16|linear|kvint8|cpu": 5}
    path = tmp_path / "cache.json"
    path.write_text(json.dumps(raw))
    got = at.load_cache(str(path))
    assert got == jat.load_cache(str(path))
    assert got["verify|H4xKh2xD16|g4|bs16|linear|kvbf16|cpu"] == {"bq": 8}
    assert got["decode|H4xKh2xD16|g4|bs16|linear|kvbf16|cpu"] == {
        "depth": 2}
    out = tmp_path / "sub" / "out.json"
    at.save_cache(got, str(out))
    assert at.load_cache(str(out)) == got
    assert at.load_cache(str(tmp_path / "missing.json")) == {}
    (tmp_path / "bad.json").write_text("[1, 2]")
    assert at.load_cache(str(tmp_path / "bad.json")) == {}


def test_lookup_and_get_config_count_hits_and_misses(tmp_path):
    path = str(tmp_path / "c.json")
    key = at.tune_key("verify", device="cpu", **GEOM)
    at.save_cache({key: {"bq": 8, "bk": 16, "depth": 2}}, path)
    assert at.lookup(key, path) == at.FusedConfig(8, 16, 2)
    assert at.get_config("verify", device="cpu", path=path, **GEOM) == \
        at.FusedConfig(8, 16, 2)
    # a cold miss falls back to the default, counted, as the reference
    cold = at.get_config("decode", device="cpu", path=path, **GEOM)
    jcold = jat.get_config("decode", path=str(tmp_path / "j.json"), **GEOM)
    assert cold == at.DEFAULT_CONFIG and jcold == jat.DEFAULT_CONFIG
    assert at.CACHE_STATS == {"hits": 2, "misses": 1}
    assert jat.CACHE_STATS == {"hits": 0, "misses": 1}
    with pytest.raises(ValueError, match="kind"):
        at.get_config("prefill", device="cpu", **GEOM)


@pytest.mark.parametrize("args", [(32, 32, 128, 4, 16), (4, 2, 16, 2, 8),
                                  (48, 8, 128, 0, 32)])
def test_synthetic_pool_matches_reference(args):
    mine = at._synthetic_pool(*args, seed=3)
    ref = jat._synthetic_pool(*args, seed=3)
    for name in ("k_pool", "v_pool", "pool_seg", "pool_pos", "bt", "ids",
                 "owner"):
        np.testing.assert_array_equal(mine[name].numpy(),
                                      np.asarray(ref[name]), err_msg=name)
    np.testing.assert_array_equal(mine["lens"], ref["lens"])
    assert (mine["W"], mine["B"]) == (ref["W"], ref["B"])
    # the generators continue alike (the queries are drawn next)
    assert mine["rng"].standard_normal() == ref["rng"].standard_normal()


@pytest.fixture
def one_thread():
    """MKL may run a product on fewer threads when the host is loaded (other
    test workers), which changes its sums in the last bits from one call
    to the next; on one thread every call of the plain version gives the
    same bits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_no_device_means_the_card(monkeypatch):
    """With no device given the tuner, its keys and its lookup use the
    card; on a host without one they raise, as the port's entry points
    do, and never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    geom = dict(H=4, Kh=2, D=16, gamma_max=2, block_size=8)
    for call in (lambda: at.backend(),
                 lambda: at.tune_key("verify", **geom),
                 lambda: at.get_config("decode", **geom),
                 lambda: at.autotune("verify", **geom)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert at.backend("cpu") == "cpu"


@pytest.mark.parametrize("kind", ["verify", "decode"])
def test_cpu_autotune_round_trip(tmp_path, kind, one_thread):
    """On the CPU every candidate runs the plain version; the winner and
    every trial land in the cache, which the lookup then serves."""
    path = str(tmp_path / "tune.json")
    geom = dict(H=4, Kh=2, D=16, gamma_max=2, block_size=8)
    won = at.autotune(kind, path=path, device="cpu", **geom)
    key = at.tune_key(kind, device="cpu", **geom)
    entry = at.load_cache(path)[key]
    assert entry["candidates"] == len(entry["trials"]) <= at.MAX_CANDIDATES
    assert all(t["max_abs_err"] == 0.0 for t in entry["trials"])
    assert (entry["bq"], entry["bk"], entry["depth"]) == (
        won.bq, won.bk, won.depth)
    assert at.get_config(kind, device="cpu", path=path, **geom) == won
    assert at.CACHE_STATS["hits"] == 1


@pytest.mark.parametrize("c1,c2,kept", [((11.0, 11.0), (20.0, 20.0), 0),
                                        ((9.0, 9.0), (20.0, 20.0), 1),
                                        ((2.0, 13.0), (9.0, 9.0), 2)])
def test_tuner_keeps_a_candidate_only_if_it_beats_the_default_everywhere(
        tmp_path, monkeypatch, c1, c2, kept):
    """On two calls handed to it, the tuner keeps the candidate of the least
    time among those whose median beats the default's fastest call on
    every call; else the default (the timings stubbed: the default 10-14
    µs on each call, candidates 1 and 2 ``c1`` and ``c2`` a call, the rest
    20).  Candidate 1 of the last case is the fastest in sum but slower on
    the second call."""
    geom = dict(H=4, Kh=2, D=16, gamma_max=2, block_size=8)
    call = at.synthetic_call("verify", 4, 2, 16, 2, 8, "linear", "bf16", 0,
                             torch.device("cpu"))
    default = [10.0, 11.0, 12.0, 13.0, 14.0]
    series = [default, default] + [[c] * 5 for c in c1 + c2] \
        + [[20.0] * 5] * (2 * at.MAX_CANDIDATES)
    timed = []

    def times(fn, device):
        timed.append(fn)
        return series[len(timed) - 1]
    monkeypatch.setattr(at, "_times_us", times)
    path = str(tmp_path / "tune.json")
    won = at.autotune("verify", path=path, calls=[call, call], **geom)
    entry = at.load_cache(path)[at.tune_key("verify", device="cpu", **geom)]
    cands = at.candidate_configs("verify", 8, G=2, D=16, kv_bytes=4)
    assert won == cands[kept]
    assert entry["on"] == "calls" and entry["default_min_us"] == 20.0
    assert entry["fastest"]["us"] == min(24.0, sum(c1), sum(c2))
    assert entry["trials"][1]["us_calls"] == list(c1)
    with pytest.raises(ValueError, match="does not belong"):
        at.autotune("verify", path=path, calls=[call],
                    **dict(geom, H=8))


@pytest.mark.parametrize("kind,G,D,kv", [("verify", 1, 128, 2),
                                         ("verify", 6, 128, 2),
                                         ("decode", 1, 64, 2),
                                         ("decode", 1, 96, 1),
                                         ("decode", 6, 128, 2)])
def test_candidates_are_few_and_launch_everywhere(kind, G, D, kv):
    cands = at.candidate_configs(kind, 16, G=G, D=D, kv_bytes=kv)
    assert cands[0] == at.DEFAULT_CONFIG
    assert 2 <= len(cands) <= at.MAX_CANDIDATES
    assert len(set(cands)) == len(cands)
    for cfg in cands:       # every plan the paths make takes them
        if kind == "verify":
            for Tq, M in ((30, 16), (5, 1), (60, 96)):
                run_plan(Tq, G, 32 // G, M, 16, D, kv, 132, cfg)
        else:
            for B, T in ((6, 1), (6, 5), (1, 64), (3, 2)):
                decode_plan(B, T, G, 16, 16, 16, D, kv, 132, cfg)


VERIFY_CALLS = [(30, 1, 32, 16, 16, 128, 2), (30, 6, 8, 16, 16, 128, 2),
                (5, 1, 32, 0, 16, 128, 4), (60, 1, 12, 200, 16, 64, 1),
                (8, 4, 4, 64, 32, 96, 2)]
DECODE_CALLS = [(6, 1, 1, 12, 16, 16, 64, 2), (6, 5, 1, 16, 16, 16, 96, 2),
                (1, 64, 1, 32, 8, 16, 128, 2), (6, 2, 6, 8, 16, 16, 128, 1),
                (64, 1, 1, 16, 4096, 16, 128, 4)]


@pytest.mark.parametrize("call", VERIFY_CALLS)
def test_default_config_is_the_plan_verify(call):
    assert run_plan(*call, 132, at.DEFAULT_CONFIG) == run_plan(*call, 132)
    assert run_plan(*call, 132, None) == run_plan(*call, 132)


@pytest.mark.parametrize("call", DECODE_CALLS)
def test_default_config_is_the_plan_decode(call):
    assert decode_plan(*call, 132, at.DEFAULT_CONFIG) == \
        decode_plan(*call, 132)


def test_overrides_reach_the_plans():
    # verify: entries a chunk a token, stages; unset fields stay the plan's
    base = run_plan(30, 1, 32, 960, 16, 128, 2, 132)
    assert base.chunks == 960 // (30 * paged_attention.SPLIT_ENTRIES) == 4
    got = run_plan(30, 1, 32, 960, 16, 128, 2, 132, at.FusedConfig(bk=4))
    assert got.chunks == 8 and got.stages == base.stages
    got = run_plan(30, 1, 32, 960, 16, 128, 2, 132, at.FusedConfig(depth=1))
    assert got.stages == 1 and got[:7] == base[:7]
    got = run_plan(30, 1, 32, 960, 16, 128, 4, 132, at.FusedConfig(depth=1))
    assert got.stages == 1 and not got.mma
    # decode: a nonzero team size takes the split layout even at 4 rows
    assert decode_plan(1, 64, 1, 32, 8, 16, 128, 2, 132)[1] == 0
    assert decode_plan(1, 64, 1, 32, 8, 16, 128, 2, 132,
                       at.FusedConfig(bq=4, bk=4, depth=2)) == (4, 4, 2)
    assert decode_plan(6, 1, 1, 12, 16, 16, 64, 2, 132,
                       at.FusedConfig(bq=2, bk=2, depth=1)) == (2, 2, 1)


def test_verify_entries_a_chunk_launch_at_every_length():
    """#1's bk is the least list entries a chunk keeps per query token:
    chunks = M // (Tq bk), at least one and at most MAX_CHUNKS, and each
    chunk's list ceil(M / chunks) entries up to LIST_CAP, at every list
    length."""
    cap = paged_attention.MAX_CHUNKS
    assert run_plan(30, 1, 32, 200, 16, 128, 2, 132,
                    at.FusedConfig(bk=4))[2:4] == (1, 200)
    assert run_plan(30, 1, 32, 480, 16, 128, 2, 132,
                    at.FusedConfig(bk=4))[2:4] == (4, 120)
    assert run_plan(30, 1, 32, 1 << 15, 16, 128, 2, 132,
                    at.FusedConfig(bk=1))[2:4] == (cap, 2048)
    assert run_plan(30, 1, 32, 1 << 20, 16, 128, 2, 132,
                    at.FusedConfig(bk=64))[2:4] == (
                        cap, paged_attention.LIST_CAP)


@pytest.mark.parametrize("kind,G,D,kv", [("verify", 1, 128, 2),
                                         ("verify", 6, 128, 2),
                                         ("verify", 1, 128, 4),
                                         ("decode", 1, 96, 2),
                                         ("decode", 6, 128, 1)])
@pytest.mark.parametrize("entries", [2048, 4096, 1 << 14])
def test_every_candidate_plans_long_lists(tmp_path, kind, G, D, kv,
                                          entries):
    """Every config the tuner may offer (the roofline's points too) plans a
    long-context call: a verify list of thousands of live blocks (an engine
    of 1k-context requests passes 512 and more), a decode row of as many
    blocks; at most MAX_CHUNKS chunks, each list at least a scan round's
    share."""
    path = tmp_path / "dryrun.json"
    path.write_text(json.dumps([{"status": "ok",
                                 "roofline": {"dominant": d}}
                                for d in ("memory", "compute")]))
    cands = at.candidate_configs(kind, 16, str(path), G=G, D=D, kv_bytes=kv)
    assert at.roofline_candidates(kind, 16, str(path))
    for cfg in cands:
        if kind == "verify":
            for Tq in (5, 30, 60):
                plan = run_plan(Tq, G, 32 // G, entries, 16, D, kv, 132, cfg)
                assert 1 <= plan.chunks <= paged_attention.MAX_CHUNKS
                assert plan.cap * plan.chunks >= min(
                    entries, paged_attention.SCAN_BATCH)
                assert plan.stages >= 1 and plan.wpt in (
                    (0,) if plan.mma else (1, 2, build.WARPS))
        else:
            for B, T in ((1, 1), (6, 5), (64, 1)):
                decode_plan(B, T, G, 32 // G, entries, 16, D, kv, 132, cfg)


@pytest.mark.parametrize("fn,args,cfg,match", [
    (run_plan, (30, 6, 8, 16, 16, 128, 2, 132), at.FusedConfig(bq=4),
     "query-tile"),
    (run_plan, (30, 1, 32, 16, 16, 128, 2, 132), at.FusedConfig(depth=5),
     "stages"),
    (run_plan, (30, 1, 32, 16, 16, 128, 4, 132), at.FusedConfig(depth=4),
     "budget"),
    (decode_plan, (6, 1, 1, 12, 16, 16, 64, 2, 132),
     at.FusedConfig(bq=8, bk=1, depth=1), "rows"),
    (decode_plan, (6, 1, 1, 12, 16, 16, 64, 2, 132),
     at.FusedConfig(bq=4, depth=2), "row layout"),
    (decode_plan, (6, 1, 1, 12, 16, 16, 64, 2, 132),
     at.FusedConfig(bk=3), "warps a team"),
    (decode_plan, (6, 1, 6, 8, 16, 16, 128, 2, 132),
     at.FusedConfig(bq=3), "rows a CTA")])
def test_infeasible_configs_raise(fn, args, cfg, match):
    with pytest.raises(ValueError, match=match):
        fn(*args, cfg)


def _stub_card(monkeypatch, calls):
    monkeypatch.setattr(build, "check_pools", lambda *a: (1, 1))
    monkeypatch.setattr(build, "sm_count", lambda device: 132)
    monkeypatch.setattr(build, "stream_of", lambda t: 0)
    monkeypatch.setattr(build, "ptr", lambda t: None)
    monkeypatch.setattr(build, "LAUNCHES", collections.Counter())

    def c_fn(source, name, n_ptr, n_int):
        return lambda *args: calls.append((name, args[n_ptr:])) or 0
    monkeypatch.setattr(paged_attention, "_c_fn", c_fn)
    monkeypatch.setattr(fused_decode, "_c_fn",
                        lambda: c_fn("fused_decode", "fused_paged_decode",
                                     11, 12))


def _verify_args(H=32, Kh=32):
    meta = dict(device="meta")
    i32 = dict(dtype=torch.int32, **meta)
    a = dict(q=torch.empty(30, H, 128, dtype=torch.bfloat16, **meta),
             k_pool=torch.empty(96, 16, Kh, 128, dtype=torch.bfloat16,
                                **meta),
             pool_seg=torch.empty(96, 16, **i32),
             pool_pos=torch.empty(96, 16, **i32),
             q_seg=torch.empty(30, **i32), q_pos=torch.empty(30, **i32),
             block_ids=torch.empty(16, **i32),
             block_owner=torch.empty(16, **i32))
    a["v_pool"] = a["k_pool"]
    return a


def _decode_args(B=6, T=1, H=12, D=64):
    meta = dict(device="meta")
    i32 = dict(dtype=torch.int32, **meta)
    a = dict(q=torch.empty(B, T, H, D, dtype=torch.bfloat16, **meta),
             k_pool=torch.empty(96, 16, H, D, dtype=torch.bfloat16, **meta),
             pool_seg=torch.empty(96, 16, **i32),
             pool_pos=torch.empty(96, 16, **i32),
             q_seg=torch.empty(B, T, **i32), q_pos=torch.empty(B, T, **i32),
             block_tables=torch.empty(B, 16, **i32))
    a["v_pool"] = a["k_pool"]
    return a


def test_configs_reach_the_kernels_on_a_stubbed_card(monkeypatch, tmp_path):
    """An empty cache gives the default, and the fused kernels then launch
    exactly the parent's plans (the launch integers without a config); a
    tuned config reaches the launch; ``paged_verify_attention`` (#4), which
    shares #1's kernel, launches its own plan whatever #1 was given."""
    calls = []
    _stub_card(monkeypatch, calls)
    cold = at.get_config("verify", path=str(tmp_path / "none.json"),
                         device="cpu", **GEOM)
    assert cold == at.DEFAULT_CONFIG
    va, da = _verify_args(), _decode_args()
    fused_verify.fused_paged_verify(**va)
    fused_verify.fused_paged_verify(**va, config=cold)
    fused_decode.fused_paged_decode(**da)
    fused_decode.fused_paged_decode(**da, config=cold)
    assert calls[0] == calls[1] and calls[2] == calls[3]
    # the plan's integers: Tq H Kh D bs M | tokens span chunks cap mma heads
    # wpt stages
    assert calls[0][1][6:14] == run_plan(30, 1, 32, 16, 16, 128, 2, 132)[:8]
    assert calls[2][1][7:10] == decode_plan(6, 1, 1, 12, 16, 16, 64, 2, 132)
    calls.clear()
    fused_verify.fused_paged_verify(**va, config=at.FusedConfig(0, 1, 1))
    paged_attention.paged_verify_attention(**va)
    fused_decode.fused_paged_decode(**da, config=at.FusedConfig(2, 2, 1))
    # bk 1: 16 // 30 chunks is still one; depth 1: one stage
    assert calls[0][1][6:14] == (64, 4, 1, 16, 1, 1, 0, 1)
    assert calls[1][1][6:14] == run_plan(30, 1, 32, 16, 16, 128, 2, 132)[:8]
    assert calls[2][1][7:10] == (2, 2, 1)
    assert build.LAUNCHES == {"fused_paged_verify": 3,
                              "paged_verify_attention": 1,
                              "fused_paged_decode": 3}
    with pytest.raises(ValueError, match="query-tile"):
        fused_verify.fused_paged_verify(**va, config=at.FusedConfig(bq=32))
