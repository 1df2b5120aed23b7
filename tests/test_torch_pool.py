"""The port's PagedCachePool against the JAX pool: the same sequence of
admissions, growth, CoW forks, copies, renames, rollbacks and evictions
must leave the same block tables, refcounts, free lists, live-block lists
and pool contents."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.configs import registry
from repro.models import transformer as JT
from repro.serving.pool import PagedCachePool as JPool
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.serving.pool import PagedCachePool

CPU = torch.device("cpu")
BS = 4


@pytest.fixture(scope="module")
def cfgs():
    jcfg = registry.reduced_for("llama-68m", vocab_size=64, n_layers=1)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _prefilled(jcfg, cfg, L, seed):
    """Identical batch-1 dense caches for both pools (random K/V)."""
    S = BS * -(-L // BS)
    jc = JT.init_cache(jcfg, 1, S)
    rng = np.random.default_rng(seed)
    kv = rng.normal(size=jc["scan"]["u0_attn"]["k"].shape).astype(np.float32)
    pos = np.where(np.arange(S) < L, np.arange(S), -1)[None, None]
    seg = np.where(pos >= 0, 0, -1)
    ent = {"k": kv, "v": -kv, "pos": pos.astype(np.int32),
           "seg": seg.astype(np.int32)}
    jc = {"scan": {"u0_attn": {k: jnp.asarray(v) for k, v in ent.items()}}}
    c = T.init_cache(cfg, 1, S, CPU)
    for k, v in ent.items():
        c[k].copy_(torch.from_numpy(v))
    return jc, c


def _same(jp, p):
    np.testing.assert_array_equal(p._table, jp._table)
    np.testing.assert_array_equal(p._nb, jp._nb)
    np.testing.assert_array_equal(p._ref, jp._ref)
    assert p._free_blocks == jp._free_blocks
    assert p._free_rows == jp._free_rows
    assert p.row_of == jp.row_of
    np.testing.assert_array_equal(p.lengths, jp.lengths)
    for a, b in zip(p.live_blocks(), jp.live_blocks()):
        np.testing.assert_array_equal(a, b)
    assert p.free_blocks + p.allocated_blocks == p.num_blocks
    # pool contents on every live block (freed blocks hold stale data)
    live = sorted(set(p._table[p._table >= 0].tolist()))
    jent = jp.cache["scan"]["u0_attn"]
    for leaf, t in p.cache.items():
        want = np.asarray(jent[leaf], np.float32)[:, live]
        # scales: XLA compiles amax / qmax as a reciprocal multiply (1 ulp)
        rtol = 1e-6 if leaf.endswith("_scale") else 0
        np.testing.assert_allclose(t.float().numpy()[:, live], want,
                                   rtol=rtol, atol=0)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("seed", [0, 1])
def test_pool_sequences_match(cfgs, kv_dtype, seed):
    jcfg, cfg = cfgs
    jp = JPool(jcfg, 6, 32, BS, num_blocks=40, kv_dtype=kv_dtype)
    p = PagedCachePool(cfg, 6, 32, BS, num_blocks=40, kv_dtype=kv_dtype,
                       device=CPU)
    rng = np.random.default_rng(seed)
    live, nxt = [], 0
    for step in range(40):
        op = rng.choice(["insert", "ensure", "fork", "evict", "span"])
        if op == "insert" and p.free_rows and p.can_admit(20):
            L = int(rng.integers(1, 14))
            jc, c = _prefilled(jcfg, cfg, L, seed * 100 + step)
            jp.insert(nxt, jc, L, 7)
            p.insert(nxt, c, L, 7)
            live.append(nxt)
            nxt += 1
        elif op == "ensure" and live:
            rid = live[int(rng.integers(len(live)))]
            need = int(p.lengths[p.row_of[rid]]) + int(rng.integers(1, 6))
            if p.blocks_needed(need) - p._nb[p.row_of[rid]] <= p.free_blocks:
                jp.ensure_rows({rid: need})
                p.ensure_rows({rid: need})
        elif op == "fork" and live and p.free_rows:
            rid = live[int(rng.integers(len(live)))]
            brid = ("~branch", rid, step)
            jp.fork(rid, brid)
            p.fork(rid, brid)
            L = int(p.lengths[p.row_of[rid]])
            if p.free_blocks >= 4:
                assert (p.cow_prepare(brid, L, L + 5)
                        == jp.cow_prepare(brid, L, L + 5))
                assert p.cow_prepare(rid, L, L + 5) == \
                    jp.cow_prepare(rid, L, L + 5)
            if rng.random() < 0.5:       # the branch wins: adopt it
                jp.evict(rid)
                p.evict(rid)
                jp.rename(brid, rid)
                p.rename(brid, rid)
            else:
                jp.evict(brid)
                p.evict(brid)
        elif op == "evict" and live:
            rid = live.pop(int(rng.integers(len(live))))
            jp.evict(rid)
            p.evict(rid)
        elif op == "span" and live:
            lo = np.asarray(p.lengths, np.int64) - rng.integers(0, 3, 6)
            lo = np.maximum(lo, 0)
            hi = lo + 3
            jp.invalidate_span(jnp.asarray(lo, jnp.int32),
                               jnp.asarray(hi, jnp.int32), W=3)
            p.invalidate_span(lo, hi, W=3)
        _same(jp, p)
        for a, b in zip(p.block_table_array(), jp.block_table_array()):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert nxt > 0
    if live:
        rid = live[0]
        np.testing.assert_array_equal(p.row_table(rid).numpy(),
                                      np.asarray(jp.row_table(rid)))
