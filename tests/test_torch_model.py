"""The port's dense model stack and paged steps against the JAX reference,
with parameters bridged from the JAX tree (``params.from_jax_numpy``) and
the same numpy tokens: prefill / decode_step logits, and the paged decode /
packed-verify steps with the gather overrides and with the fused overrides
(JAX: Pallas in interpret mode; port: the kernels' plain versions).
float32, atol = rtol = 1e-4 (two frameworks' matmul sum orders)."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import registry
from repro.core import decompose as JD
from repro.kernels import autotune as jautotune
from repro.models import transformer as JT
from repro.serving import paged as jpaged
from repro.serving.pool import PagedCachePool as JPool
from repro_torch.core import decompose as D
from repro_torch.kernels import autotune
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import from_jax_numpy
from repro_torch.serving import paged
from repro_torch.serving.pool import PagedCachePool

TOL = dict(atol=1e-4, rtol=1e-4)
VOCAB = 300            # padded to 512: exercises the vocab-padding columns
CPU = torch.device("cpu")

CONFIGS = {
    "llama-7b": {},
    "llama-68m-gqa": {"n_kv_heads": 2},
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    name = request.param.replace("-gqa", "")
    jcfg = registry.reduced_for(name, vocab_size=VOCAB,
                                **CONFIGS[request.param])
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(7))
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    params = from_jax_numpy(jax.tree.map(np.asarray, jparams), cfg, CPU)
    return jcfg, jparams, cfg, params


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_init_params_follow_the_reference_spec(pair):
    """Same leaves and shapes as the JAX tree (layers unstacked), and the
    reference's init scale: fan_in = shape[-2] (the head count for wq)."""
    jcfg, jparams, cfg, params = pair
    mine = T.init_params(cfg, seed=3, device=CPU)
    assert set(mine) == set(params)
    for name, a in jparams["scan"]["u0_attn"].items():
        for layer in range(cfg.n_layers):
            assert mine["layers"][layer][name].shape == a.shape[1:], name
    wq = mine["layers"][0]["wq"].float()
    assert abs(float(wq.std()) - 1.0 / np.sqrt(cfg.n_heads)) < 0.05
    assert torch.all(mine["layers"][0]["ln1"] == 0)


def test_prefill_and_decode_logits_match(pair):
    jcfg, jparams, cfg, params = pair
    rng = np.random.default_rng(0)
    toks = rng.integers(0, VOCAB, size=(2, 12)).astype(np.int32)
    lens = np.asarray([12, 7], np.int32)
    jl, jcache = JT.prefill(jparams, jcfg, tokens=jnp.asarray(toks),
                            lengths=jnp.asarray(lens), max_len=24)
    tl, cache = T.prefill(params, cfg, tokens=torch.from_numpy(toks),
                          lengths=torch.from_numpy(lens), max_len=24)
    _close(tl, jl)
    new = rng.integers(0, VOCAB, size=(2, 3)).astype(np.int32)
    jl2, _ = JT.decode_step(jparams, jcfg, jcache, tokens=jnp.asarray(new),
                            lengths=jnp.asarray(lens))
    tl2, cache = T.decode_step(params, cfg, cache,
                               tokens=torch.from_numpy(new),
                               lengths=torch.from_numpy(lens))
    _close(tl2, jl2)


def _pools(jcfg, jparams, cfg, params, prompts, bs, kv_dtype):
    """The same prompts admitted into a JAX and a port paged pool."""
    jpool = JPool(jcfg, len(prompts), 64, bs, kv_dtype=kv_dtype)
    pool = PagedCachePool(cfg, len(prompts), 64, bs, kv_dtype=kv_dtype,
                          device=CPU)
    for rid, p in enumerate(prompts):
        L = len(p)
        row = np.zeros((1, 16 * -(-L // 16)), np.int32)
        row[0, :L] = p
        plen = pool.prefill_len(row.shape[1])
        _, jc = JT.prefill(jparams, jcfg, tokens=jnp.asarray(row),
                           lengths=jnp.asarray([L], jnp.int32), max_len=plen)
        _, c = T.prefill(params, cfg, tokens=torch.from_numpy(row),
                         lengths=torch.tensor([L], dtype=torch.int32),
                         max_len=plen)
        jpool.insert(rid, jc, L, int(p[-1]))
        pool.insert(rid, c, L, int(p[-1]))
    assert (pool._table == jpool._table).all()
    return jpool, pool


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("fused", [False, True])
def test_paged_steps_match(pair, fused, kv_dtype):
    jcfg, jparams, cfg, params = pair
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, VOCAB, size=n).astype(np.int32)
               for n in (13, 30, 5)]
    bs, W = 8, 3
    jpool, pool = _pools(jcfg, jparams, cfg, params, prompts, bs, kv_dtype)
    jfc = jautotune.DEFAULT_CONFIG if fused else None
    fc = autotune.DEFAULT_CONFIG if fused else None
    lens = np.asarray(pool.lengths, np.int32)
    for p in (jpool, pool):
        p.ensure_rows({rid: int(lens[rid]) + W + 2 for rid in range(3)})

    # packed verify: every row's [last, c_1..c_W]
    inp = rng.integers(0, VOCAB, size=(3, W + 1)).astype(np.int32)
    q_rows, q_pos, q_seg = D.build_query_layout(lens, W)
    jq = JD.build_query_layout(lens, W)
    assert all((a == b).all() for a, b in zip(jq, (q_rows, q_pos, q_seg)))
    ids, owner = pool.live_blocks()
    jbt, _ = jpool.block_table_array()
    bt, _ = pool.block_table_array()
    jl, jpool.cache = jpaged.verify_step_paged(
        jparams, jcfg, jpool.cache, tokens=jnp.asarray(inp.reshape(1, -1)),
        positions=jnp.asarray(q_pos), segments=jnp.asarray(q_seg),
        q_rows=jnp.asarray(q_rows), block_tables=jbt,
        block_ids=jnp.asarray(ids), block_owner=jnp.asarray(owner),
        fused_cfg=jfc)
    tl, pool.cache = paged.verify_step_paged(
        params, cfg, pool.cache, tokens=torch.from_numpy(inp.reshape(1, -1)),
        positions=torch.from_numpy(q_pos), segments=torch.from_numpy(q_seg),
        q_rows=torch.from_numpy(q_rows), block_tables=bt,
        block_ids=torch.from_numpy(ids), block_owner=torch.from_numpy(owner),
        fused_cfg=fc)
    _close(tl, jl)
    for leaf in ("pos", "seg"):
        np.testing.assert_array_equal(
            pool.cache[leaf].numpy(),
            np.asarray(jpool.cache["scan"]["u0_attn"][leaf]))

    # rollback, then a padded decode step over the same rows (T = W + 1)
    nacc = np.asarray([0, 2, 3])
    for p in (jpool, pool):
        p.invalidate_span(lens + 1 + nacc, lens + W + 1, W=W)
    np.testing.assert_array_equal(
        pool.cache["seg"].numpy(),
        np.asarray(jpool.cache["scan"]["u0_attn"]["seg"]))
    new = rng.integers(0, VOCAB, size=(3, W + 1)).astype(np.int32)
    lens2 = lens + 1 + nacc.astype(np.int32)
    jbt, _ = jpool.block_table_array()
    bt, _ = pool.block_table_array()
    jl2, _ = jpaged.decode_step_paged(
        jparams, jcfg, jpool.cache, tokens=jnp.asarray(new),
        lengths=jnp.asarray(lens2), block_tables=jbt, fused_cfg=jfc)
    tl2, _ = paged.decode_step_paged(
        params, cfg, pool.cache, tokens=torch.from_numpy(new),
        lengths=torch.from_numpy(lens2), block_tables=bt, fused_cfg=fc)
    _close(tl2, jl2)
