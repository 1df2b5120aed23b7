"""The dense KV layout on the CPU against the JAX package, at the reduced
shapes of tests/test_engine.py, with weights bridged through
``params.from_jax_numpy`` and the same numpy inputs:

* ``DenseCachePool`` insert / gather / invalidate / evict sequences;
* ``plan_decomposition`` and ``packed_gather``;
* ``make_attn_override`` (packed verify: logits and the written cache;
  the port's kernel runs its plain version here);
* the port's ``SpinEngine`` with ``kv_layout="dense"`` against the JAX
  engine in float32 (packed and ``--no-packed`` verify, chunked prefill):
  the same tokens and the same sim-clock stats, exactly;
* the three dense fallbacks (tree, int8, fused on) and the automatic
  fallback of a sliding-window model;
* the CLI with ``--kv-layout dense``.

Logits and caches: atol = rtol = 1e-4 (two frameworks' float32 matmul
sum orders); everything else exactly."""

import dataclasses
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import registry
from repro.core import decompose as JD
from repro.core import spec_decode as jsd
from repro.core.selector import LBSS as JLBSS
from repro.core.selector import SelectorConfig as JSelectorConfig
from repro.data.workloads import make_workload as j_make_workload
from repro.models import transformer as JT
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import SpinEngine as JSpinEngine
from repro.serving.pool import DenseCachePool as JDensePool
from repro_torch.core import decompose as D
from repro_torch.core import spec_decode as sd
from repro_torch.core.selector import LBSS, SelectorConfig
from repro_torch.data.workloads import make_workload
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import from_jax_numpy
from repro_torch.serving.engine import EngineConfig, SpinEngine
from repro_torch.serving.pool import DenseCachePool

VOCAB = 256
CPU = torch.device("cpu")
TOL = dict(atol=1e-4, rtol=1e-4)


def port_cfg(jcfg):
    return ModelConfig(**dataclasses.asdict(jcfg))


def bridge(jbundle):
    cfg = port_cfg(jbundle.cfg)
    tree = jax.tree.map(np.asarray, jbundle.params)
    return sd.Bundle(cfg, from_jax_numpy(tree, cfg, CPU))


def jax_entry(jcache):
    """The JAX cache's one attention entry, (U, B, S, ...) leaves."""
    return jcache["scan"]["u0_attn"]


# ------------------------------------------------------------------ pool --

@pytest.fixture(scope="module")
def pool_cfgs():
    jcfg = registry.reduced_for("llama-68m", vocab_size=64, n_layers=1)
    return jcfg, port_cfg(jcfg)


def _row_caches(jcfg, cfg, S, L, seed):
    """Identical batch-1 dense caches (random K/V, L valid slots)."""
    rng = np.random.default_rng(seed)
    shape = jax_entry(JT.init_cache(jcfg, 1, S))["k"].shape
    kv = rng.normal(size=shape).astype(np.float32)
    pos = np.where(np.arange(S) < L, np.arange(S), -1)[None, None]
    ent = {"k": kv, "v": -kv, "pos": pos.astype(np.int32),
           "seg": np.where(pos >= 0, 0, -1).astype(np.int32)}
    jc = {"scan": {"u0_attn": {k: jnp.asarray(v) for k, v in ent.items()}}}
    c = T.init_cache(cfg, 1, S, CPU)
    for k, v in ent.items():
        c[k].copy_(torch.from_numpy(v))
    return jc, c


def _same_pool(jp, p):
    assert p.row_of == jp.row_of
    assert p._free == jp._free
    np.testing.assert_array_equal(p.lengths, jp.lengths)
    np.testing.assert_array_equal(p.last_token, jp.last_token)
    jent = jax_entry(jp.cache)
    for leaf, t in p.cache.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(jent[leaf]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dense_pool_sequences_match(pool_cfgs, seed):
    """Insert, insert_empty, row gather and write, invalidate and evict in
    a random order leave the same rows, lengths and grid contents."""
    jcfg, cfg = pool_cfgs
    S = 24
    jp = JDensePool(jcfg, 5, S)
    p = DenseCachePool(cfg, 5, S, device=CPU)
    rng = np.random.default_rng(seed)
    live, nxt = [], 0
    for step in range(30):
        op = rng.choice(["insert", "empty", "row", "invalidate", "evict"])
        if op in ("insert", "empty") and p.free_rows:
            if op == "insert":
                L = int(rng.integers(1, S))
                jc, c = _row_caches(jcfg, cfg, S, L, seed * 100 + step)
                assert p.insert(nxt, c, L, step) == jp.insert(nxt, jc, L,
                                                              step)
            else:
                assert p.insert_empty(nxt) == jp.insert_empty(nxt)
            live.append(nxt)
            nxt += 1
        elif op == "row" and live:
            rid = live[int(rng.integers(len(live)))]
            jrow = jp.row_cache(rid)
            row = p.row_cache(rid)
            for leaf, t in row.items():
                np.testing.assert_array_equal(
                    t.numpy(), np.asarray(jax_entry(jrow)[leaf]))
            # a chunk-append style write: the reference writes the row
            # back, the port's row is a view of the grid
            jc, c = _row_caches(jcfg, cfg, S, int(rng.integers(1, S)),
                                seed * 100 + step + 50)
            jp.write_row(rid, jc)
            for leaf, t in row.items():
                t.copy_(c[leaf])
        elif op == "invalidate":
            rows = sorted(set(rng.integers(0, 5, 2).tolist()))
            jp.invalidate_rows(rows)
            p.invalidate_rows(rows)
        elif op == "evict" and live:
            rid = live.pop(int(rng.integers(len(live))))
            jp.evict(rid)
            p.evict(rid)
        _same_pool(jp, p)


# -------------------------------------------------------- decomposition --

@pytest.mark.parametrize("lens,align,max_rows", [
    ([37, 120, 61], 16, 0), ([5, 5, 1], 8, 2), ([200, 3], 128, 0),
    ([33, 1, 97, 15, 64], 32, 6)])
def test_plan_decomposition_matches(lens, align, max_rows):
    jplan = JD.plan_decomposition(lens, align=align, max_rows=max_rows)
    plan = D.plan_decomposition(lens, align=align, max_rows=max_rows)
    for f in dataclasses.fields(JD.PackPlan):
        np.testing.assert_array_equal(getattr(plan, f.name),
                                      getattr(jplan, f.name))
    assert plan.total == jplan.total and plan.saving == jplan.saving
    assert D.padding_stats(lens, plan) == JD.padding_stats(lens, jplan)


def test_packed_gather_matches():
    """Gather of a random dense entry by a plan whose slots partly lie past
    S (the reference's gather clamps them) and whose source slots are
    partly invalidated."""
    rng = np.random.default_rng(5)
    B, S, Kh, hd = 3, 20, 2, 8
    lens = [7, 20, 13]
    plan = JD.plan_decomposition(lens, align=8,
                                 slot_fn=lambda i, p: p + 3 * (i == 1))
    ent = {"k": rng.normal(size=(B, S, Kh, hd)).astype(np.float32),
           "v": rng.normal(size=(B, S, Kh, hd)).astype(np.float32),
           "pos": np.tile(np.arange(S, dtype=np.int32), (B, 1)),
           "seg": np.where(rng.random((B, S)) < 0.2, -1, 0).astype(np.int32)}
    want = JD.packed_gather({k: jnp.asarray(v) for k, v in ent.items()},
                            jnp.asarray(plan.gather_b),
                            jnp.asarray(plan.gather_s),
                            jnp.asarray(plan.valid))
    got = D.packed_gather({k: torch.from_numpy(v) for k, v in ent.items()},
                          torch.from_numpy(plan.gather_b).long(),
                          torch.from_numpy(plan.gather_s).long(),
                          torch.from_numpy(plan.valid))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -------------------------------------------------------- attn override --

@pytest.fixture(scope="module")
def llm_pair():
    jcfg = registry.reduced_for("llama-7b", d_model=96, n_heads=4,
                                n_kv_heads=2, vocab_size=VOCAB)
    jb = jsd.Bundle(jcfg, JT.init_params(jcfg, jax.random.PRNGKey(0)))
    return jb, bridge(jb)


def test_attn_override_matches(llm_pair):
    """One packed verify step over a dense grid: the logits and the cache
    the override writes back, with an idle row (length 0 -> 1, as the
    engine packs it) and a row whose window runs past the grid's end."""
    jb, b = llm_pair
    W, S = 3, 32
    lens = [9, 0, 17, 29]
    rng = np.random.default_rng(1)
    jcache = JT.init_cache(jb.cfg, len(lens), S)
    cache = T.init_cache(b.cfg, len(lens), S, CPU)
    for i, L in enumerate(lens):
        if not L:
            continue
        toks = rng.integers(0, VOCAB, (1, L)).astype(np.int32)
        _, jc = jb.prefill(jnp.asarray(toks), jnp.asarray([L], jnp.int32), S)
        _, c = b.prefill(torch.from_numpy(toks), torch.tensor([L]), S)
        for leaf, t in cache.items():
            t[:, i] = c[leaf][:, 0]
        jcache = jax.tree.map(lambda a, o: a.at[:, i].set(o[:, 0]), jcache,
                              jc)
    lens_np = np.maximum(np.asarray(lens), 1)
    plan = JD.plan_decomposition(lens_np, align=16)
    q_rows, q_pos, q_seg = JD.build_query_layout(lens_np, W)
    toks = rng.integers(0, VOCAB, (1, len(q_rows))).astype(np.int32)
    want, jcache = JT.verify_step_packed(
        jb.params, jb.cfg, jcache, tokens=jnp.asarray(toks),
        positions=jnp.asarray(q_pos), segments=jnp.asarray(q_seg),
        attn_override=JD.make_attn_override(plan.gather_b, plan.gather_s,
                                            plan.valid, q_rows))
    got, cache = T.verify_step_packed(
        b.params, b.cfg, cache, tokens=torch.from_numpy(toks),
        positions=torch.from_numpy(q_pos), segments=torch.from_numpy(q_seg),
        attn_override=D.make_attn_override(plan.gather_b, plan.gather_s,
                                           plan.valid, q_rows))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for leaf, t in cache.items():
        w = np.asarray(jax_entry(jcache)[leaf])
        if leaf in ("pos", "seg"):
            np.testing.assert_array_equal(t.numpy(), w)
        else:
            np.testing.assert_allclose(t.numpy(), w, **TOL)


# ---------------------------------------------------------------- engine --

@pytest.fixture(scope="module")
def zoo():
    """(JAX llm, JAX ssms, port llm, port ssms) with identical weights."""
    cfg_llm = registry.reduced_for("llama-7b", d_model=96, n_heads=4,
                                   n_kv_heads=4, vocab_size=VOCAB)
    jllm = jsd.Bundle(cfg_llm, JT.init_params(cfg_llm,
                                              jax.random.PRNGKey(0)))
    jssms = []
    for i, (d, L) in enumerate([(32, 1), (64, 2)]):
        c = registry.reduced_for("llama-68m", d_model=d, n_heads=4,
                                 n_kv_heads=4, vocab_size=VOCAB, n_layers=L)
        jssms.append(jsd.Bundle(c, JT.init_params(
            c, jax.random.PRNGKey(i + 1))))
    return jllm, jssms, bridge(jllm), [bridge(b) for b in jssms]


SEL = dict(n_ssms=2, batch_limits=[4, 4], alpha=4, beta=2, seed=1)


def _pair(jllm, jssms, llm, ssms, n_req=4, **case):
    """Run the JAX and the port engine on the same workload; returns both
    engines and the warnings each construction raised."""
    kw = dict(gamma=3, max_len=128, capacity=4, packed_bucket=128,
              straggler_mitigation=False, **case)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jeng = JSpinEngine(jllm, jssms, JLBSS(JSelectorConfig(**SEL)),
                           JEngineConfig(**kw))
    jeng.add_requests(j_make_workload("mix", n_req, VOCAB, seed=3,
                                      scale=0.2))
    jeng.run(max_slots=120)
    with warnings.catch_warnings(record=True) as pw:
        warnings.simplefilter("always")
        eng = SpinEngine(llm, ssms, LBSS(SelectorConfig(**SEL)),
                         EngineConfig(**kw))
    eng.add_requests(make_workload("mix", n_req, VOCAB, seed=3, scale=0.2))
    eng.run(max_slots=120)
    return jeng, eng, [str(w.message) for w in jw], [str(w.message)
                                                     for w in pw]


def _same_run(jeng, eng):
    assert all(r.done for r in eng.requests.values()), "stream must drain"
    assert set(eng.requests) == set(jeng.requests)
    for rid, r in eng.requests.items():
        assert r.emitted == jeng.requests[rid].emitted, rid
    assert eng.accepted_tokens == jeng.accepted_tokens
    assert eng.sim_time == jeng.sim_time
    assert len(eng.slot_log) == len(jeng.slot_log)
    s, js = eng.stats(), jeng.stats()
    for key in ("drafted", "goodput_sim", "verify_tokens", "kv_layout",
                "kv_blocks", "fused_kernels", "kv_dtype", "spec_shape",
                "prefill_tokens", "mean_latency", "p95_latency"):
        assert s[key] == js[key], key
    assert s["kv_layout"] == "dense" and s["kv_blocks"] is None


DENSE_CASES = [dict(use_packed_verify=True), dict(use_packed_verify=False),
               dict(prefill_chunk=8)]


@pytest.mark.parametrize("case", DENSE_CASES, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()))
def test_dense_engine_matches_jax_engine(zoo, case):
    jeng, eng, _, _ = _pair(*zoo, kv_layout="dense", **case)
    _same_run(jeng, eng)


FALLBACKS = {
    "tree": (dict(spec_shape="tree"), "spec_shape", "linear",
             "falling back to linear speculation"),
    "int8": (dict(kv_dtype="int8"), "kv_dtype", "bf16",
             "falling back to bf16"),
    "fused": (dict(fused_kernels="on"), "fused_kernels", "off",
              "falling back to the unfused attention path"),
}


@pytest.mark.parametrize("name", sorted(FALLBACKS))
def test_dense_fallback_warns_as_reference(zoo, name):
    """Each paged-only option under the dense layout warns with the
    reference's message and reports the option as off."""
    jllm, jssms, llm, ssms = zoo
    case, key, value, msg = FALLBACKS[name]
    kw = dict(gamma=3, max_len=128, capacity=4, kv_layout="dense", **case)
    with pytest.warns(UserWarning, match=msg) as pw:
        eng = SpinEngine(llm, ssms, LBSS(SelectorConfig(**SEL)),
                         EngineConfig(**kw))
    with pytest.warns(UserWarning, match=msg) as jw:
        jeng = JSpinEngine(jllm, jssms, JLBSS(JSelectorConfig(**SEL)),
                           JEngineConfig(**kw))
    assert [str(w.message) for w in pw] == [str(w.message) for w in jw]
    assert eng.stats()[key] == jeng.stats()[key] == value


def test_dense_fallbacks_serve_reference_tokens(zoo):
    """Tree + int8 + fused on together under the dense layout: three
    warnings, and the reference's tokens and clock."""
    jeng, eng, jw, pw = _pair(*zoo, kv_layout="dense", spec_shape="tree",
                              kv_dtype="int8", fused_kernels="on")
    assert pw == jw and len(pw) == 3
    _same_run(jeng, eng)


def test_sliding_window_model_falls_back_to_dense(zoo):
    """A sliding-window LLM cannot be paged: the engine goes dense by
    itself, its ring buffer wraps (window 16 < contexts of 22-30) and the
    packed verify takes the windowed plain attention."""
    jllm, jssms, llm, ssms = zoo
    cfg = registry.reduced_for("llama-7b", d_model=96, n_heads=4,
                               n_kv_heads=2, vocab_size=VOCAB,
                               sliding_window=16)
    jwin = jsd.Bundle(cfg, JT.init_params(cfg, jax.random.PRNGKey(9)))
    jeng, eng, _, _ = _pair(jwin, jssms, bridge(jwin), ssms,
                            kv_layout="paged")
    assert eng.stats()["kv_layout"] == "dense"
    _same_run(jeng, eng)


def test_cli_serves_dense_layout(capsys):
    stats = serve.main(["--device", "cpu", "--kv-layout", "dense",
                        "--requests", "4", "--scale", "0.25"])
    assert stats["kv_layout"] == "dense"
    assert stats["scheduler"]["finished"] == 4
    assert '"kv_layout": "dense"' in capsys.readouterr().out
