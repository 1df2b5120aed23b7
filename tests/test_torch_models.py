"""The port's model families against the JAX reference, on the reduced
configs of ``configs/registry.py`` (``reduced_for``: d 64, 4 heads, one unit
twice plus the tail, float32), with parameters bridged from the JAX tree
(``params.from_jax_numpy``) and the same numpy inputs: the full-sequence
forward of every assigned architecture, prefill + decode, the Mamba2 chunked
scan against its own recurrence, and the sliding-window ring buffer.

Tolerance: atol = rtol = 1e-4 on logits of magnitude ~1 (float32; the two
frameworks sum matmuls and scans in other orders), as the port's other
model tests.  zamba2 (twelve Mamba2 blocks around a shared attention block)
is ill-conditioned at this size: the reference's own logits move by 2.5e-2
when its weights are perturbed by a relative 1e-6, so its logits are held
at atol = 5e-3, a fifth of that."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import registry as jregistry
from repro.models import transformer as JT
from repro_torch.configs import registry
from repro_torch.models import mamba2
from repro_torch.models import params as pp
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import from_jax_numpy

# the reference's entry points, compiled once per config and shape
J_APPLY = jax.jit(JT.apply, static_argnums=1)
J_PREFILL = jax.jit(JT.prefill, static_argnums=1,
                    static_argnames=("max_len", "last_logits_only"))
J_DECODE = jax.jit(JT.decode_step, static_argnums=1)
TOL = dict(atol=1e-4, rtol=1e-4)
ILL_CONDITIONED = {"zamba2-1.2b": dict(atol=5e-3, rtol=1e-4)}
CPU = torch.device("cpu")


def bridged(arch, seed, **overrides):
    jcfg = jregistry.reduced_for(arch, **overrides)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    params = from_jax_numpy(jax.tree.map(np.asarray, jparams), cfg, CPU)
    return jcfg, jparams, cfg, params


def inputs(cfg, rng, B, S):
    """Numpy inputs of both frameworks: tokens or frame embeddings, plus
    the VLM prefix."""
    kw = {}
    if cfg.embed_inputs:
        kw["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
    else:
        kw["inputs_embeds"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    if cfg.num_prefix_embeds:
        kw["prefix_embeds"] = rng.standard_normal(
            (B, cfg.num_prefix_embeds, cfg.d_model)).astype(np.float32)
    return kw


def _j(kw):
    return {k: jnp.asarray(v) for k, v in kw.items()}


def _t(kw):
    return {k: torch.from_numpy(v) for k, v in kw.items()}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def test_registry_matches_the_reference():
    """Every field the reference's config has, equal; the port's own
    fields (gated attention, sigmoid routing, per-layer windows: none in
    the reference) at the defaults that leave them off."""
    assert registry.ASSIGNED == jregistry.ASSIGNED
    assert sorted(registry.ARCHS) == sorted(jregistry.ARCHS)
    own = {f.name: f.default for f in dataclasses.fields(ModelConfig)
           if f.name not in {g.name for g in dataclasses.fields(
               type(next(iter(jregistry.ARCHS.values()))))}}
    assert own
    for name, jcfg in jregistry.ARCHS.items():
        for mine, ref in ((registry.get(name), jcfg),
                          (registry.reduced_for(name),
                           jregistry.reduced_for(name))):
            got = dataclasses.asdict(mine)
            assert {k: got.pop(k) for k in own} == own, name
            assert got == dataclasses.asdict(ref), name


@pytest.mark.parametrize("arch", registry.ASSIGNED + ["llama-68m"])
def test_forward_matches(arch):
    """Logits and MoE aux losses of the full-sequence forward; the port's
    own init follows the reference's leaves and shapes."""
    jcfg, jparams, cfg, params = bridged(arch, 0)
    mine = T.init_params(cfg, seed=1, device=CPU)
    assert jax.tree.structure(jax.tree.map(lambda a: 0, mine)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, params))
    assert all(a.shape == b.shape for a, b in zip(
        jax.tree.leaves(mine), jax.tree.leaves(params)))
    kw = inputs(cfg, np.random.default_rng(0), 2, 32)
    jl, (jaux, jz) = J_APPLY(jparams, jcfg, **_j(kw))
    tl, (aux, z) = T.apply(params, cfg, **_t(kw))
    assert tl.shape == (2, 32 + cfg.num_prefix_embeds, cfg.padded_vocab)
    _close(tl, jl, ILL_CONDITIONED.get(arch, TOL))
    _close(aux, jaux)
    _close(z, jz)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mixtral-8x22b", "dbrx-132b",
                                  "xlstm-350m", "zamba2-1.2b",
                                  "musicgen-large", "llama-68m"])
def test_prefill_decode_matches(arch):
    """Prefill 16 positions, then 8 one-token decode steps: every step's
    logits and the recurrent states against the JAX prefill + decode."""
    jcfg, jparams, cfg, params = bridged(arch, 2)
    tol = ILL_CONDITIONED.get(arch, TOL)
    B, S, Pn = 2, 24, 16
    kw = inputs(cfg, np.random.default_rng(1), B, S)
    key = "tokens" if cfg.embed_inputs else "inputs_embeds"
    seq = kw[key]
    jl, jcache = J_PREFILL(jparams, jcfg, max_len=S,
                            **{key: jnp.asarray(seq[:, :Pn])})
    tl, cache = T.prefill(params, cfg, max_len=S,
                          **{key: torch.from_numpy(seq[:, :Pn])})
    _close(tl, jl, tol)
    lengths = np.full((B,), Pn, np.int32)
    for t in range(Pn, S):
        step = seq[:, t:t + 1]
        jl, jcache = J_DECODE(jparams, jcfg, jcache,
                                    lengths=jnp.asarray(lengths),
                                    **{key: jnp.asarray(step)})
        tl, cache = T.decode_step(params, cfg, cache,
                                  lengths=torch.from_numpy(lengths),
                                  **{key: torch.from_numpy(step)})
        _close(tl, jl, tol)
        lengths = lengths + 1
    if arch == "zamba2-1.2b":
        ssd = np.stack([np.asarray(jcache["scan"][f"u{i}_mamba2"].ssd[u])
                        for u in range(cfg.n_units) for i in range(5)]
                       + [np.asarray(jcache[f"tail{i}_mamba2"].ssd)
                          for i in range(2)])
        np.testing.assert_allclose(cache["ssd"].numpy(), ssd, **tol)
    if arch == "xlstm-350m":
        jC = np.asarray(jcache["scan"]["u0_mlstm"].C)
        np.testing.assert_allclose(cache["mlstm_C"].numpy(), jC, **TOL)
        jh = np.asarray(jcache["scan"]["u1_slstm"].h)
        np.testing.assert_allclose(cache["slstm_h"].numpy(), jh, **TOL)


def test_mamba2_chunked_equals_sequential():
    """Inside the port: the chunked SSD scan (chunk 8 over 32 tokens)
    equals the token-by-token recurrence."""
    cfg = registry.reduced_for("zamba2-1.2b")
    gen = torch.Generator().manual_seed(5)
    p = pp.init_params(mamba2.param_spec(cfg), gen, torch.float32, CPU)
    x = torch.randn((2, 32, cfg.d_model), generator=gen) * 0.5
    y_chunk, st_chunk = mamba2.forward(p, x, cfg, chunk=8)
    st, ys = None, []
    for t in range(32):
        y_t, st = mamba2.decode_step(p, x[:, t:t + 1], cfg, st)
        ys.append(y_t)
    np.testing.assert_allclose(y_chunk.numpy(), torch.cat(ys, 1).numpy(),
                               atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(st_chunk.ssd.numpy(), st.ssd.numpy(),
                               atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(st_chunk.conv.numpy(), st.conv.numpy(),
                               atol=1e-4, rtol=1e-3)
    with pytest.raises(ValueError, match="multiple"):
        mamba2.forward(p, x[:, :20], cfg, chunk=8)


def test_sliding_window_ring_buffer_decode():
    """mixtral with a 12-slot window: prefill 8, decode to 40 through the
    ring buffer; each step against the JAX decode and the port's own
    full forward."""
    jcfg, jparams, cfg, params = bridged("mixtral-8x22b", 3,
                                         sliding_window=12)
    B, S, Pn = 2, 40, 8
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S))
    toks = toks.astype(np.int32)
    full, _ = T.apply(params, cfg, tokens=torch.from_numpy(toks))
    _, jcache = J_PREFILL(jparams, jcfg, tokens=jnp.asarray(toks[:, :Pn]),
                           max_len=S)
    _, cache = T.prefill(params, cfg, tokens=torch.from_numpy(toks[:, :Pn]),
                         max_len=S)
    assert cache["k"].shape[2] == 12
    lengths = np.full((B,), Pn, np.int32)
    for t in range(Pn, S):
        step = toks[:, t:t + 1]
        jl, jcache = J_DECODE(jparams, jcfg, jcache,
                                    tokens=jnp.asarray(step),
                                    lengths=jnp.asarray(lengths))
        tl, cache = T.decode_step(params, cfg, cache,
                                  tokens=torch.from_numpy(step),
                                  lengths=torch.from_numpy(lengths))
        _close(tl, jl)
        _close(tl[:, 0], full[:, t].detach().numpy())
        lengths = lengths + 1


def test_last_logits_only_and_paged_refusal():
    """``prefill(last_logits_only=True)`` gives each row's last valid
    position; recurrent models have no paged pool (as in the reference)."""
    jcfg, jparams, cfg, params = bridged("qwen2-0.5b", 4)
    toks = np.random.default_rng(4).integers(0, 500, (2, 10)).astype(
        np.int32)
    lens = np.asarray([10, 6], np.int32)
    jl, _ = J_PREFILL(jparams, jcfg, tokens=jnp.asarray(toks),
                       lengths=jnp.asarray(lens), last_logits_only=True)
    tl, _ = T.prefill(params, cfg, tokens=torch.from_numpy(toks),
                      lengths=torch.from_numpy(lens), last_logits_only=True)
    assert tl.shape == (2, 1, cfg.padded_vocab)
    _close(tl, jl)
    with pytest.raises(ValueError, match="recurrent-state"):
        T.init_paged_cache(registry.reduced_for("zamba2-1.2b"), 4, 8,
                           device=CPU)
