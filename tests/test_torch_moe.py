"""The port's MoE FFN and the serving engine on the registry's families,
against the JAX package on the same numpy inputs and bridged float32
weights:

* ``moe.moe_ffn`` (outputs, aux and z losses) with top-k ties, and with a
  skewed router whose favourite expert overflows the capacity (dropped
  pairs);
* the port's ``SpinEngine`` against the JAX engine, token- and
  sim-clock-exact, and against plain greedy decoding: reduced
  ``mixtral-8x22b`` (MoE + sliding window: the dense fallback), reduced
  ``dbrx-132b`` on the paged layout with the fused kernels (JAX in
  interpret mode, the port's plain versions), linear and tree, and reduced
  ``qwen2-0.5b`` (QKV bias, tied embeddings) on the paged layout;
* the engine's refusal of models with recurrent state.

Tolerance of ``moe_ffn``: atol = rtol = 1e-5 (float32, values ~1)."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import registry as jregistry
from repro.core import spec_decode as jsd
from repro.core.selector import LBSS as JLBSS
from repro.core.selector import SelectorConfig as JSelectorConfig
from repro.data.workloads import make_workload as j_make_workload
from repro.models import moe as jmoe
from repro.models import transformer as JT
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import SpinEngine as JSpinEngine
from repro_torch.configs import registry
from repro_torch.core import spec_decode as sd
from repro_torch.core.selector import LBSS, SelectorConfig
from repro_torch.data.workloads import make_workload
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import from_jax_numpy
from repro_torch.serving.engine import EngineConfig, SpinEngine

VOCAB = 64
CPU = torch.device("cpu")
SMALL = dict(d_model=32, n_heads=4, vocab_size=VOCAB, n_layers=2)


def _moe_inputs(rng, T, d, E, ff, skew):
    x = rng.standard_normal((T, d)).astype(np.float32)
    router = 0.3 * rng.standard_normal((d, E)).astype(np.float32)
    if skew == "ties":
        router[:] = 0.0          # every expert equally likely: ties
    elif skew == "overflow":
        x[:, 0] = np.abs(x[:, 0]) + 1.0
        router[0, 0] = 8.0       # expert 0 is every token's first choice
    w = [(rng.standard_normal(s) / np.sqrt(s[1])).astype(np.float32)
         for s in ((E, d, ff), (E, d, ff), (E, ff, d))]
    return [x, router] + w


@pytest.mark.parametrize("T,skew", [(24, "plain"), (24, "ties"),
                                    (200, "overflow")])
def test_moe_ffn_matches(T, skew):
    E, k = 4, 2
    arrs = _moe_inputs(np.random.default_rng(0), T, 32, E, 48, skew)
    jout, jaux, jz = jmoe.moe_ffn(*map(jnp.asarray, arrs), top_k=k, cf=1.25)
    out, aux, z = moe.moe_ffn(*map(torch.from_numpy, arrs), top_k=k,
                              cf=1.25)
    for got, want in ((out, jout), (aux, jaux), (z, jz)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
    if skew == "overflow":
        # 200 first choices for expert 0 against a capacity of 128: the
        # dropped pairs contribute nothing
        assert moe.capacity(T, E, k, 1.25) == 128 < T
        x, router = arrs[0], arrs[1]
        assert ((x @ router).argmax(-1) == 0).all()


def _bundles(arch, seed, **overrides):
    jcfg = jregistry.reduced_for(arch, **overrides)
    jb = jsd.Bundle(jcfg, JT.init_params(jcfg, jax.random.PRNGKey(seed)))
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    params = from_jax_numpy(jax.tree.map(np.asarray, jb.params), cfg, CPU)
    return jb, sd.Bundle(cfg, params)


def _ssm(seed):
    return _bundles("llama-68m", seed, d_model=32, n_heads=4, n_kv_heads=4,
                    vocab_size=VOCAB, n_layers=1)


def greedy_reference(llm, prompt, n_new):
    """Plain LLM greedy decoding through the port's dense cache."""
    P = len(prompt)
    toks = torch.as_tensor(np.asarray(prompt, np.int32))[None]
    lengths = torch.tensor([P], dtype=torch.int32)
    lg, cache = llm.prefill(toks, lengths, P + n_new + 8)
    V = llm.cfg.vocab_size
    tok = torch.argmax(lg[:, P - 1, :V], -1, keepdim=True).to(torch.int32)
    out = [int(tok[0, 0])]
    for _ in range(n_new - 1):
        lg, cache = llm.decode(cache, tok, lengths)
        tok = torch.argmax(lg[:, -1, :V], -1, keepdim=True).to(torch.int32)
        lengths = lengths + 1
        out.append(int(tok[0, 0]))
    return out


ENGINES = {
    "mixtral-dense": ("mixtral-8x22b", dict(n_kv_heads=2), {}),
    "dbrx-paged-linear": ("dbrx-132b", dict(n_kv_heads=2),
                          dict(fused_kernels="on")),
    "dbrx-paged-tree": ("dbrx-132b", dict(n_kv_heads=2),
                        dict(fused_kernels="on", spec_shape="tree")),
    "qwen2-paged": ("qwen2-0.5b", dict(n_kv_heads=2), {}),
}


@pytest.mark.parametrize("case", sorted(ENGINES))
def test_engine_matches_jax_engine(case):
    arch, overrides, ekw = ENGINES[case]
    (jllm, llm), (jssm, ssm) = _bundles(arch, 0, **SMALL, **overrides), \
        _ssm(1)
    sel_kw = dict(n_ssms=1, batch_limits=[2], alpha=4, beta=2, seed=1)
    common = dict(gamma=2, max_len=64, capacity=2, packed_bucket=64,
                  straggler_mitigation=False, **ekw)

    jeng = JSpinEngine(jllm, [jssm], JLBSS(JSelectorConfig(**sel_kw)),
                       JEngineConfig(**common))
    jeng.add_requests(j_make_workload("mix", 3, VOCAB, seed=3, scale=0.15))
    jeng.run(max_slots=100)
    eng = SpinEngine(llm, [ssm], LBSS(SelectorConfig(**sel_kw)),
                     EngineConfig(**common))
    eng.add_requests(make_workload("mix", 3, VOCAB, seed=3, scale=0.15))
    eng.run(max_slots=100)

    assert eng.paged == (arch != "mixtral-8x22b") == jeng.paged
    assert all(r.done for r in eng.requests.values()), "stream must drain"
    for rid, r in eng.requests.items():
        assert r.emitted == jeng.requests[rid].emitted, rid
        assert r.emitted[:r.max_new] == greedy_reference(
            llm, r.prompt, r.max_new), rid
    assert eng.sim_time == jeng.sim_time
    assert len(eng.slot_log) == len(jeng.slot_log)
    s, js = eng.stats(), jeng.stats()
    for key in ("accepted_tokens", "drafted", "goodput_sim", "verify_tokens",
                "tree_forks", "kv_layout", "fused_kernels"):
        assert s[key] == js[key], key
    if ekw.get("spec_shape") == "tree":
        assert s["tree_forks"] > 0


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-350m"])
def test_engine_refuses_recurrent_models(arch):
    cfg = registry.reduced_for(arch, **SMALL)
    from repro_torch.models import transformer as T
    b = sd.Bundle(cfg, T.init_params(cfg, 0, device=CPU))
    sel = LBSS(SelectorConfig(n_ssms=1, batch_limits=[2], alpha=4, beta=2,
                              seed=1))
    with pytest.raises(ValueError, match="ROADMAP Queue 3"):
        SpinEngine(b, [b], sel, EngineConfig(gamma=2, max_len=64,
                                             capacity=2))
