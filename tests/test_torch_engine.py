"""The whole slice on the CPU: the port's SpinEngine against the JAX
SpinEngine on the same workload, seeds and (bridged) weights, with
``fused_kernels="on"`` — the JAX engine runs its Pallas kernels in
interpret mode, the port its kernels' plain versions.  Emitted tokens and
the sim-clock bookkeeping must be identical; every request must also match
the port's plain greedy decoding (losslessness)."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import numpy as np

from repro.configs import registry
from repro.core import spec_decode as jsd
from repro.core.selector import LBSS as JLBSS
from repro.core.selector import SelectorConfig as JSelectorConfig
from repro.data.workloads import make_workload as j_make_workload
from repro.models import transformer as JT
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import SpinEngine as JSpinEngine
from repro_torch.core import spec_decode as sd
from repro_torch.core.selector import LBSS, SelectorConfig
from repro_torch.data.workloads import make_workload
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import from_jax_numpy
from repro_torch.serving.engine import EngineConfig, SpinEngine

VOCAB = 256
CPU = torch.device("cpu")


def port_cfg(jcfg):
    return ModelConfig(**dataclasses.asdict(jcfg))


def bridge(jbundle):
    cfg = port_cfg(jbundle.cfg)
    tree = jax.tree.map(np.asarray, jbundle.params)
    return sd.Bundle(cfg, from_jax_numpy(tree, cfg, CPU))


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


def _engine_cfg(cls, **kw):
    return cls(gamma=3, max_len=128, capacity=4, packed_bucket=128,
               straggler_mitigation=False, fused_kernels="on", **kw)


def greedy_reference(llm, prompt, n_new):
    """Plain LLM greedy decoding through the port's dense cache."""
    P = len(prompt)
    toks = torch.as_tensor(np.asarray(prompt, np.int32))[None]
    lg, cache = llm.prefill(toks, torch.tensor([P], dtype=torch.int32),
                            P + n_new + 8)
    V = llm.cfg.vocab_size
    tok = torch.argmax(lg[:, P - 1, :V], -1, keepdim=True).to(torch.int32)
    out = [int(tok[0, 0])]
    lengths = torch.tensor([P], dtype=torch.int32)
    for _ in range(n_new - 1):
        lg2, cache = llm.decode(cache, tok, lengths)
        tok = torch.argmax(lg2[:, -1, :V], -1, keepdim=True).to(torch.int32)
        lengths = lengths + 1
        out.append(int(tok[0, 0]))
    return out


CASES = [dict(spec_shape=shape, kv_dtype=kv) for shape in ("linear", "tree")
         for kv in ("bf16", "int8")] + [
    # chunked prefill appends + padded (unpacked) verify, both through the
    # decode kernel's plain version
    dict(prefill_chunk=8, use_packed_verify=False, kv_dtype="bf16")]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()))
def test_port_engine_matches_jax_engine(zoo, case):
    jllm, jssms, llm, ssms = zoo
    sel_kw = dict(n_ssms=2, batch_limits=[4, 4], alpha=4, beta=2, seed=1)

    jeng = JSpinEngine(jllm, jssms, JLBSS(JSelectorConfig(**sel_kw)),
                       _engine_cfg(JEngineConfig, **case))
    jeng.add_requests(j_make_workload("mix", 4, VOCAB, seed=3, scale=0.2))
    jeng.run(max_slots=120)

    eng = SpinEngine(llm, ssms, LBSS(SelectorConfig(**sel_kw)),
                     _engine_cfg(EngineConfig, **case))
    eng.add_requests(make_workload("mix", 4, VOCAB, seed=3, scale=0.2))
    eng.run(max_slots=120)

    assert all(r.done for r in eng.requests.values()), "stream must drain"
    assert set(eng.requests) == set(jeng.requests)
    for rid, r in eng.requests.items():
        assert r.emitted == jeng.requests[rid].emitted, rid
    assert eng.accepted_tokens == jeng.accepted_tokens
    assert eng.sim_time == jeng.sim_time
    assert len(eng.slot_log) == len(jeng.slot_log)
    s, js = eng.stats(), jeng.stats()
    for key in ("drafted", "goodput_sim", "verify_tokens", "tree_forks",
                "tree_adoptions", "fused_kernels", "kv_dtype"):
        assert s[key] == js[key], key
    if case.get("spec_shape") == "tree":
        assert s["tree_forks"] > 0
    if case.get("prefill_chunk"):
        assert s["scheduler"]["prefill_grants"] > len(eng.requests)
    if case["kv_dtype"] == "bf16":
        # unquantized KV: the engine is lossless against plain greedy
        for r in eng.requests.values():
            assert r.emitted[:r.max_new] == greedy_reference(
                llm, r.prompt, r.max_new), r.rid
