"""Shared harness of the port's CPU parity tests of this slice
(``test_torch_router.py``, ``test_torch_elastic.py``,
``test_torch_spec_api.py``, ``test_torch_train.py``): the reference
tests' reduced zoo (``tests/test_router.py``: LLaMA-7B at d 96, 4 heads,
vocab 256; two LLaMA-68M SSMs), bridged to the port in float32, engines
built alike in both packages, a router run of each package on its own
engines compared in full, and the ``one_thread`` fixture."""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry
from repro.core import spec_decode as jsd
from repro.core.selector import LBSS as JLBSS
from repro.core.selector import SelectorConfig as JSelectorConfig
from repro.data.workloads import diurnal_arrivals as j_diurnal
from repro.data.workloads import make_workload as j_make_workload
from repro.models import transformer as JT
from repro.serving import router as jrouter
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import SpinEngine as JSpinEngine
from repro_torch.core import spec_decode as sd
from repro_torch.core.selector import LBSS, SelectorConfig
from repro_torch.data.workloads import diurnal_arrivals, make_workload
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import from_jax_numpy
from repro_torch.serving import router
from repro_torch.serving.engine import EngineConfig, SpinEngine

VOCAB = 256
CPU = torch.device("cpu")
# each package's names the harness builds a fleet from
JAX = types.SimpleNamespace(
    EngineConfig=JEngineConfig, SpinEngine=JSpinEngine, LBSS=JLBSS,
    SelectorConfig=JSelectorConfig, router=jrouter,
    make_workload=j_make_workload, diurnal_arrivals=j_diurnal)
PORT = types.SimpleNamespace(
    EngineConfig=EngineConfig, SpinEngine=SpinEngine, LBSS=LBSS,
    SelectorConfig=SelectorConfig, router=router,
    make_workload=make_workload, diurnal_arrivals=diurnal_arrivals)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's tensors here are small, so each op is mostly the thread
    pool's fixed cost; with several test workers on one host a pool per
    worker oversubscribes the cores (a 40-step training run: 4 s alone,
    two minutes beside five other workers).  Run the module's torch ops on
    one thread and restore the setting after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bridge(jb):
    cfg = ModelConfig(**dataclasses.asdict(jb.cfg))
    return sd.Bundle(cfg, from_jax_numpy(jax.tree.map(np.asarray, jb.params),
                                         cfg, CPU))


def build_models():
    """{"jax": (llm, ssms), "port": (llm, ssms)} with identical weights."""
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
    return {"jax": (jllm, jssms),
            "port": (bridge(jllm), [bridge(b) for b in jssms])}


def make_engine(pkg, models, capacity=2, kv_budget=None, seed=0, cls=None,
                **ecfg_kw):
    """The reference tests' engine (``tests/test_router.py::make_engine``)
    in package ``pkg`` (JAX or PORT); ``cls`` carves a replica class."""
    llm, ssms = models
    sel = pkg.LBSS(pkg.SelectorConfig(
        n_ssms=len(ssms), batch_limits=[capacity] * len(ssms), alpha=4,
        beta=2, seed=seed))
    ecfg = pkg.EngineConfig(gamma=3, max_len=128, capacity=capacity,
                            packed_bucket=128, straggler_mitigation=False,
                            kv_budget=kv_budget, seed=seed, **ecfg_kw)
    if cls is not None:
        ecfg = pkg.router.class_engine_config(ecfg, cls)
    return pkg.SpinEngine(llm, ssms, sel, ecfg)


def workload(pkg, n=6, rate=300.0, seed=11, diurnal=False):
    reqs = pkg.make_workload("mix", n, VOCAB, seed=seed, scale=0.25,
                             arrival_rate=None if diurnal else rate)
    if diurnal:
        trace = pkg.diurnal_arrivals(n, rate_base=30.0, rate_peak=200.0,
                                     period=2.0 * n / 200.0, seed=seed)
        for r, t in zip(reqs, trace):
            r.arrival = float(t)
    return reqs


def run_fleet(pkg, models, n_engines, rcfg_kw, classes=None, work_kw=None,
              max_slots=400, router_kw=None):
    """One router run of package ``pkg`` over its own engines
    (``router_kw``: the Router's keyword arguments, sub-meshes and
    rules)."""
    classes = classes or [None] * n_engines
    engines = [make_engine(pkg, models, seed=i, cls=classes[i])
               for i in range(n_engines)]
    r = pkg.router.Router(engines, pkg.router.RouterConfig(**rcfg_kw),
                          **(router_kw or {}))
    r.submit(workload(pkg, **(work_kw or {})))
    r.run(max_slots=max_slots)
    return r


def sim_stats(stats: dict) -> dict:
    """Router stats minus the replicas' host wall-clock."""
    out = dict(stats)
    out["replica_stats"] = [{k: v for k, v in s.items() if k != "wall_time"}
                            for s in stats["replica_stats"]]
    return out


def assert_same_fleet(mine, ref):
    """Every aggregate, every replica's stats and tokens, and the
    dispatch, steal and scale trails equal the reference router's."""
    assert sim_stats(mine.stats()) == sim_stats(ref.stats())
    assert mine.dispatched_to == ref.dispatched_to
    assert mine.events == ref.events
    for eng, jeng in zip(mine.engines, ref.engines):
        assert {rid: list(r.emitted) for rid, r in eng.requests.items()} \
            == {rid: list(r.emitted) for rid, r in jeng.requests.items()}
        assert eng.sim_time == jeng.sim_time
