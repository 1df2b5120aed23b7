"""The port's multi-replica router (``serving/router.py``) and fleet
launcher (``launch/serve.py``) against the reference on the CPU.

Each package's ``Router`` drives its own engines (weights bridged in
float32, the reference tests' reduced zoo and workload): every aggregate
of ``stats()``, every replica's engine stats (minus host wall time) and
tokens, and the dispatch trail must be equal, for each policy.  The
elastic cases (autoscale, steal, replica classes) and the engine's fleet
methods are in ``test_torch_elastic.py``.  The pure helpers are held to
the reference's on the reference tests' inputs, and the port's launcher
serves a fleet and exits 2 where the reference's does."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch_dist import gloo_world
from torch_fleet import (JAX, PORT, assert_same_fleet, build_models,
                         make_engine, one_thread, run_fleet)  # noqa: F401

from repro.launch import serve as jserve
from repro.serving import router as jrouter
from repro_torch.distributed import sharding
from repro_torch.launch import mesh, serve
from repro_torch.serving import router
from repro_torch.serving.engine import EngineConfig


@pytest.fixture(scope="module")
def models():
    return build_models()


@pytest.mark.parametrize("policy", ["lot", "p2c", "slo"])
def test_router_matches_reference(models, policy):
    kw = dict(policy=policy, seed=3)
    ref = run_fleet(JAX, models["jax"], 2, kw)
    mine = run_fleet(PORT, models["port"], 2, kw)
    assert mine.stats()["finished"] == 6
    assert all(n > 0 for n in mine.dispatch_count)
    assert_same_fleet(mine, ref)


# (name, call): each call runs on the port's module and on the reference's
PURE = [
    ("classes-empty", lambda m, s, E: m.parse_replica_classes("")),
    ("classes-blank", lambda m, s, E: m.parse_replica_classes("  ")),
    ("classes-counts",
     lambda m, s, E: m.parse_replica_classes("prefill:1,decode:3")),
    ("classes-general", lambda m, s, E: m.parse_replica_classes("general")),
    ("classes-mixed",
     lambda m, s, E: m.parse_replica_classes("decode:2, prefill")),
    ("classes-unknown", lambda m, s, E: m.parse_replica_classes("turbo:2")),
    ("classes-zero", lambda m, s, E: m.parse_replica_classes("decode:0")),
    ("classes-nan", lambda m, s, E: m.parse_replica_classes("decode:x")),
    ("classes-commas", lambda m, s, E: m.parse_replica_classes(",,")),
] + [
    (f"class-config-{c}", lambda m, s, E, c=c: vars(m.class_engine_config(
        E(gamma=3, capacity=4, token_budget=32), c)))
    for c in ("prefill", "decode", "general", "turbo")
] + [
    (f"router-config-{i}", lambda m, s, E, kw=kw: vars(m.RouterConfig(**kw)))
    for i, kw in enumerate([
        dict(policy="round-robin"), dict(autoscale="bananas"),
        dict(steal="maybe"), dict(replicas_min=0),
        dict(replicas_min=4, replicas_max=2),
        dict(occ_low=0.9, occ_high=0.8), dict(cooldown=-1.0),
        dict(steal_margin=-0.1), dict(classes="turbo:2"),
        dict(autoscale="target-occupancy", replicas_min=2, replicas_max=4,
             classes="prefill:1,decode:3"),
        dict(policy="p2c", seed=5)])
] + [
    (f"split-evenly-{t}-{n}", lambda m, s, E, t=t, n=n: s.split_evenly(t, n))
    for t, n in ((6, 2), (7, 3), (2, 4), (512, 3))
] + [
    (f"split-weighted-{t}", lambda m, s, E, t=t, w=w: s.split_weighted(t, w))
    for t, w in ((1024, [1, 2, 3]), (100, [3, 3, 1]), (7, [1, 1]),
                 (512, [router.CLASS_KV_WEIGHTS[c]
                        for c in ("prefill", "decode", "decode")]))
]


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("name,call", PURE, ids=[n for n, _ in PURE])
def test_pure_helpers_match_reference(name, call):
    from repro.serving.engine import EngineConfig as JEngineConfig
    mine = _outcome(call, router, serve, EngineConfig)
    ref = _outcome(call, jrouter, jserve, JEngineConfig)
    assert mine == ref


def test_router_tables_match_reference():
    assert router.POLICIES == jrouter.POLICIES
    assert router.AUTOSCALE_MODES == jrouter.AUTOSCALE_MODES
    assert router.REPLICA_CLASSES == jrouter.REPLICA_CLASSES
    assert router.CLASS_KV_WEIGHTS == jrouter.CLASS_KV_WEIGHTS


def test_router_rejects_submeshes_and_bad_fleets(models):
    eng = make_engine(PORT, models["port"])
    with pytest.raises(ValueError, match="sub-meshes for 1 replicas"):
        router.Router([eng], submeshes=[object(), object()])
    with pytest.raises(ValueError):
        router.Router([], router.RouterConfig())
    with pytest.raises(ValueError):
        router.Router([eng], router.RouterConfig(replicas_min=2))


def test_router_on_replica_submeshes_matches_reference(models):
    """Two replicas sharing the one rank of a world-1 ``gloo`` group, each
    stepping under ``use_rules`` on its 1x1 sub-mesh with the serve
    table: the same stats, tokens and dispatch trail as the reference's
    router without meshes."""
    kw = dict(policy="p2c", seed=3)
    ref = run_fleet(JAX, models["jax"], 2, kw)
    with gloo_world():
        subs = mesh.replica_submeshes(mesh.make_local_mesh(
            replicas=2, device_type="cpu"))
        mine = run_fleet(PORT, models["port"], 2, kw,
                         router_kw=dict(submeshes=subs,
                                        rules=sharding.serve_rules()))
    assert mine.submeshes == subs and not sharding.active()
    assert_same_fleet(mine, ref)


def test_serve_cli_fleet_finishes():
    stats = serve.main(["--device", "cpu", "--replicas", "2",
                        "--router-policy", "lot", "--requests", "4",
                        "--scale", "0.25", "--arrival-rate", "300"])
    assert stats["finished"] == 4
    assert sum(stats["dispatched"]) == 4
    assert stats["replicas"] == 2


@pytest.mark.parametrize("classes,kv_budget", [
    (["general", "general", "general"], 200),
    (["prefill", "decode"], 256),
    (["general", "general"], None),
])
def test_build_fleet_splits_the_aggregate(models, classes, kv_budget):
    """The launcher's fleet: the aggregate capacity split evenly, the KV
    budget evenly or by class weight, each replica its class's config."""
    llm, ssms = models["port"]
    reqs = PORT.make_workload("mix", 4, llm.cfg.vocab_size, seed=0,
                              scale=0.25)
    base = EngineConfig(capacity=7, kv_budget=kv_budget)
    engines = serve.build_fleet(llm, ssms, reqs, base, classes)
    weighted = any(c != "general" for c in classes)
    want_kv = ([None] * len(classes) if kv_budget is None else
               serve.split_weighted(kv_budget, [router.CLASS_KV_WEIGHTS[c]
                                                for c in classes])
               if weighted else serve.split_evenly(kv_budget, len(classes)))
    assert [e.ecfg.capacity for e in engines] == serve.split_evenly(
        7, len(classes))
    assert [e.ecfg.kv_budget for e in engines] == want_kv
    for e, c in zip(engines, classes):
        assert e.ecfg == dataclasses.replace(
            router.class_engine_config(base, c), capacity=e.ecfg.capacity,
            kv_budget=e.ecfg.kv_budget)
        assert e.llm is llm and e.ssms == ssms


FLEET_ERRORS = [
    ["--replicas", "0"],
    ["--replicas", "3", "--replica-classes", "prefill,decode"],
    ["--replicas", "2", "--replicas-max", "1"],
    ["--replica-classes", "prefill,decode", "--replicas-max", "3"],
    ["--replicas", "2", "--replicas-min", "3"],
    ["--replicas", "4", "--capacity", "2"],
    ["--replicas", "2", "--kv-budget", "16", "--block-size", "16"],
    ["--router-policy", "round-robin"],
    ["--autoscale", "target-occupancy", "--replicas-min", "0"],
    ["--replica-classes", "turbo:2"],
]


@pytest.mark.parametrize("argv", FLEET_ERRORS, ids=" ".join)
def test_serve_cli_fleet_errors_exit_2(argv):
    codes = []
    for main, extra in ((serve.main, ["--device", "cpu"]), (jserve.main, [])):
        with pytest.raises(SystemExit) as exc:
            main(argv + extra + ["--requests", "4"])
        codes.append(exc.value.code)
    assert codes == [2, 2]
