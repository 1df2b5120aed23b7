"""The port's elastic fleet against the reference on the CPU: the router's
control plane (target-occupancy autoscaling, work stealing, replica
classes), each package's ``Router`` over its own engines and compared in
full as in ``test_torch_router.py``; and the engine methods the router
reads (``release_queued``, ``snapshot``, ``kv_free_cells``,
``outstanding_tokens``), pinned as ``tests/test_elastic.py`` pins the
reference's and held to the reference engine's on the same requests."""

import pytest

torch = pytest.importorskip("torch")

from torch_fleet import (JAX, PORT, assert_same_fleet, build_models,
                         make_engine, one_thread, run_fleet,  # noqa: F401
                         workload)


@pytest.fixture(scope="module")
def models():
    return build_models()


# (engines, router config, replica classes, workload)
ELASTIC = {
    "autoscale": (3, dict(policy="lot", autoscale="target-occupancy",
                          replicas_min=1, replicas_max=3, cooldown=0.01),
                  None, dict(n=7, seed=17, diurnal=True)),
    "steal": (2, dict(policy="p2c", seed=2, steal="on"), None,
              dict(n=7, rate=2000.0, seed=11)),
    "classes": (2, dict(policy="lot", classes="prefill,decode"),
                ["prefill", "decode"], dict(n=6, seed=11)),
}


@pytest.mark.parametrize("case", list(ELASTIC))
def test_elastic_router_matches_reference(models, case):
    n, kw, classes, work = ELASTIC[case]
    ref = run_fleet(JAX, models["jax"], n, kw, classes, work_kw=work,
                    max_slots=2000)
    mine = run_fleet(PORT, models["port"], n, kw, classes, work_kw=work,
                     max_slots=2000)
    st = mine.stats()
    assert st["finished"] == work["n"]
    if case == "autoscale":
        assert st["scale_ups"] >= 1
    if case == "steal":
        assert st["steals"] >= 1
    if case == "classes":
        assert st["classes"] == ["prefill", "decode"]
    assert_same_fleet(mine, ref)


def _pair(models, **kw):
    return (make_engine(JAX, models["jax"], **kw),
            make_engine(PORT, models["port"], **kw))


def _snap(eng):
    return eng.snapshot().asdict()


def test_release_queued_only_rowless(models):
    """Capacity 1: one request takes the row, three wait; release hands
    back the three, scrubs them, and the row owner still drains."""
    engines = _pair(models, capacity=1)
    out = {}
    for pkg, eng in zip((JAX, PORT), engines):
        reqs = workload(pkg, n=4, seed=31)
        for r in reqs:
            r.arrival = 0.0
        eng.add_requests(reqs)
        admitted = [rid for rid in eng.requests if eng.llm_pool.has(rid)]
        assert len(admitted) == 1
        free = eng.kv_free_cells()
        wait_before = eng.scheduler.queue_wait
        rel = eng.release_queued()
        assert sorted(r.rid for r in rel) == sorted(
            r.rid for r in reqs if r.rid not in admitted)
        assert eng.scheduler.queue_wait == wait_before
        assert eng.scheduler.stolen == len(rel)
        for r in rel:
            assert r.rid not in eng.requests
            assert not eng.llm_pool.has(r.rid)
        # rowless requests held no blocks: the free cells stand
        assert eng.kv_free_cells() == free
        out[pkg.SpinEngine.__module__] = (_snap(eng), [r.rid for r in rel])
        st = eng.run(max_slots=100)
        assert st["scheduler"]["finished"] == 1
    jref, mine = out.values()
    assert mine == jref


def test_release_queued_include_pending(models):
    for pkg, eng in zip((JAX, PORT), _pair(models, capacity=2)):
        reqs = workload(pkg, n=3, seed=33)
        reqs[0].arrival = 0.0
        reqs[1].arrival = 1e6            # far future: stays pending
        reqs[2].arrival = 1e6
        eng.add_requests(reqs)
        assert [r.rid for r in eng.release_queued()] == []
        out = eng.release_queued(include_pending=True)
        assert sorted(r.rid for r in out) == [reqs[1].rid, reqs[2].rid]
        assert not eng.scheduler._pending


def test_release_after_preemption_frees_blocks(models):
    """A tight KV budget preempts a running request back to the queue:
    its blocks are in the pool's free list before it is released, and
    the port's free cells and snapshot equal the reference's at each
    step."""
    engines = _pair(models, capacity=3, kv_budget=64, block_size=16)
    reqs = {id(e): workload(pkg, n=5, seed=41)
            for pkg, e in zip((JAX, PORT), engines)}
    for e in engines:
        for r in reqs[id(e)]:
            r.arrival = 0.0
        e.add_requests(reqs[id(e)])
    released = []
    for _ in range(40):
        snaps = [_snap(e) for e in engines]
        assert snaps[1] == snaps[0]
        for e in engines:
            e.step()
        rel = [e.release_queued() for e in engines]
        assert [r.rid for r in rel[1]] == [r.rid for r in rel[0]]
        for e, out in zip(engines, rel):
            for r in out:
                assert not e.llm_pool.has(r.rid)
        pool = engines[1].llm_pool
        assert pool.free_blocks + pool.allocated_blocks == pool.num_blocks
        released += [r.rid for r in rel[1]]
        if not any(e.scheduler.outstanding for e in engines):
            break
    assert engines[1].scheduler.snapshot().preemptions > 0
    assert released


@pytest.mark.parametrize("at", [0, 3, 8])
def test_snapshot_matches_reference(models, at):
    """The typed snapshot (outstanding tokens, free cells, occupancy, SLO
    headroom, the scheduler's view) after ``at`` slots."""
    snaps = []
    for pkg, eng in zip((JAX, PORT), _pair(models, capacity=2,
                                           kv_budget=256)):
        eng.add_requests(workload(pkg, n=5, rate=300.0, seed=51))
        for _ in range(at):
            eng.step()
        snaps.append((_snap(eng), eng.outstanding_tokens(),
                      eng.kv_free_cells(), eng.kv_occupancy(),
                      [r.rid for r in eng.waiting]))
    assert snaps[1] == snaps[0]
    assert snaps[1][1] > 0
