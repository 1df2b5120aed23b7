"""The engine's tracer (``repro_torch.serving.trace``) on the benchmark's
tiny engine, on the CPU, and the join of its spans with a device trace
(``h100bench/enginetrace.py``) on synthetic events."""

import sys

import pytest

from h100bench import enginetrace as ET
from h100bench import harness, tiny
from repro_torch.serving import trace

SLOTS = 10
STEP_PHASES = {"schedule", "select", "grant", "draft", "verify",
               "cost_model", "commit", "precompute"}
PARENT = {"schedule": {"submit", "step"}, "admit": {"schedule"},
          "admit.prefill": {"admit"}, "admit.insert": {"admit"},
          "select": {"step"}, "place": {"select"},
          "place.prefill": {"place"}, "place.insert": {"place"},
          "grant": {"step"}, "draft": {"step"}, "draft.forward": {"draft"},
          "verify": {"step"}, "verify.forward": {"verify"},
          "verify.accept": {"verify"}, "verify.catchup": {"verify"},
          "cost_model": {"step"}, "commit": {"step"},
          "precompute": {"step"}}


def _run(root, on):
    got = {}

    def patch(eng):
        eng.tracer.on = on
        got["eng"] = eng
    harness.run_cell("tiny.closed", 21, 1.0, False, root=root, device="cpu",
                     slots=SLOTS, patch=patch)
    eng = got["eng"]
    eng.tracer.on = False
    tokens = {rid: list(r.emitted) for rid, r in eng.requests.items()}
    return tokens, eng.tracer.drain()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tiny.make_root(tmp_path_factory.mktemp("bench"))
    return {on: _run(root, on) for on in (False, True)}


def test_off_records_nothing_and_serves_the_same_tokens(runs):
    off_tokens, off_rec = runs[False]
    on_tokens, on_rec = runs[True]
    assert off_rec == {"spans": [], "events": []}
    assert on_rec["spans"] and off_tokens == on_tokens


def test_off_allocates_nothing():
    tr = trace.Tracer()
    assert tr.span("step") is trace.NO_SPAN and trace.sync() is trace.NO_SPAN
    before = sys.getallocatedblocks()
    for _ in range(10000):
        with tr.span("step", 3):
            with trace.sync():
                tr.count("syncs")
    assert sys.getallocatedblocks() - before < 50
    assert tr.drain() == {"spans": [], "events": []}


def test_spans_nest_and_phases_cover_each_step(runs):
    spans = runs[True][1]["spans"]
    names = {s["name"] for s in spans}
    assert {"submit", "step", "admit", "admit.prefill", "place", "draft",
            "draft.forward", "verify", "verify.forward", "sync"} <= names
    for s in spans:
        assert s["t0"] <= s["t1"]
        if s["parent"] < 0:
            assert s["name"] in ("submit", "step")
            continue
        p = spans[s["parent"]]
        assert p["t0"] <= s["t0"] and s["t1"] <= p["t1"], (s, p)
        if s["name"] != "sync":
            assert p["name"] in PARENT[s["name"]], (s["name"], p["name"])
        if p["name"] == "step":
            assert s["name"] in STEP_PHASES
    cover = ET.step_coverage(spans)
    assert len(cover) >= SLOTS and min(cover) >= 0.98, cover


def test_syncs_counter_equals_sync_spans(runs):
    spans = runs[True][1]["spans"]
    n = sum(1 for s in spans if s["name"] == "sync")
    assert n > 0
    assert sum((s["counts"] or {}).get("syncs", 0) for s in spans
               if s["parent"] < 0) == n


def test_queued_and_admitted_share_the_request_id(runs):
    spans, events = runs[True][1]["spans"], runs[True][1]["events"]
    queued = {k: t for name, k, t in events if name == "queued"}
    admitted = [(k, t) for name, k, t in events if name == "admitted"]
    assert admitted
    for k, t in admitted:
        assert k in queued and queued[k] <= t
    admits = {s["key"] for s in spans if s["name"] == "admit"}
    assert admits == {k for k, _ in admitted}


# -------------------------------------------------------- synthetic trace --

def span(name, t0, t1, parent, key=None, syncs=None):
    return {"name": name, "key": key, "t0": t0, "t1": t1, "parent": parent,
            "counts": None if parent >= 0 else {"syncs": syncs or 0}}


def synthetic():
    """Two slots (ns): a submit admitting request 7, then two steps."""
    spans = [
        span("submit", 0, 100, -1, syncs=1),                   # 0
        span("schedule", 10, 90, 0),                           # 1
        span("admit", 20, 80, 1, 7),                           # 2
        span("sync", 60, 70, 2),                               # 3
        span("step", 200, 1200, -1, syncs=2),                  # 4
        span("verify", 300, 700, 4),                           # 5
        span("verify.forward", 300, 500, 5),                   # 6
        span("sync", 450, 500, 6),                             # 7
        span("commit", 700, 1100, 4),                          # 8
        span("step", 1300, 2300, -1, syncs=1),                 # 9
        span("draft", 1300, 1500, 9, 0),                       # 10
        span("sync", 1500, 1600, 9),                           # 11
    ]
    events = [("queued", 7, 5), ("admitted", 7, 25), ("queued", 8, 30)]
    return {"spans": spans, "events": events}


def test_own_intervals_partition_the_roots():
    own = ET.own_intervals(synthetic()["spans"])
    total = sum(b - a for a, b, _ in own)
    assert total == 100 + 1000 + 1000
    assert all(own[i][1] <= own[i + 1][0] for i in range(len(own) - 1))


@pytest.mark.parametrize("name,want", [
    # step 1: 1000 - verify 400; step 2: 1000 - draft 200
    ("step_other_ms_per_slot", (600 + 800) / 2 / 1e6),
    ("host_wait_ms_per_slot", (10 + 50 + 100) / 2 / 1e6),
    ("host_syncs_per_slot", 4 / 2),
    ("queue_wait_ms_per_request", 20 / 1e6),
    ("idle_explained_share", 100.0 * 0.75)])
def test_readings_of_a_synthetic_trace(name, want):
    tr = {**synthetic(), "slots": 2, "idle_s": 4.0, "idle_explained_s": 3.0}
    assert ET.READINGS[name](tr) == pytest.approx(want)
    assert ET.READINGS[name](None) is None


def test_idle_by_span_on_synthetic_device_events():
    """Device events on a clock 1e9 ns ahead of the spans' (offset measured
    at both marks; half-widths 2 ns), in us as the profiler gives them:
    busy over [0, 450) and [1150, 1550) of the spans' clock, so idle over
    [450, 1150) and [1550, 2300)."""
    rec = synthetic()
    off = 1e9
    dev = [((a + off) / 1e3, (b + off) / 1e3, "k")
           for a, b in ((0, 450), (1150, 1550))]
    marks = [(-50, -40), (2400, 2410)]
    tr = ET.join(rec, dev, [(off, 2.0), (off, 2.0)], marks)
    assert tr["drift_ns"] == 0
    want = {"verify.forward/sync": 50e-9, "verify": 200e-9,
            "commit": 400e-9, "step": (50 + 700) * 1e-9,
            "step/sync": 50e-9}
    assert tr["idle_by_span"].keys() == want.keys()
    for k, v in want.items():
        assert tr["idle_by_span"][k] == pytest.approx(v), k
    assert tr["idle_s"] == pytest.approx(1450e-9)
    # under a span other than a root's own: all but the steps' own 750 ns
    assert tr["idle_explained_s"] == pytest.approx(700e-9)
    assert ET.idle_explained_share(tr) == pytest.approx(100 * 700 / 1450)


def test_idle_outside_the_engine_and_a_drifting_offset():
    """A gap between the roots is the driver's own time; an offset that
    drifts by 100 ns over the stretch is read linearly between marks."""
    rec = {"spans": [span("step", 0, 1000, -1), span("step", 2000, 3000, -1)],
           "events": []}
    o0, o1 = 5e8, 5e8 + 100
    marks = [(0, 10), (3000, 3010)]

    def prof(t):
        return (t + o0 + (o1 - o0) * t / 3000) / 1e3
    dev = [(prof(0), prof(900), "k"), (prof(2100), prof(3000), "k")]
    tr = ET.join(rec, dev, [(o0, 5.0), (o1, 5.0)], marks)
    assert tr["drift_ns"] == pytest.approx(100)
    idle = tr["idle_by_span"]
    assert idle["outside_engine"] == pytest.approx(1000e-9)
    assert idle["step"] == pytest.approx(200e-9)
    assert tr["idle_explained_s"] == 0
