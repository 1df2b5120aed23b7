"""The engine's own spans joined to the device's trace, on one clock.

The port's engine records spans and counters of its own
(``repro_torch.serving.trace``, ``SpinEngine.tracer``, off by default).
:func:`traced_slots` serves slots as the harness's idle slots do, under a
profile of the device's activity alone, with that tracer on, and joins the
two: the engine's spans are moved onto the profiler's clock by the offset
a marker measures at both ends of the stretch (a one-element device op
launched between two ``perf_counter_ns`` readings), and each gap in the
device's activity is split at span boundaries and put down to the deepest
engine span the host was in (``outside_engine`` where it was in none).
The result is the stretch's ``trace``; :data:`READINGS` are the per-layer
numbers read from it.

Run as a script, one traced run of a cell with :func:`traced_slots` in
place of the harness's idle slots; on request, slots served with the
tracer on and off in turn (its cost) before them, with no profiler
started yet in the process, and again after them, and slots under
``torch.cuda.set_sync_debug_mode("warn")`` (the synchronizing calls
PyTorch reports, against the ``sync`` spans):

    python3 h100bench/enginetrace.py --workload <cell> --seed <n> \
        --seconds <s> [--cost-slots <k>] [--sync-debug 1] [--out <json>]
"""

from __future__ import annotations

import bisect
import json
import sys
import time
import traceback
import warnings
from collections import Counter
from pathlib import Path

MARK = "spin_kernel"            # the marker's kernel (``torch.cuda._sleep``)
MAJOR = ("admit", "place", "draft", "verify")


# ------------------------------------------------------------ the clock --

def mark(device):
    """Launches the marker between two host readings (ns) and waits for
    it; returns the readings."""
    import torch
    t0 = time.perf_counter_ns()
    torch.cuda._sleep(1)
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize(device)
    return t0, t1


def marker_offsets(raw, marks):
    """(offset ns, half-width ns) of the profiler's clock over
    ``perf_counter_ns`` at each mark, in order: the host call that
    launched the marker's kernel lies inside the mark's readings.  Where
    the profile holds no such call, the kernel's start, which follows the
    launch, against the later reading."""
    from torch.autograd import DeviceType
    kernels = sorted((e.start_ns(), e.correlation_id()) for e in raw
                     if e.device_type() == DeviceType.CUDA
                     and MARK in e.name())
    if len(kernels) != len(marks):
        raise RuntimeError(f"{len(kernels)} marker kernels for "
                           f"{len(marks)} marks")
    calls = {e.correlation_id(): e for e in raw
             if e.device_type() == DeviceType.CPU
             and e.name().startswith("cuda")}
    out = []
    for (k0, corr), (t0, t1) in zip(kernels, marks):
        call = calls.get(corr)
        if call is None:
            out.append((k0 - t1, None))
            continue
        hi, lo = call.start_ns() - t0, call.end_ns() - t1
        out.append(((hi + lo) / 2, (hi - lo) / 2))
    return out


# -------------------------------------------------------------- the join --

def _key(spans, i):
    s = spans[i]
    if s["name"] == "sync" and s["parent"] >= 0:
        return spans[s["parent"]]["name"] + "/sync"
    return s["name"]


def own_intervals(spans):
    """(start, end, index) of every span's own time, its interval less its
    children's, sorted; they are disjoint."""
    kids = [[] for _ in spans]
    for i, s in enumerate(spans):
        if s["parent"] >= 0:
            kids[s["parent"]].append(i)
    out = []
    for i, s in enumerate(spans):
        cur = s["t0"]
        for c in kids[i]:
            if spans[c]["t0"] > cur:
                out.append((cur, spans[c]["t0"], i))
            cur = max(cur, spans[c]["t1"])
        if s["t1"] > cur:
            out.append((cur, s["t1"], i))
    out.sort()
    return out


def idle_by_span(spans, gaps_ns):
    """Seconds of the gaps ((start, end) in the spans' clock, ns) under
    each span's own time, keyed by the span's name (a ``sync`` by its
    parent's: ``verify.forward/sync``), and ``outside_engine``; and the
    seconds under a span other than a root's own time."""
    own = own_intervals(spans)
    starts = [a for a, _, _ in own]
    idle, explained = {}, 0.0
    for a, b in gaps_ns:
        inside = 0.0
        i = max(0, bisect.bisect_right(starts, a) - 1)
        while i < len(own) and own[i][0] < b:
            s, e, k = own[i]
            ov = (min(e, b) - max(s, a)) / 1e9
            if ov > 0:
                key = _key(spans, k)
                idle[key] = idle.get(key, 0.0) + ov
                inside += ov
                if spans[k]["parent"] >= 0:
                    explained += ov
            i += 1
        rest = (b - a) / 1e9 - inside
        if rest > 1e-12:        # beyond the rounding of the clocks' join
            idle["outside_engine"] = idle.get("outside_engine", 0.0) + rest
    return idle, explained


def step_coverage(spans):
    """Each ``step`` span's share covered by its children."""
    cover = {}
    for s in spans:
        p = s["parent"]
        if p >= 0 and spans[p]["name"] == "step":
            cover[p] = cover.get(p, 0) + s["t1"] - s["t0"]
    return [cover.get(i, 0) / max(1, s["t1"] - s["t0"])
            for i, s in enumerate(spans) if s["name"] == "step"]


def join(rec, dev_spans, offsets, marks):
    """The stretch's ``trace``: the engine's record ``rec`` (``Tracer.
    drain``) with the device's idle gaps over its root spans, from
    ``dev_spans`` ((start us, end us, name), the profiler's clock, sorted)
    moved onto the spans' clock by the offsets at the two marks (linear
    between them)."""
    from h100bench import work
    spans = rec["spans"]
    (o0, e0), (o1, e1) = offsets
    m0 = marks[0][0]
    k = (o1 - o0) / max(1, marks[1][0] - m0)

    def to_prof(t):
        return t + o0 + k * (t - m0)

    def from_prof(x):
        return (x - o0 + k * m0) / (1 + k)
    roots = [s for s in spans if s["parent"] < 0]
    out = {"spans": spans, "events": rec["events"],
           "offset_ns": [o0, o1], "offset_err_ns": [e0, e1],
           "drift_ns": o1 - o0, "idle_s": 0.0, "idle_explained_s": 0.0,
           "idle_by_span": {}, "step_coverage": step_coverage(spans)}
    if not roots:
        return out
    w0, w1 = roots[0]["t0"], max(s["t1"] for s in roots)
    gaps = work.idle_gaps(dev_spans, to_prof(w0) / 1e3, to_prof(w1) / 1e3)
    gaps_ns = [(from_prof(a * 1e3), from_prof(b * 1e3)) for a, b in gaps]
    idle, explained = idle_by_span(spans, gaps_ns)
    out["idle_s"] = sum((b - a) for a, b in gaps_ns) / 1e9
    out["idle_explained_s"] = explained
    out["idle_by_span"] = dict(sorted(idle.items(), key=lambda kv: -kv[1]))
    return out


def traced_slots(driver, n, sync):
    """``n`` slots under a profile of the device's activity alone with the
    engine's tracer on, as the harness's ``device_slots`` (the same keys,
    the markers' kernels left out), and the joined ``trace``."""
    from torch.profiler import ProfilerActivity, profile
    from h100bench import harness, work
    eng = driver.eng
    dev = eng.llm.device
    eng.tracer.drain()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sync()
        m0 = mark(dev)
        t0 = time.perf_counter()
        eng.tracer.on = True
        try:
            done = driver.run_slots(n)
        finally:
            eng.tracer.on = False
        sync()
        t1 = time.perf_counter()
        m1 = mark(dev)
    rec = eng.tracer.drain()
    raw = prof.profiler.kineto_results.events()
    dev_spans, _ = harness._device_spans(raw)
    offsets = marker_offsets(raw, [m0, m1])
    dev_spans = [s for s in dev_spans if MARK not in s[2]]
    if not dev_spans:
        harness.log("engine trace: no device operation read")
        return None
    busy_ms, per_name = work.device_time(dev_spans)
    tr = join(rec, dev_spans, offsets, [m0, m1])
    tr["slots"] = done
    harness.log(f"engine trace: {done} slots in {t1 - t0:.3f} s, "
                f"{len(rec['spans'])} spans, busy {busy_ms:.1f} ms, idle "
                f"{tr['idle_s']:.3f} s; clock offset {offsets[0][0]:.0f} "
                f"-> {offsets[1][0]:.0f} ns (drift {tr['drift_ns']:.0f}, "
                f"half-widths {offsets[0][1]}, {offsets[1][1]})")
    for k, v in list(tr["idle_by_span"].items())[:12]:
        harness.log(f"  idle under {k}: {v * 1e3:.1f} ms")
    return {"busy_s": busy_ms / 1e3, "wall_s": t1 - t0, "slots": done,
            "device_ops": harness._top_ops(per_name), "trace": tr}


# ----------------------------------------------------------- the readings --

def _slots(tr):
    return tr["slots"] if tr and tr.get("slots") else None


def step_other_ms_per_slot(tr):
    """Time in ``step`` spans under none of ``admit``, ``place``,
    ``draft``, ``verify``, per slot, in ms."""
    n = _slots(tr)
    if not n:
        return None
    spans = tr["spans"]
    root, under = [], []
    for s in spans:
        p = s["parent"]
        root.append(root[p] if p >= 0 else len(root))
        under.append(p >= 0 and (spans[p]["name"] in MAJOR or under[p]))
    total = sum(s["t1"] - s["t0"] for s in spans if s["name"] == "step")
    major = sum(s["t1"] - s["t0"] for i, s in enumerate(spans)
                if s["name"] in MAJOR and not under[i]
                and spans[root[i]]["name"] == "step")
    return (total - major) / n / 1e6


def host_wait_ms_per_slot(tr):
    """Time in ``sync`` spans per slot, in ms."""
    n = _slots(tr)
    if not n:
        return None
    return sum(s["t1"] - s["t0"] for s in tr["spans"]
               if s["name"] == "sync") / n / 1e6


def host_syncs_per_slot(tr):
    """The ``syncs`` counter per slot."""
    n = _slots(tr)
    if not n:
        return None
    return sum((s["counts"] or {}).get("syncs", 0)
               for s in tr["spans"] if s["parent"] < 0) / n


def queue_wait_ms_per_request(tr):
    """Mean time from a request's ``queued`` to its ``admitted``, over the
    stretch's admissions whose queueing it saw, in ms."""
    if not tr:
        return None
    queued, waits = {}, []
    for name, key, t in sorted(tr["events"], key=lambda e: e[2]):
        if name == "queued":
            queued[key] = t
        elif name == "admitted" and key in queued:
            waits.append(t - queued.pop(key))
    return sum(waits) / len(waits) / 1e6 if waits else None


def idle_explained_share(tr):
    """The share of the device's idle time that lies under an engine span
    other than a root's own time, in %."""
    if not tr or not tr.get("idle_s"):
        return None
    return 100.0 * tr["idle_explained_s"] / tr["idle_s"]


READINGS = {f.__name__: f for f in (
    step_other_ms_per_slot, host_wait_ms_per_slot, host_syncs_per_slot,
    queue_wait_ms_per_request, idle_explained_share)}


# ------------------------------------------------- the script's stretches --

def tracer_cost(driver, n):
    """``n`` slots, the tracer on and off in turn (off, on, on, off, ...):
    each slot's seconds and admissions, and the least-squares fit of
    seconds = a + b x admissions + c x on (c is the tracer's cost)."""
    import numpy as np
    eng = driver.eng
    rows = []
    for i in range(n):
        on = (i % 4) in (1, 2)
        eng.tracer.on = on
        adm = eng.scheduler.admissions
        t = time.perf_counter()
        driver.run_slots(1)
        dt = time.perf_counter() - t
        eng.tracer.on = False
        spans = len(eng.tracer.drain()["spans"])
        rows.append((dt, eng.scheduler.admissions - adm, on, spans))
    y = np.array([r[0] for r in rows])
    X = np.array([[1.0, r[1], float(r[2])] for r in rows])
    coef, res, *_ = np.linalg.lstsq(X, y, rcond=None)
    dof = max(1, len(y) - 3)
    sigma2 = float(((y - X @ coef) ** 2).sum()) / dof
    se = np.sqrt(np.diag(sigma2 * np.linalg.pinv(X.T @ X)))
    spans_on = [r[3] for r in rows if r[2]]
    return {"slots": rows, "fit": coef.tolist(), "se": se.tolist(),
            "cost_s": float(coef[2]), "cost_se_s": float(se[2]),
            "mean_slot_s": float(y.mean()),
            "spans_per_slot_on": sum(spans_on) / max(1, len(spans_on))}


def span_cost_ns(reps=200000):
    """Host ns one span costs, recorded and closed, and the shared no-op's
    (the tracer off)."""
    from repro_torch.serving.trace import Tracer
    out = {}
    for on in (True, False):
        tr = Tracer()
        tr.on = on
        with tr.span("step"):
            t = time.perf_counter_ns()
            for _ in range(reps):
                with tr.span("x"):
                    pass
            out["on" if on else "off"] = (time.perf_counter_ns() - t) / reps
    return out


def _site(stack):
    for f in reversed(stack):
        if "repro_torch" in f.filename:
            name = f.filename.split("repro_torch/")[-1]
            return f"{name}:{f.lineno} {f.name}"
    return "outside repro_torch"


def sync_debug_slots(driver, n):
    """``n`` slots with the tracer on under ``torch.cuda.
    set_sync_debug_mode("warn")``: per slot the synchronizing calls
    PyTorch reports and the ``sync`` spans; each call's site, and the
    sites of calls made outside any ``sync`` span."""
    import torch
    from repro_torch.serving import trace
    eng = driver.eng
    sites, bare = Counter(), Counter()
    per_slot = []
    reported = [0]

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        reported[0] += 1
        site = _site(traceback.extract_stack()[:-1])
        sites[site] += 1
        tr = trace.active()
        if tr is None or tr.current() != "sync":
            bare[site] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(n):
                reported[0] = 0
                eng.tracer.on = True
                driver.run_slots(1)
                eng.tracer.on = False
                rec = eng.tracer.drain()
                per_slot.append((reported[0], sum(
                    1 for s in rec["spans"] if s["name"] == "sync")))
        finally:
            eng.tracer.on = False
            torch.cuda.set_sync_debug_mode(0)
    return {"per_slot": per_slot, "sites": dict(sites.most_common()),
            "outside_sync_spans": dict(bare.most_common())}


def main(argv=None):
    import argparse
    t_start = time.perf_counter()
    root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root), str(root / "src")]
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--cost-slots", type=int, default=0)
    ap.add_argument("--sync-debug", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from h100bench import host
    host.one_thread()
    import torch
    from h100bench import harness
    if not torch.cuda.is_available():
        harness.log("no CUDA device: no result")
        return 2
    extra = {}

    def stretch(driver, n, sync):
        if args.cost_slots:
            extra["cost_before"] = tracer_cost(driver, args.cost_slots)
        out = traced_slots(driver, n, sync)
        if args.cost_slots:
            extra["cost_after"] = tracer_cost(driver, args.cost_slots)
        if args.sync_debug:
            extra["sync_debug"] = sync_debug_slots(driver, n)
        return out

    harness.device_slots = stretch
    result = harness.run_cell(args.workload, args.seed, args.seconds, True,
                              t_start=t_start)
    idle = result["record"]["idle"]
    tr = idle and idle.get("trace")
    readings = {k: f(tr) for k, f in READINGS.items()}
    cov = tr["step_coverage"] if tr else []
    summary = {
        "workload": args.workload, "seed": args.seed,
        "correct": result["correct"],
        "device": torch.cuda.get_device_name(0),
        "readings": readings,
        "metrics": {k: v["value"] for k, v in result["metrics"].items()},
        "slots": tr and tr["slots"], "wall_s": idle and idle["wall_s"],
        "offset_ns": tr and tr["offset_ns"],
        "offset_err_ns": tr and tr["offset_err_ns"],
        "drift_ns": tr and tr["drift_ns"],
        "idle_s": tr and tr["idle_s"],
        "idle_by_span": tr and tr["idle_by_span"],
        "step_coverage_min": min(cov) if cov else None,
        "span_cost_ns": span_cost_ns(), **extra}
    if "sync_debug" in extra:
        ps = extra["sync_debug"]["per_slot"]
        summary["sync_debug_per_slot"] = sum(r for r, _ in ps) / len(ps)
        summary["sync_spans_per_slot"] = sum(s for _, s in ps) / len(ps)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {**summary, "trace": tr}, default=str))
    for k in ("cost_before", "cost_after"):
        if k in summary:
            summary[k] = {a: b for a, b in summary[k].items() if a != "slots"}
    print(json.dumps(summary, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
