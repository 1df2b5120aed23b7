"""One run of one cell of ``BENCHMARK.json`` against the PyTorch port.

Everything a cell needs is found by name: its configuration file (the
``file`` of its ``configs`` entry), its traffic file
(``<bench>/traffic/<traffic>.json``), the reader of each of its metrics
(``<bench>/metrics/<metric>.py``, a ``read(record)`` that returns a number
or None), and for each model of the configuration (``llm`` and each of
``ssms``) its architecture module (``<bench>/arch/<arch>.py``: the port's
config, the weights' layout and the model FLOPs; ``arch`` is the model
entry's ``"arch"``, ``decoder`` where it names none) and its reference
(``<bench>/reference/<reference>.py``; the model entry's ``"reference"``,
else the configuration's), where ``<bench>`` is the first of ``paths``.
A later cell, mix, metric or model adds files and entries; it edits none
of these.

A run: set-up (the CUDA context, the weights made on the device from the
seed, the port's kernels #1/#2 built or loaded, ``SpinEngine`` built, the
traffic's warm-up slots), then the measured window, in which the traffic's
loop drives ``SpinEngine.add_requests`` and ``SpinEngine.step`` until
``seconds`` have passed (the card synchronized at both ends), then the
check against the reference, then one result line.

An untraced run on the card serves its window in stretches of
``STRETCH_SLOTS`` slots, each under a profile of the device's activity
alone, for the device's busy time over the whole window; the stretches'
events are read after the window closes.

A traced run measures its window with nothing profiled (no span
synchronizes; the shapes of every forward are noted
for the model FLOPs, which are summed after the window closes), and after
it serves three more stretches of the same traffic: ``span_slots`` slots
with the harness's spans synchronized at both ends and timed,
``idle_slots`` slots under a profile of the device's activity alone, and
``trace_slots`` slots under a full profile (host ranges, the device, and
the kernel entry points each reader names in ``CAPTURE``).
"""

from __future__ import annotations

import bisect
import gc
import heapq
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from h100bench import check, latency, traffic as TR, weights as W, work

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
KERNELS = ("fused_verify", "fused_decode")
# the engine's methods the harness times in a traced run, by span name
SPANS = {"admit_prefill": "_begin_admit", "ssm_place": "_place_on_ssm",
         "draft": "_draft_pool", "verify": "_verify"}
# slots a stretch of the untraced window is profiled for: the profiler
# keeps at most 128 MB of device records, some ten slots' operations of
# these cells (about 35 thousand a slot)
STRETCH_SLOTS = 4


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "h100bench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell's entry, configuration, traffic and metric entries."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    home = root / bench["paths"][0]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return dict(bench=bench, cell=cell, home=home,
                config=json.loads((root / conf["file"]).read_text()),
                traffic=json.loads(
                    (home / "traffic" / f"{cell['traffic']}.json")
                    .read_text()),
                end_to_end=e2e, per_layer=layer)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def model_module(spec: dict, m: dict, kind: str):
    """Model ``m``'s architecture module (``kind`` "arch") or reference
    module (``kind`` "reference"), by the name its entry gives, else the
    default: ``decoder``, or the configuration's ``reference``."""
    default = "decoder" if kind == "arch" else spec["config"]["reference"]
    return load_module(spec["home"] / kind / f"{m.get(kind, default)}.py")


class Rec:
    """One request as its client sees it (host clock, seconds)."""
    __slots__ = ("rid", "handoff", "first", "last", "n", "finished",
                 "prompt_len", "client")

    def __init__(self, rid, handoff, prompt_len, client):
        self.rid, self.handoff, self.prompt_len = rid, handoff, prompt_len
        self.client = client
        self.first = self.last = self.finished = None
        self.n = 0


class Driver:
    """The traffic's loop over the engine: closed (each client's next
    request handed off ``think_s`` after its previous one finished) or
    open (requests handed off at their due times).  After every call into
    the engine it stamps the wall time of each newly emitted token."""

    def __init__(self, eng, stream, traffic, Request, known, seed, sync):
        self.eng, self.stream, self.traffic = eng, stream, traffic
        self.Request, self.sync = Request, sync
        self.groups, self.prompt_lens = known
        self.loop = traffic["loop"]
        self.closed = self.loop["kind"] == "closed"
        self.recs, self.live = {}, {}
        self.due = []                 # heap of (due, seq, client, item)
        self.seq = 0
        self.window = None            # (t0, t1) once open
        self.window_tokens = 0
        self.late = []                # open loop: hand-off - due, seconds
        self.slot_s = []              # window: each step's wall seconds
        self.slot_adm = []            # window: each step's hand-offs
        if self.closed:
            for c, item in enumerate(TR.first_wave(traffic, stream, seed)):
                self._push(0.0, c, item)
        else:
            self.offsets = TR.arrival_offsets(
                traffic, int(self.loop.get("schedule", 20000)), seed)
            self.next_open = 0
            self.t_open = None

    def _push(self, due, client, item):
        heapq.heappush(self.due, (due, self.seq, client, item))
        self.seq += 1

    def _open_schedule(self, now):
        if self.t_open is None:
            self.t_open = now
        while (self.next_open < len(self.offsets)
               and self.t_open + self.offsets[self.next_open] <= now):
            self._push(self.t_open + self.offsets[self.next_open], None,
                       self.stream.next())
            self.next_open += 1

    def _handoff(self, now):
        """Hands off every request due by ``now``; returns how many (the
        port admits each inside ``add_requests``, its prefills included)."""
        if not self.closed:
            self._open_schedule(now)
        n = 0
        while self.due and self.due[0][0] <= now:
            due, _, client, item = heapq.heappop(self.due)
            if self.closed and due == 0.0:
                due = now             # the first wave starts now
            r = self.Request(rid=item.index, dataset=item.cls,
                             difficulty=item.difficulty, prompt=item.prompt,
                             max_new=item.max_new,
                             arrival=self.eng.sim_time, emitted=[])
            self.groups[r.rid] = item.cls
            self.prompt_lens[r.rid] = len(item.prompt)
            rec = Rec(r.rid, due, len(item.prompt), client)
            self.recs[r.rid] = rec
            self.live[r.rid] = r
            if not self.closed:
                self.late.append(now - due)
            self.eng.add_requests([r])
            self._stamp(r, rec, time.perf_counter())
            n += 1
        return n

    def _stamp(self, r, rec, now):
        n = len(r.emitted or [])
        if n > rec.n:
            if rec.first is None:
                rec.first = now
            if self.window is not None and self.window[1] is None:
                self.window_tokens += n - rec.n
            rec.n, rec.last = n, now
        if r.done:
            rec.finished = now
            del self.live[r.rid]
            if self.closed:
                self._push(now + float(self.loop.get("think_s", 0.0)),
                           rec.client, self.stream.next())

    def step(self):
        """Hand off what is due, run one engine step, stamp its tokens;
        waits for the next due time when nothing is in flight."""
        t = time.perf_counter()
        admitted = self._handoff(t)
        out = self.eng.step()
        now = time.perf_counter()
        for rid, r in list(self.live.items()):
            self._stamp(r, self.recs[rid], now)
        if self.window is not None and self.window[1] is None \
                and not out.get("done"):
            self.slot_s.append(time.perf_counter() - t)
            self.slot_adm.append(admitted)
        if out.get("done") and self.due:
            time.sleep(max(0.0, min(self.due[0][0] - now, 0.05)))
        elif out.get("done") and not self.closed:
            time.sleep(0.001)
        return out

    def run_slots(self, n):
        done = 0
        while done < n:
            if not self.step().get("done"):
                done += 1
        return done

    def open_window(self):
        self.sync()
        t0 = time.perf_counter()
        self.window = (t0, None)
        return t0

    def close_window(self):
        self.sync()
        t1 = time.perf_counter()
        self.window = (self.window[0], t1)
        return t1


class Probe:
    """The harness's wrappers around the engine.  In the window (``on``):
    the draft events for the check, and in a traced run the shapes of
    every forward (``shapes``: (model, cached, new tokens), read from host
    state; their FLOPs are summed after the window).  While ``timing``:
    spans synchronized at both ends and timed; while ``ranges``: spans as
    ``record_function`` ranges alone, for a profile."""

    def __init__(self, eng, traced, sync):
        self.eng, self.traced, self.sync = eng, traced, sync
        self.on = self.timing = self.ranges = False
        self.drafts = []              # (ssm, rid, emitted count, tokens)
        self.spans = {name: [0.0, 0] for name in SPANS}
        self.shapes = []
        for name, attr in SPANS.items():
            setattr(eng, attr, self._wrap(name, getattr(eng, attr)))
        if traced:
            eng.switcher.switch = self._switch(eng.switcher.switch)

    def _wrap(self, name, fn):
        count = getattr(self, "_count_" + name, None)
        record = name == "draft"

        def wrapper(*args, **kw):
            if self.on and count is not None and self.traced:
                count(*args)
            if self.timing:
                self.sync()
                t = time.perf_counter()
                with torch.profiler.record_function("h100bench::" + name):
                    out = fn(*args, **kw)
                self.sync()
                s = self.spans[name]
                s[0] += time.perf_counter() - t
                s[1] += 1
            elif self.ranges:
                with torch.profiler.record_function("h100bench::" + name):
                    out = fn(*args, **kw)
            else:
                out = fn(*args, **kw)
            if record and self.on:
                self._record_draft(args[0], args[2], out)
            return out
        return wrapper

    def _record_draft(self, j, depths, cand):
        eng = self.eng
        for rid, row in eng.ssm_pools[j].row_of.items():
            if rid in depths and eng.assignment.get(rid) == j:
                self.drafts.append((j, rid, len(eng.requests[rid].emitted),
                                    cand[row, :depths[rid]].copy()))

    # the real tokens of each forward (bucket padding and idle pool rows
    # left out), read from host state before the call
    def _count_admit_prefill(self, r):
        L = r.prompt_len + max(0, len(r.emitted or []) - 1)
        self.shapes.append((0, 0, L))

    def _count_draft(self, j, width, depths):
        eng, pool = self.eng, self.eng.ssm_pools[j]
        for rid, row in pool.row_of.items():
            if rid in depths and eng.assignment.get(rid) == j:
                self.shapes.append((j + 1, int(pool.lengths[row]), width))

    def _count_verify(self, ids, drafts, depths):
        eng = self.eng
        W_ = max(depths[rid] for rid in ids)
        for rid in ids:
            L = int(eng.llm_pool.lengths[eng.llm_pool.row_of[rid]])
            self.shapes.append((0, L, W_ + 1))
            j = eng.assignment.get(rid)
            pool = eng.ssm_pools[j] if j is not None else None
            if pool is not None and pool.has(rid):
                Ls = int(pool.lengths[pool.row_of[rid]])
                self.shapes.append((j + 1, Ls + 1, W_ + 1))

    def _switch(self, fn):
        """The SSM prefill of a placement (every admission's, and any
        switch's): the tokens the switcher recomputes."""
        sw = self.eng.switcher

        def wrapper(rid, dst, tokens, length, max_len):
            before = sw.recompute_tokens
            out = fn(rid, dst, tokens, length, max_len)
            n = sw.recompute_tokens - before
            if self.on and n:
                self.shapes.append((dst + 1, length - n, n))
            return out
        return wrapper

    def flops(self, models, archs):
        return sum(archs[m].flops(models[m], start, n)
                   for m, start, n in self.shapes)


class Capture:
    """A kernel entry point wrapped in a ``record_function`` range; while
    ``on``, each call's shapes and small index tensors are kept for the
    work functions (large tensors as meta tensors of their shape)."""

    def __init__(self, module, attr):
        import inspect
        self.module, self.attr = module, attr
        self.fn = getattr(module, attr)
        self.sig = inspect.signature(self.fn)
        self.calls, self.on = [], False
        self.range = "h100bench::" + attr

    def __call__(self, *args, **kw):
        if self.on:
            b = self.sig.bind(*args, **kw)
            self.calls.append({
                k: (v if not isinstance(v, torch.Tensor) or v.numel() < 1 << 16
                    else torch.empty(v.shape, dtype=v.dtype, device="meta"))
                for k, v in b.arguments.items()})
        with torch.profiler.record_function(self.range):
            return self.fn(*args, **kw)

    def __enter__(self):
        setattr(self.module, self.attr, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.fn)


def _device_spans(raw):
    """(start us, end us, name) of each device operation among the
    profiler's raw events, sorted, and the device time (us) of each
    annotated range."""
    from torch.autograd import DeviceType
    spans, annotated = [], {}
    for e in raw:
        if e.device_type() != DeviceType.CUDA:
            continue
        name = e.name()
        if e.is_user_annotation() or name.startswith(work.ANNOTATIONS):
            annotated[name] = annotated.get(name, 0.0) + e.duration_ns() / 1e3
        else:
            spans.append((e.start_ns() / 1e3, e.end_ns() / 1e3, name))
    spans.sort()
    return spans, annotated


def _top_ops(per_name):
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:10]
    return [[k[:96], ms / 1e3] for k, (ms, _) in top]


def device_slots(driver, n, sync):
    """``n`` slots under a profile of the device's activity alone: no host
    op is traced, so the host runs them as fast as the window's.  Returns
    the union of the device's activity (s), the slots' wall seconds and
    the device's ops by time, or None where no device op was read."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.perf_counter()
        done = driver.run_slots(n)
        sync()
        t1 = time.perf_counter()
    spans, _ = _device_spans(prof.profiler.kineto_results.events())
    if not spans:
        log("device profile: no device operation read")
        return None
    busy_ms, per_name = work.device_time(spans)
    log(f"device profile: {done} slots in {t1 - t0:.3f} s, "
        f"{len(spans)} device ops, busy {busy_ms:.1f} ms")
    return {"busy_s": busy_ms / 1e3, "wall_s": t1 - t0, "slots": done,
            "device_ops": _top_ops(per_name)}


def device_stretch(driver, n, sync, until=None):
    """Serves ``n`` slots, or fewer where the clock passes ``until``, under
    a profile of the device's activity alone, synchronized before it
    stops; returns (slots, the profiler's raw results), read later."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        done = 0
        while done < n and (until is None or time.perf_counter() < until):
            if not driver.step().get("done"):
                done += 1
        sync()
    return done, prof.profiler.kineto_results


def busy_window(driver, t0, seconds, sync):
    """Serves the window from ``t0`` until ``seconds`` have passed, in
    stretches of ``STRETCH_SLOTS`` slots, so that every device operation
    of the window falls in one of them; returns the stretches."""
    stretches = []
    while time.perf_counter() - t0 < seconds:
        stretches.append(device_stretch(driver, STRETCH_SLOTS, sync,
                                        until=t0 + seconds))
    return stretches


def window_busy_s(stretches):
    """The union of the device's activity over the window's stretches, in
    seconds, or None where no device operation was read."""
    busy_ms, ops = 0.0, []
    for done, res in stretches:
        spans, _ = _device_spans(res.events())
        busy_ms += work.device_time(spans)[0]
        if done:
            ops.append(len(spans) / done)
    log(f"window device profile: {len(stretches)} stretches, busy "
        f"{busy_ms:.1f} ms, device ops a slot "
        + (f"{min(ops):.0f}-{max(ops):.0f}" if ops else "none"))
    return busy_ms / 1e3 if busy_ms > 0 else None


def profile_slots(driver, captures, n, sync):
    """``n`` slots under a full profile (host ranges and the device);
    returns the profile part of the record.  The profiler's raw events are
    read (not its event tree, which takes minutes to build for the
    millions of host ops of a slot)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        sync()
        t0 = time.perf_counter()
        for c in captures:
            c.on = True
        for _ in range(n):
            with torch.profiler.record_function("h100bench::step"):
                driver.run_slots(1)
        sync()
        t1 = time.perf_counter()
        for c in captures:
            c.on = False
    t_read = time.perf_counter()
    raw = prof.profiler.kineto_results.events()
    spans, annotated = _device_spans(raw)
    host = [(e.start_ns() / 1e3, e.end_ns() / 1e3, e.name()[11:])
            for e in raw if e.device_type() == DeviceType.CPU
            and e.name().startswith("h100bench::")]
    steps = [(a, b) for a, b, nm in host if nm == "step"]
    w0 = min((a for a, _ in steps), default=0.0)
    w1 = max((b for _, b in steps), default=0.0)
    busy_ms, per_name = work.device_time(
        [(max(a, w0), min(b, w1), nm) for a, b, nm in spans
         if b > w0 and a < w1])
    ranges = {}
    for c in captures:
        dev = annotated.get(c.range, 0.0)
        ranges[c.attr] = {"device_s": dev / 1e6, "calls": c.calls}
        log(f"range {c.range}: {len(c.calls)} calls, {dev / 1e3:.3f} "
            f"device ms")
    # idle gaps by the engine span the host was in at their midpoint
    inner = sorted((a, b, nm) for a, b, nm in host if nm in SPANS)
    starts = [a for a, _, _ in inner]
    idle = {}
    for a, b in work.idle_gaps(spans, w0, w1):
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid) - 1
        key = inner[i][2] if i >= 0 and inner[i][1] >= mid else "step_other"
        idle[key] = idle.get(key, 0.0) + (b - a) / 1e6
    log(f"profile: {len(raw)} events read in "
        f"{time.perf_counter() - t_read:.1f} s")
    return {"busy_s": busy_ms / 1e3, "window_s": t1 - t0,
            "trace_window_s": (w1 - w0) / 1e6, "ranges": ranges,
            "device_ops": _top_ops(per_name),
            "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                                key=lambda kv: -kv[1])[:10]}


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             root: Path = ROOT, device: str = "cuda", t_start=None,
             control: bool = False, patch=None, slots=None) -> dict:
    """One run of cell ``name``; returns the result dict (``record`` and
    ``checks`` included).  ``control`` judges the control in the
    program's place (``checks`` and ``correct`` are then the control's;
    ``program`` and ``program_correct`` the program's).  ``patch(engine)``
    may alter the engine after it is built (the tests' planted faults);
    ``slots`` ends the window after that many engine slots instead of
    ``seconds`` (the CPU tests: a run that does the same work however
    loaded the host is)."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = load_cell(name, root)
    cfg, traffic = spec["config"], spec["traffic"]
    serving = cfg["serving"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    parts = {}
    t = time.perf_counter()
    from repro_torch.core import spec_decode as sd
    from repro_torch.data.workloads import Request
    from repro_torch.kernels import build
    from repro_torch.launch.serve import make_selector
    from repro_torch.serving.engine import EngineConfig, SpinEngine
    if cuda:
        torch.cuda.init()
        torch.empty(1, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
    parts["import_context"] = time.perf_counter() - t_start

    t = time.perf_counter()
    models = [cfg["llm"]] + list(cfg["ssms"])
    archs = [model_module(spec, m, "arch") for m in models]
    dtype = getattr(torch, serving["dtype"])
    params = [W.make(a.layout(m, cfg["init"]), W.model_seed(seed, i), dev,
                     dtype)
              for i, (m, a) in enumerate(zip(models, archs))]
    sync()
    parts["weights"] = time.perf_counter() - t

    t = time.perf_counter()
    if cuda and serving["fused_kernels"] == "on":
        build.build_all(KERNELS)
        for k in KERNELS:
            build.load(k)
    parts["kernels"] = time.perf_counter() - t

    t = time.perf_counter()
    bundles = [sd.Bundle(a.port_config(m, serving["dtype"]), p)
               for m, a, p in zip(models, archs, params)]
    loop = traffic["loop"]
    capacity = int(traffic["engine"]["capacity"])
    stream = TR.Stream(traffic, cfg["llm"]["vocab_size"], seed)
    # non-empty, so that the selector keeps these dicts, which the driver
    # fills as requests arrive
    groups, prompt_lens = {-1: "none"}, {-1: 0}
    ecfg = EngineConfig(
        gamma=int(serving["gamma"]), gamma_policy=serving["gamma_policy"],
        max_len=int(traffic["engine"]["max_len"]), capacity=capacity,
        use_packed_verify=bool(serving["use_packed_verify"]),
        use_pipeline=bool(serving["use_pipeline"]),
        seed=int(seed) % 2**31, kv_layout=serving["kv_layout"],
        block_size=int(serving["block_size"]),
        prefill_chunk=int(traffic["engine"]["prefill_chunk"]),
        fused_kernels=serving["fused_kernels"],
        kv_dtype=serving["kv_dtype"])
    # the launcher's selector: every SSM's batch limit is the capacity
    selector = make_selector(serving["selector"], len(bundles) - 1,
                             capacity, prompt_lens, int(seed) % 2**31,
                             group_of=groups)
    eng = SpinEngine(bundles[0], bundles[1:], selector, ecfg)
    if patch is not None:
        patch(eng)
    probe = Probe(eng, trace, sync)
    driver = Driver(eng, stream, traffic, Request, (groups, prompt_lens),
                    seed, sync)
    parts["engine"] = time.perf_counter() - t

    t = time.perf_counter()
    warm = int(traffic["warmup_slots"])
    profiled = cuda and not trace and slots is None
    driver.run_slots(warm - 1 if profiled else warm)
    if profiled:
        # the last warm-up slot starts and stops the profiler once, as
        # each stretch of the window does
        device_stretch(driver, 1, sync)
    sync()
    parts["warmup"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    log("setup " + " ".join(f"{k} {v:.3f} s" for k, v in parts.items())
        + f"; total {setup_s:.3f} s")

    slot0 = len(eng.slot_log)
    t0 = driver.open_window()
    probe.on = True
    stretches = None
    if profiled:
        stretches = busy_window(driver, t0, seconds, sync)
    elif slots is None:
        while time.perf_counter() - t0 < seconds:
            driver.step()
    else:
        driver.run_slots(slots)
    t1 = driver.close_window()
    probe.on = False
    window_slots = eng.slot_log[slot0:]
    log(f"window {t1 - t0:.3f} s, {len(window_slots)} slots, "
        f"{driver.window_tokens} tokens; " + window_summary(driver, t0, t1))
    flops = span_slots = idle = prof = None
    busy_s = window_busy_s(stretches) if stretches else None
    if trace:
        flops = probe.flops(models, archs)
        probe.timing = True
        span_slots = driver.run_slots(int(traffic["span_slots"]))
        probe.timing = False
        if cuda:
            idle = device_slots(driver, int(traffic["idle_slots"]), sync)
        readers = [load_module(spec["home"] / "metrics" / f"{m['name']}.py")
                   for m in spec["per_layer"]]
        targets = {tuple(r.CAPTURE) for r in readers if hasattr(r, "CAPTURE")}
        captures = []
        for mod_name, attr in sorted(targets):
            module = importlib.import_module(mod_name)
            captures.append(Capture(module, attr).__enter__())
        probe.ranges = True
        try:
            prof = profile_slots(driver, captures,
                                 int(traffic["trace_slots"]), sync)
        finally:
            probe.ranges = False
            for c in captures:
                c.__exit__()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    record = {
        "setup_s": setup_s, "setup": parts, "window": (t0, t1),
        "window_s": t1 - t0,
        "slots": [dict(s) for s in window_slots],
        "window_tokens": driver.window_tokens, "window_busy_s": busy_s,
        "requests": list(driver.recs.values()), "late_s": driver.late,
        "spans": probe.spans if trace else None, "span_slots": span_slots,
        "flops": flops, "idle": idle,
        "profile": prof, "memory_peak_bytes": peak,
    }
    attempted = sum(1 for r in driver.recs.values() if t0 <= r.handoff < t1)
    finished = [eng.requests[r.rid] for r in driver.recs.values()
                if r.finished is not None and t0 <= r.finished <= t1]
    drafts = probe.drafts
    served = {r.rid: (np.asarray(r.prompt), list(r.emitted))
              for r in eng.requests.values()}
    del eng, driver, probe, selector, bundles
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    program, ctrl = judge(spec, params, finished, served, drafts, seed,
                          control)
    program_ok = all(v <= lim for v, lim in program.values())
    # with ``control``, the control is put in the program's place: its
    # readings of the same numbers are judged against the same limits
    checks = ({k: (ctrl.get(k, v), lim) for k, (v, lim) in program.items()}
              if control else program)
    correct = all(v <= lim for v, lim in checks.values())
    result = {"correct": bool(correct),
              "attempted": attempted, "failed": 0}
    metrics = spec["per_layer"] if trace else spec["end_to_end"]
    values = {}
    for m in metrics:
        reader = load_module(spec["home"] / "metrics" / f"{m['name']}.py")
        v = reader.read(record)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result["metrics"] = values
    result["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": 1, "memory_peak_bytes": int(peak)}
    if trace and prof is not None:
        # the device's busy time over the wall time of the same slots,
        # from the profile of the device alone where it read any
        dev_p = ({"busy_s": idle["busy_s"], "window_s": idle["wall_s"],
                  "device_ops": idle["device_ops"]} if idle else prof)
        result["device"]["busy_s"] = dev_p["busy_s"]
        result["device"]["window_s"] = dev_p["window_s"]
        result["breakdown"] = {"device_ops": dev_p["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    result["record"] = record
    if control:
        result["program"] = {k: {"value": v, "limit": lim}
                             for k, (v, lim) in program.items()}
        result["program_correct"] = bool(program_ok)
    return result


def window_summary(driver, t0, t1) -> str:
    """Quantiles of the window's request latencies, the host's load, and
    each slot's wall seconds with the requests handed off (admitted) in
    it, for the log."""
    rec = {"window": (t0, t1), "requests": list(driver.recs.values())}
    ttft, tpot = latency.ttft(rec), latency.tpot(rec)

    def q(xs):
        if not xs:
            return "none"
        return "p50 %.1f p90 %.1f ms" % tuple(np.percentile(xs, [50, 90]))
    load = " ".join(f"{x:.2f}" for x in os.getloadavg())
    return (f"ttft {q(ttft)} over {len(ttft)}; "
            f"tpot {q(tpot)} over {len(tpot)}; host load {load}; "
            "slots s/admitted " + " ".join(
                f"{x:.3f}/{a}" for x, a in zip(driver.slot_s,
                                               driver.slot_adm)))


def judge(spec, params, finished, served, drafts, seed, control):
    """The program's numbers compared, each with its limit: {name:
    (value, limit)}; and with ``control`` the control's readings of the
    same numbers, {name: value}."""
    cfg = spec["config"]
    lim = cfg["check"]
    rng = np.random.default_rng([int(seed), 0xC4EC])
    models = [cfg["llm"]] + list(cfg["ssms"])
    refs = [model_module(spec, m, "reference") for m in models]
    checks, ctrl = {}, {}
    if not finished:
        checks["finished_requests"] = (0.0, -1.0)
        return checks, ctrl
    seqs = []
    for i in check.pick([len(r.emitted) for r in finished],
                        int(lim["sample_requests"]), rng):
        prompt, emitted = served[finished[i].rid]
        seqs.append((np.concatenate([prompt, emitted]), len(prompt)))
    gap, n, cgap = check.widest_gap(refs[0], params[0], models[0], seqs,
                                    control)
    log(f"llm_gap over {len(seqs)} requests, {n} served tokens")
    checks["llm_gap"] = (gap, float(lim["llm_gap"]))
    if control:
        ctrl["llm_gap"] = cgap
    worst, cworst, total = 0.0, 0.0, 0
    for j in range(len(models) - 1):
        events = [e for e in drafts if e[0] == j]
        if not events:
            continue
        seqs = []
        for i in check.pick([e[2] + len(served[e[1]][0]) for e in events],
                            int(lim["sample_drafts"]), rng):
            _, rid, n_emitted, toks = events[i]
            prompt, emitted = served[rid]
            ctx = np.concatenate([prompt, emitted[:n_emitted]])
            seqs.append((np.concatenate([ctx, toks]), len(ctx)))
        gap, n, cgap = check.widest_gap(refs[j + 1], params[j + 1],
                                        models[j + 1], seqs, control)
        total += n
        worst = max(worst, gap)
        if cgap is not None:
            cworst = max(cworst, cgap)
    log(f"draft_gap over {total} drafted tokens")
    checks["draft_gap"] = (worst, float(lim["draft_gap"]))
    if control:
        ctrl["draft_gap"] = cworst
    return checks, ctrl


def result_line(result: dict) -> str:
    """The contract's last line: the checks' key last."""
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    if "breakdown" in result:
        keys.append("breakdown")
    out = {k: result[k] for k in keys}
    out["checks"] = result["checks"]
    return json.dumps(out)
