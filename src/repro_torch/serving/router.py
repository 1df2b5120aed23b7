"""Multi-replica serving: an elastic router in front of N engines.

The scaling unit is the **replica**: an independent ``SpinEngine`` and
``ContinuousScheduler`` pair.  Replicas share model weights (the
``Bundle`` objects are read-only) but own disjoint KV pools, selectors,
schedulers and sim clocks.  Each replica may be given a sub-mesh of the
serving mesh (``launch/mesh.py`` ``replica_submeshes``) and a rule table
(``distributed/sharding.py``): its steps then run under that sub-mesh's
rules.  With fewer cards than replicas (one H100) every sub-mesh is the
1x1 mesh of the card the fleet shares, and the model's plain tensors are
already laid out there.

The ``Router`` owns the global arrival stream and hands each request to a
replica at its arrival instant:

* ``lot``: least outstanding tokens (remaining context plus remaining
  output over everything queued or running there);
* ``p2c``: power of two choices on free KV cells, two distinct replicas
  drawn from a seeded host-side numpy generator;
* ``slo``: most SLO headroom (slack to the most urgent deadline net of
  the estimated backlog drain time).

Ties break toward the lower replica index.  Each replica advances its own
sim clock; the router always steps the replica furthest behind, and
dispatches pending arrivals once that clock reaches them.

The elastic control plane reshapes the fleet while it serves:
``autoscale="target-occupancy"`` activates standby replicas under
pressure and drains idle ones (drain-before-retire); ``steal`` migrates
queued, rowless requests from the hottest replica to the least loaded one
when re-prefilling there beats waiting; replica classes
(``parse_replica_classes``, ``class_engine_config``) carve prefill and
decode engines and steer requests by shape.  With ``autoscale="off"`` and
no classes the control plane never runs.  All of it is host-side
bookkeeping, the reference's algorithm line for line, so a port fleet
dispatches, steals and scales exactly as the reference's does on the same
engines' state.
"""

from __future__ import annotations

import contextlib
import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.data.workloads import Request
from repro_torch.distributed.sharding import use_rules
from repro_torch.serving.engine import EngineConfig, SpinEngine
from repro_torch.serving.stats import (FleetStats, ReplicaStats,
                                       expected_time_per_token, slo_summary)

POLICIES = ("lot", "p2c", "slo")
AUTOSCALE_MODES = ("off", "target-occupancy")
REPLICA_CLASSES = ("general", "prefill", "decode")
# Relative KV-budget weights when serve.py splits the aggregate
# ``--kv-budget`` across a heterogeneous fleet: decode replicas hold
# long-lived contexts (big KV), prefill replicas turn theirs over per
# chunk and hand requests off.
CLASS_KV_WEIGHTS = {"general": 2, "prefill": 1, "decode": 3}


def parse_replica_classes(spec: str) -> List[str]:
    """Parse a ``--replica-classes`` spec into one class name per
    replica: ``"prefill:1,decode:3"`` → ``['prefill', 'decode',
    'decode', 'decode']``.  An omitted count means 1; the empty spec
    means a homogeneous (class-free) fleet and returns ``[]``."""
    if not spec or not spec.strip():
        return []
    out: List[str] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, cnt = part.partition(":")
        name = name.strip()
        if name not in REPLICA_CLASSES:
            raise ValueError(
                f"unknown replica class {name!r} in {spec!r} "
                f"(choose from {', '.join(REPLICA_CLASSES)})")
        if cnt.strip():
            try:
                n = int(cnt)
            except ValueError:
                raise ValueError(
                    f"bad replica count {cnt!r} for class {name!r} "
                    f"in {spec!r}") from None
        else:
            n = 1
        if n < 1:
            raise ValueError(
                f"replica class counts must be >= 1 (got {name}:{n})")
        out.extend([name] * n)
    if not out:
        raise ValueError(f"empty --replica-classes spec {spec!r}")
    return out


def class_engine_config(base: EngineConfig, cls: str) -> EngineConfig:
    """Carve a per-class engine config from the fleet-wide base.

    ``prefill`` replicas absorb long prompts: chunked ingestion is
    forced on and the per-slot token budget doubled so chunk grants
    dominate the step plan (adaptive speculation is capped shallow by
    the engine's ``replica_class`` wiring).  ``decode`` replicas keep
    the base knobs — their edge is the larger KV share serve.py carves
    via :data:`CLASS_KV_WEIGHTS` (long-resident contexts, deep gamma
    already granted by the adaptive controller).  ``general`` is the
    base config, tagged."""
    if cls not in REPLICA_CLASSES:
        raise ValueError(f"unknown replica class {cls!r}")
    if cls == "prefill":
        return dataclasses.replace(
            base, replica_class="prefill",
            prefill_chunk=base.prefill_chunk if base.prefill_chunk > 0
            else 32,
            token_budget=(base.token_budget * 2
                          if base.token_budget else None))
    return dataclasses.replace(base, replica_class=cls)


@dataclasses.dataclass(kw_only=True)
class RouterConfig:
    """Keyword-only like the other serving configs (fields are appended
    as the router grows)."""

    policy: str = "lot"
    seed: int = 0          # p2c probe sampling (lot/slo are sample-free)
    # elastic control plane: "off" = the pre-elastic router, bit-identical
    # tokens and sim-clock stats; "target-occupancy" = scale the active
    # set between replicas_min and replicas_max against mean KV occupancy
    # / backlog / SLO headroom, with drain-before-retire.
    autoscale: str = "off"
    replicas_min: int = 1
    replicas_max: Optional[int] = None    # None -> every engine provided
    # work stealing of queued (rowless) requests: "auto" = on exactly
    # when autoscaling is (the default keeps --autoscale off
    # bit-identical), "on"/"off" force it.
    steal: str = "auto"
    # --replica-classes spec (validated here; serve.py carves the
    # per-class EngineConfigs, the router reads each engine's tag)
    classes: str = ""
    # target-occupancy thresholds: scale up when mean active KV occupancy
    # crosses occ_high (or backlog/SLO pressure appears), drain when it
    # falls under occ_low with an empty backlog.
    occ_high: float = 0.80
    occ_low: float = 0.25
    # min sim-seconds between scale actions (flap damping)
    cooldown: float = 0.05
    # steal only when the source's expected wait exceeds the target's by
    # this multiple of the re-prefill cost (0 = any positive saving)
    steal_margin: float = 1.0

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"unknown router policy {self.policy!r}")
        if self.autoscale not in AUTOSCALE_MODES:
            raise ValueError(
                f"unknown autoscale mode {self.autoscale!r} "
                f"(choose from {', '.join(AUTOSCALE_MODES)})")
        if self.steal not in ("auto", "on", "off"):
            raise ValueError(f"steal must be auto|on|off, got {self.steal!r}")
        if self.replicas_min < 1:
            raise ValueError("replicas_min must be >= 1")
        if self.replicas_max is not None \
                and self.replicas_max < self.replicas_min:
            raise ValueError("replicas_max must be >= replicas_min")
        if not 0.0 <= self.occ_low < self.occ_high <= 1.0:
            raise ValueError(
                "need 0 <= occ_low < occ_high <= 1 "
                f"(got {self.occ_low}, {self.occ_high})")
        if self.cooldown < 0:
            raise ValueError("cooldown must be >= 0")
        if self.steal_margin < 0:
            raise ValueError("steal_margin must be >= 0")
        parse_replica_classes(self.classes)  # validate the spec shape

    @classmethod
    def from_args(cls, args):
        """Build a RouterConfig from a ``launch.serve.build_parser()``
        namespace (``--router-policy`` unset means the default policy,
        routed or not — serve.py decides whether a router exists)."""
        return cls(policy=args.router_policy or "lot", seed=args.seed,
                   autoscale=getattr(args, "autoscale", "off"),
                   replicas_min=getattr(args, "replicas_min", 1),
                   replicas_max=getattr(args, "replicas_max", None),
                   steal=getattr(args, "steal", "auto"),
                   classes=getattr(args, "replica_classes", "") or "")


class Router:
    """Dispatches a global request stream across engine replicas.

    ``submeshes`` / ``rules`` are optional: when given (one sub-mesh per
    replica, from ``launch.mesh.replica_submeshes``, plus a
    ``distributed.sharding`` rule table), every replica step runs inside
    ``use_rules(submeshes[i], rules)`` so the model forward's sharding
    constraints resolve against that replica's own device slice.  Without
    them ``constrain`` is a no-op and every replica runs on its bundles'
    device.

    With ``cfg.autoscale != "off"`` the router is the elastic control
    plane: ``engines`` is the pre-built maximum fleet, of which the first
    ``replicas_min`` start ``active`` and the rest ``standby`` until the
    autoscaler provisions them.
    """

    def __init__(self, engines: Sequence[SpinEngine],
                 cfg: Optional[RouterConfig] = None, *,
                 submeshes=None, rules=None):
        if not engines:
            raise ValueError("router needs at least one replica engine")
        self.engines = list(engines)
        self.cfg = cfg or RouterConfig()
        if submeshes is not None and len(submeshes) != len(self.engines):
            raise ValueError(
                f"{len(submeshes)} sub-meshes for {len(self.engines)} "
                "replicas — carve one per replica (launch.mesh."
                "replica_submeshes)")
        self.submeshes = submeshes
        self.rules = rules
        self._rng = np.random.default_rng(self.cfg.seed)
        self._pending: List = []           # heap of (arrival, seq, Request)
        self._seq = 0
        self.dispatched_to: Dict[int, int] = {}       # rid -> replica
        self._budget: Optional[List[int]] = None      # run()'s step budget
        n = len(self.engines)
        self.dispatch_count = [0] * n
        self.peak_queue_depth = [0] * n
        self.peak_kv_occupancy = [0.0] * n
        self.steps = [0] * n
        # --------------------------------------------- elastic control --
        self.classes = [getattr(eng.ecfg, "replica_class", "general")
                        for eng in self.engines]
        self.has_classes = any(c != "general" for c in self.classes)
        self.elastic = self.cfg.autoscale != "off"
        self.steal_on = (self.cfg.steal == "on"
                         or (self.cfg.steal == "auto" and self.elastic))
        if self.cfg.replicas_min > n:
            raise ValueError(
                f"replicas_min={self.cfg.replicas_min} exceeds the "
                f"{n} engines provided")
        self.rmax = min(self.cfg.replicas_max or n, n)
        if self.elastic:
            self.states = ["active" if i < self.cfg.replicas_min
                           else "standby" for i in range(n)]
        else:
            # non-elastic fleets are fully provisioned for the whole run
            # — the static cost baseline (replica_seconds = n * makespan)
            self.states = ["active"] * n
        self._active_since: List[Optional[float]] = [
            0.0 if s == "active" else None for s in self.states]
        self.provisioned = [0.0] * n       # closed activation segments
        self._last_scale_t: Optional[float] = None
        self.steals = 0
        self.scale_ups = 0
        self.scale_downs = 0
        # control-plane audit trail (the chaos suite's evidence stream):
        # {"t", "event": scale_up|drain|retire|steal, ...}
        self.events: List[dict] = []

    # ----------------------------------------------------------- intake --
    def submit(self, reqs: Sequence[Request]):
        """Add requests to the global stream.  Dispatch happens when the
        router clock reaches each request's ``arrival``, not here."""
        for r in reqs:
            heapq.heappush(self._pending, (float(r.arrival), self._seq, r))
            self._seq += 1

    # ----------------------------------------------------------- policy --
    def replica_snapshot(self) -> List[ReplicaStats]:
        """Live per-replica state, the policies' (and benchmarks') view:
        one typed :class:`ReplicaStats` per replica — the engine's frozen
        snapshot tagged with its index and dispatch count."""
        return [ReplicaStats(replica=i, dispatched=self.dispatch_count[i],
                             engine=eng.snapshot())
                for i, eng in enumerate(self.engines)]

    def fleet_snapshot(self) -> FleetStats:
        """The control plane's typed fleet view: every replica snapshot
        plus lifecycle states, classes and the provisioning ledger (open
        activation segments credited up to the fleet clock)."""
        now = self._fleet_now()
        prov = []
        for i in range(len(self.engines)):
            p = self.provisioned[i]
            since = self._active_since[i]
            if since is not None:
                p += max(0.0, now - since)
            prov.append(p)
        return FleetStats(
            replicas=tuple(self.replica_snapshot()),
            states=tuple(self.states),
            classes=tuple(self.classes),
            active=sum(s == "active" for s in self.states),
            provisioned_s=tuple(prov),
            steals=self.steals,
            scale_ups=self.scale_ups,
            scale_downs=self.scale_downs)

    def _actives(self) -> List[int]:
        return [i for i, s in enumerate(self.states) if s == "active"]

    def _eligible(self) -> List[int]:
        """Replicas a dispatch may target: ``active`` replicas with step
        budget left in the current run.  Draining replicas are excluded
        — they are emptying, and a new admission would either strand
        there or re-migrate — as are standby ones (unprovisioned).  A
        budget-exhausted replica will never be stepped again, so handing
        it a request strands the request while a budgeted replica could
        have served it.  Falls back (active → anyone) rather than
        returning empty — conservation over progress."""
        act = self._actives()
        if self._budget is None:
            return act or list(range(len(self.engines)))
        el = [i for i in act if self._budget[i] > 0]
        return el or act or list(range(len(self.engines)))

    def _class_candidates(self, r: Request, cand: List[int]) -> List[int]:
        """Class-aware dispatch (heterogeneous fleets only): a request
        whose remaining work is dominated by prompt ingestion prefers a
        ``prefill`` replica, one dominated by decode prefers ``decode``;
        ``general`` replicas serve either.  Preference, not a hard
        partition — with no matching replica eligible the full candidate
        set stands (conservation over affinity)."""
        if not self.has_classes:
            return cand
        want = "prefill" if r.prompt_len >= r.max_new else "decode"
        pref = [i for i in cand if self.classes[i] in (want, "general")]
        return pref or cand

    def _choose(self, r: Request) -> int:
        cand = self._class_candidates(r, self._eligible())
        if len(cand) == 1:
            return cand[0]
        if self.cfg.policy == "lot":
            return min(cand,
                       key=lambda i: (self.engines[i].outstanding_tokens(),
                                      i))
        if self.cfg.policy == "slo":
            # most cluster-level SLO headroom (ties: lower index) — reads
            # the typed engine snapshots, not ad-hoc probes
            return min(cand,
                       key=lambda i: (-self.engines[i].snapshot()
                                      .slo_headroom, i))
        # p2c: two seeded probes of *distinct* replicas, keep the roomier
        # one (ties: lower index).  Sampling with replacement would
        # collapse to a single uniform probe 1/n of the time — at n=2
        # that is half the dispatches ignoring KV state entirely.
        a, b = (int(x) for x in
                self._rng.choice(len(cand), size=2, replace=False))
        pair = sorted((cand[a], cand[b]))
        return max(pair,
                   key=lambda i: (self.engines[i].kv_free_cells(), -i))

    def _dispatch_due(self, now: float):
        """Hand every pending request with ``arrival <= now`` to a replica
        (in arrival order — each dispatch updates the state the next
        choice reads)."""
        while self._pending and self._pending[0][0] <= now + 1e-12:
            _, _, r = heapq.heappop(self._pending)
            i = self._choose(r)
            self.dispatched_to[r.rid] = i
            self.dispatch_count[i] += 1
            self.engines[i].add_requests([r])
            depth = self.engines[i].scheduler.queue_depth
            if depth > self.peak_queue_depth[i]:
                self.peak_queue_depth[i] = depth
            self._observe_kv(i)

    def _observe_kv(self, i: int):
        """Track peak live occupancy — the end-of-run snapshot is always
        drained (0), so benchmarks report this instead."""
        occ = self.engines[i].kv_occupancy()
        if occ > self.peak_kv_occupancy[i]:
            self.peak_kv_occupancy[i] = occ

    # -------------------------------------------------- elastic control --
    def _fleet_now(self) -> float:
        """The fleet clock: the furthest-ahead replica's sim time — what
        a wall clock over the co-simulation would read.  Provisioning
        ledgers and scale decisions are stamped against it."""
        return max((eng.sim_time for eng in self.engines), default=0.0)

    def _control(self, now: float):
        """One control-plane tick (elastic mode only): complete pending
        drains, then let the autoscaler and the work stealer act.  Pure
        function of fleet state + config — a rerun replays the same
        scale/steal trace."""
        for i, st in enumerate(self.states):
            if st == "draining" \
                    and not self.engines[i].scheduler.outstanding:
                # drained dry: close the provisioning segment and retire.
                # outstanding == empty means no rows, no queue, no
                # pendings — drain-before-retire by construction.
                self.states[i] = "standby"
                since = self._active_since[i]
                if since is not None:
                    self.provisioned[i] += max(
                        0.0, self.engines[i].sim_time - since)
                    self._active_since[i] = None
                self.events.append(
                    {"t": now, "event": "retire", "replica": i})
        if self.cfg.autoscale == "target-occupancy":
            self._autoscale(now)
        if self.steal_on:
            self._steal(now)

    def _autoscale(self, now: float):
        act = self._actives()
        if not act:
            return
        if self._last_scale_t is not None \
                and now - self._last_scale_t < self.cfg.cooldown:
            return
        occ = sum(self.engines[i].kv_occupancy() for i in act) / len(act)
        backlog = sum(len(self.engines[i].scheduler.waiting) for i in act)
        headroom = min(self.engines[i].snapshot().slo_headroom for i in act)
        # pressure: KV nearly full, queues building past one-per-replica,
        # or some active replica already past deadline-safe load
        pressure = (occ >= self.cfg.occ_high or backlog > len(act)
                    or headroom < 0.0)
        idle = occ <= self.cfg.occ_low and backlog == 0
        if pressure and len(act) < self.rmax:
            standby = [i for i, s in enumerate(self.states)
                       if s == "standby"]
            if standby:
                self._activate(standby[0], now)
            return
        if idle and len(act) > self.cfg.replicas_min:
            # retire the least-loaded active: cheapest drain, and its
            # queued work redistributes with the least disruption
            i = min(act, key=lambda j: (self.engines[j].outstanding_tokens(),
                                        j))
            self._drain(i, now)

    def _activate(self, i: int, now: float):
        """Provision a standby replica.  Its sim clock fast-forwards to
        the fleet clock — a machine provisioned at t serves from t, it
        does not retroactively absorb the past — which also keeps the
        co-simulation's lagging-clock invariant (the new replica is
        never *behind* the dispatch instant that fills it)."""
        eng = self.engines[i]
        eng.sim_time = max(eng.sim_time, now)
        self.states[i] = "active"
        self._active_since[i] = eng.sim_time
        self.scale_ups += 1
        self._last_scale_t = now
        self.events.append({"t": now, "event": "scale_up", "replica": i})

    def _drain(self, i: int, now: float):
        """Begin retiring replica ``i``: flip it to ``draining`` (no new
        admissions — ``_eligible`` skips it), release every queued
        (rowless) request back to the router's pending stream at its
        original arrival, and let in-flight rows decode to completion.
        ``_control`` flips it to ``standby`` only once the scheduler
        reports nothing outstanding."""
        self.states[i] = "draining"
        self.scale_downs += 1
        self._last_scale_t = now
        freed = self.engines[i].release_queued(include_pending=True)
        for r in freed:
            self.dispatched_to.pop(r.rid, None)
            heapq.heappush(self._pending,
                           (float(r.arrival), self._seq, r))
            self._seq += 1
        self.events.append({"t": now, "event": "drain", "replica": i,
                            "released": [r.rid for r in freed]})

    def _steal(self, now: float):
        """Migrate queued work from the hottest active replica to the
        least-loaded one when re-prefilling at the target beats waiting
        at the source.  Expected waits are backlog-drain estimates
        (outstanding tokens x observed seconds/token); the migration
        must win by ``steal_margin`` x the re-prefill cost, so marginal
        steals — which burn prefill FLOPs for nothing — stay put.  Only
        rowless requests move: no KV migrates, the target prefills the
        request's context from scratch."""
        act = self._actives()
        if len(act) < 2:
            return
        src = max(act, key=lambda i: (len(self.engines[i].scheduler.waiting),
                                      -i))
        if not self.engines[src].scheduler.waiting:
            return
        dst = min(act, key=lambda i: (self.engines[i].outstanding_tokens(),
                                      i))
        if dst == src:
            return
        esrc, edst = self.engines[src], self.engines[dst]
        tpt_s = expected_time_per_token(esrc.sim_time, esrc.accepted_tokens,
                                        esrc.cost.llm_time_per_token)
        tpt_d = expected_time_per_token(edst.sim_time, edst.accepted_tokens,
                                        edst.cost.llm_time_per_token)
        out_src = esrc.outstanding_tokens()
        out_dst = edst.outstanding_tokens()
        moved: List[int] = []
        for r in esrc.scheduler.steal_candidates():
            emitted = len(r.emitted or [])
            ctx = r.prompt_len + max(0, emitted - 1)
            owed = ctx + max(0, r.max_new - max(0, emitted - 1))
            pre = edst.cost.prefill_time(ctx)
            if out_src * tpt_s > (out_dst * tpt_d
                                  + (1.0 + self.cfg.steal_margin) * pre):
                moved.append(r.rid)
                out_src -= owed
                out_dst += owed
        if not moved:
            return
        reqs = esrc.release_queued(moved)
        edst.add_requests(reqs)
        for r in reqs:
            self.dispatched_to[r.rid] = dst
        self.steals += len(reqs)
        self._observe_kv(dst)
        self.events.append({"t": now, "event": "steal", "src": src,
                            "dst": dst, "rids": [r.rid for r in reqs]})

    # ------------------------------------------------------------- loop --
    def _replica_ctx(self, i: int):
        if self.submeshes is None or self.rules is None:
            return contextlib.nullcontext()
        return use_rules(self.submeshes[i], self.rules)

    def step_replica(self, i: int) -> dict:
        """One engine slot on replica ``i`` (under its sub-mesh's sharding
        rules when meshes were provided)."""
        with self._replica_ctx(i):
            rec = self.engines[i].step()
        self.steps[i] += 1
        self._observe_kv(i)
        return rec

    def run(self, max_slots: int = 1000) -> dict:
        """Drive the co-simulation until the stream drains (or every
        replica with work exhausts its ``max_slots`` step budget)."""
        budget = [max_slots] * len(self.engines)
        self._budget = budget
        try:
            while True:
                if self.elastic or self.steal_on:
                    self._control(self._fleet_now())
                live = [i for i, eng in enumerate(self.engines)
                        if eng.scheduler.outstanding and budget[i] > 0]
                if not live:
                    if self._pending and any(b > 0 for b in budget):
                        # every replica idle: fast-forward the router clock
                        # to the next arrival and dispatch it
                        self._dispatch_due(self._pending[0][0])
                        continue
                    break
                i = min(live, key=lambda j: (self.engines[j].sim_time, j))
                self._dispatch_due(self.engines[i].sim_time)
                self.step_replica(i)
                budget[i] -= 1
        finally:
            self._budget = None
        return self.stats()

    # ------------------------------------------------------------ stats --
    def stats(self) -> dict:
        """Aggregate serving stats plus the per-replica breakdown.
        ``replica_stats[i]`` is replica i's full engine stats dict —
        with one replica it is exactly what the bare engine would
        report."""
        per = [eng.stats() for eng in self.engines]
        accepted = sum(eng.accepted_tokens for eng in self.engines)
        makespan = max((eng.sim_time for eng in self.engines), default=0.0)
        reqs = [r for eng in self.engines for r in eng.requests.values()]
        lat = [r.latency for r in reqs if r.latency is not None]
        ttft = [r.first_token_time - r.arrival for r in reqs
                if r.first_token_time is not None]
        summ = slo_summary(reqs)
        fleet = self.fleet_snapshot()
        return {
            "router_policy": self.cfg.policy,
            "slo": {**summ.asdict(),
                    "goodput_under_slo": summ.goodput_under_slo(makespan)},
            "replicas": len(self.engines),
            "dispatched": list(self.dispatch_count),
            "undispatched": len(self._pending),
            "steps": list(self.steps),
            "peak_queue_depth": list(self.peak_queue_depth),
            "peak_kv_occupancy": list(self.peak_kv_occupancy),
            "accepted_tokens": accepted,
            "makespan_sim": makespan,
            "aggregate_goodput_sim": accepted / max(makespan, 1e-9),
            "mean_latency": float(np.mean(lat)) if lat else 0.0,
            "p95_latency": float(np.percentile(lat, 95)) if lat else 0.0,
            "ttft_p50": float(np.percentile(ttft, 50)) if ttft else 0.0,
            "ttft_p95": float(np.percentile(ttft, 95)) if ttft else 0.0,
            "finished": sum(len(eng.scheduler.finished)
                            for eng in self.engines),
            # elastic control plane (all zeros / fully-provisioned under
            # autoscale=off — the static cost baseline)
            "autoscale": self.cfg.autoscale,
            "states": list(self.states),
            "classes": list(self.classes),
            "steals": self.steals,
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "replica_seconds": fleet.replica_seconds,
            "cost_normalized_goodput":
                fleet.cost_normalized_goodput(accepted),
            "replica_snapshot": [s.asdict()
                                 for s in self.replica_snapshot()],
            "replica_stats": per,
        }
