"""Typed serving telemetry: the snapshot surface every layer exports.

Before this module each layer grew its own ad-hoc stats surface — the
engine exposed ``outstanding_tokens()`` / ``kv_free_cells()`` /
``kv_occupancy()`` methods, the scheduler ``queue_depth`` /
``outstanding_requests``, and the router glued them into loose
``replica_snapshot`` dicts whose keys nothing checked.  Routing policies
and benchmarks string-indexed those dicts, so a renamed key failed at
dispatch time, not import time.

Now each layer returns ONE frozen dataclass from a single ``snapshot()``
method:

* :class:`SchedulerStats` — ``ContinuousScheduler.snapshot()``: queue
  and lifecycle counters plus the most urgent outstanding deadline.
* :class:`EngineStats` — ``SpinEngine.snapshot()``: embeds the scheduler
  snapshot and adds the KV/token-load view plus the SLO headroom term.
* :class:`ReplicaStats` — ``Router.replica_snapshot()``: one per
  replica, the engine snapshot tagged with the replica index and its
  dispatch count.  Routing policies read these typed objects — the
  fields they compare are attributes, not string keys.

Frozen on purpose: a snapshot is a point-in-time reading, and policies
must never mutate shared telemetry.  ``asdict()`` is the JSON boundary
for ``stats()`` blobs and bench records.

This module also owns the **goodput-under-SLO** arithmetic: engines
stamp every committed token's sim-clock time onto
``Request.token_times``, and :func:`slo_summary` folds those against
each request's :class:`~repro_torch.data.workloads.SLO` contract into the
headline serving metric — tokens that met their deadline per second,
the figure an operator with latency contracts actually buys.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable

from repro_torch.data.workloads import Request


@dataclasses.dataclass(frozen=True)
class SchedulerStats:
    """One scheduler's live state: the queue/lifecycle view."""
    queue_depth: int           # waiting + not-yet-arrived pending
    waiting: int               # arrived, rowless — the live backlog the
    #                            autoscaler reads (pending future arrivals
    #                            are not pressure yet)
    running: int               # row owners (prefilling included)
    prefilling: int            # subset of running still ingesting context
    admissions: int
    preemptions: int
    finished: int
    stolen: int                # queued requests released to another replica
    queue_wait: float
    # most urgent next-token deadline over everything this scheduler
    # still owes (running + waiting + pending); +inf when no outstanding
    # request carries an SLO
    min_deadline: float


@dataclasses.dataclass(frozen=True)
class EngineStats:
    """One engine's live state: the dispatch-time load/memory/SLO view."""
    sim_time: float
    outstanding_tokens: int    # context to ingest + output still owed
    kv_free_cells: int         # admissible KV headroom (budget currency)
    kv_occupancy: float        # 1 - free/budget
    accepted_tokens: int
    # cluster-level SLO headroom (SpecServe's dispatch term): time until
    # the most urgent outstanding deadline, net of the estimated time to
    # drain the engine's current token backlog.  Positive = the engine
    # can absorb more work without busting a deadline; with no deadlines
    # outstanding it degrades to a pure (negated) backlog reading.
    slo_headroom: float
    scheduler: SchedulerStats

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class ReplicaStats:
    """An engine snapshot as the router sees it."""
    replica: int
    dispatched: int
    engine: EngineStats

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class FleetStats:
    """The elastic control plane's fleet-level view: every replica's
    snapshot tagged with its lifecycle state, plus the provisioning
    ledger the cost-normalized-goodput metric is computed from.

    ``states[i]`` is one of ``active`` (serving, dispatch-eligible),
    ``draining`` (finishing in-flight work, excluded from new
    admissions) or ``standby`` (retired or never activated — idle,
    unprovisioned).  ``provisioned_s[i]`` is the sim-clock seconds
    replica ``i`` has been provisioned (activation to retirement, open
    segments credited to the fleet clock), the denominator an
    autoscaling operator pays for."""
    replicas: tuple            # tuple of ReplicaStats, one per replica
    states: tuple              # per-replica lifecycle state strings
    classes: tuple             # per-replica class names ("general", ...)
    active: int                # replicas currently dispatch-eligible
    provisioned_s: tuple       # per-replica provisioned sim-seconds
    steals: int                # queued requests migrated between replicas
    scale_ups: int
    scale_downs: int

    @property
    def replica_seconds(self) -> float:
        """Total replica-seconds provisioned — the cost denominator."""
        return float(sum(self.provisioned_s))

    def cost_normalized_goodput(self, accepted_tokens: int) -> float:
        """Accepted tokens per replica-second provisioned: the number an
        autoscaling operator optimizes (raw goodput at half the fleet
        cost doubles it; over-provisioning dilutes it)."""
        return accepted_tokens / max(self.replica_seconds, 1e-9)

    def asdict(self) -> dict:
        d = dataclasses.asdict(self)
        d["replica_seconds"] = self.replica_seconds
        return d


# --------------------------------------------------------- SLO metrics --

@dataclasses.dataclass(frozen=True)
class SLOSummary:
    """Deadline attainment over a set of requests (sim-clock)."""
    slo_requests: int          # requests carrying an SLO contract
    slo_tokens: int            # their committed tokens with deadlines
    tokens_met: int            # committed no later than their deadline
    ttft_met: int              # first tokens inside the TTFT deadline

    @property
    def attainment(self) -> float:
        """Fraction of deadline-carrying tokens that met their deadline
        (1.0 when nothing carries an SLO — nothing was violated)."""
        if self.slo_tokens == 0:
            return 1.0
        return self.tokens_met / self.slo_tokens

    def goodput_under_slo(self, makespan: float) -> float:
        """Tokens that met their deadline per second — the headline
        serving metric once requests carry latency contracts."""
        return self.tokens_met / max(makespan, 1e-9)

    def asdict(self) -> dict:
        d = dataclasses.asdict(self)
        d["attainment"] = self.attainment
        return d


def slo_summary(reqs: Iterable[Request]) -> SLOSummary:
    """Fold per-token commit times against each request's SLO contract.

    Only the first ``max_new`` tokens count (the engine may emit one
    trailing not-fed-back token past the target length); requests
    without an SLO contribute nothing.  Tokens missing a timestamp (not
    yet committed) are not counted as met or missed — attainment is over
    committed tokens, so partial streams are comparable mid-run."""
    n_req = toks = met = ttft_met = 0
    for r in reqs:
        if r.slo is None:
            continue
        n_req += 1
        times = r.token_times or []
        n = min(len(times), r.max_new)
        for j in range(n):
            toks += 1
            if times[j] <= r.slo.token_deadline(r.arrival, j) + 1e-12:
                met += 1
                if j == 0:
                    ttft_met += 1
    return SLOSummary(slo_requests=n_req, slo_tokens=toks,
                      tokens_met=met, ttft_met=ttft_met)


def min_outstanding_deadline(reqs: Iterable[Request]) -> float:
    """The most urgent next-token deadline over ``reqs`` (+inf when no
    request carries an SLO) — the scheduler/router urgency reading."""
    return min((r.next_deadline() for r in reqs), default=math.inf)


# Deadline horizon used when an engine has NO outstanding deadlines: a
# large constant rather than +inf so ``slo_headroom`` stays finite and
# comparable — between two deadline-free replicas the constant cancels
# and the comparison degrades to backlog (least-outstanding-tokens-ish).
DEADLINE_HORIZON = 1e6


def slo_headroom(min_deadline: float, sim_time: float,
                 outstanding_tokens: int,
                 time_per_token: float) -> float:
    """SpecServe-style cluster headroom: slack to the most urgent
    outstanding deadline minus the estimated backlog drain time."""
    slack = min(min_deadline - sim_time, DEADLINE_HORIZON)
    return slack - outstanding_tokens * max(time_per_token, 0.0)


def expected_time_per_token(sim_time: float, accepted_tokens: int,
                            fallback: float) -> float:
    """Observed mean seconds per committed token, falling back to the
    cost model's per-token verify figure before anything committed."""
    if accepted_tokens > 0:
        return sim_time / accepted_tokens
    return fallback


__all__ = [
    "SchedulerStats", "EngineStats", "ReplicaStats", "FleetStats",
    "SLOSummary", "slo_summary", "min_outstanding_deadline",
    "slo_headroom", "expected_time_per_token", "DEADLINE_HORIZON",
]
