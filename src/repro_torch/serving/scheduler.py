"""Continuous-batching request scheduler for the SPIN engine.

The seed engine stepped one fixed cohort of requests per time slot: rows of
the LLM ``CachePool`` were filled once up front and capacity idled as
requests finished.  Under *serving* conditions (streaming arrivals, mixed
lengths, a finite KV budget) that throws away exactly the goodput the
paper's mechanisms buy — SpecInfer / SpecServe-style systems integrate
speculative decoding with a continuous-batching scheduler for this reason.

This module is the policy half of that scheduler; ``serving/engine.py``
owns the mechanics (prefill, cache eviction).  Per time slot the engine
calls :meth:`ContinuousScheduler.plan` with the current simulated clock and
applies the returned decision:

* **arrivals** — submitted requests carry an ``arrival`` timestamp
  (Poisson or trace-driven, see ``data/workloads.py``); they become
  admissible only once the engine clock reaches it.
* **admission** — waiting requests are admitted by rank
  ``(next_deadline, priority, arrival, rid)`` into free ``CachePool``
  rows: deadline-closest-first for requests carrying an SLO contract
  (``Request.slo``), then lower priority value = more urgent (like a
  nice level), then FIFO by arrival.  Requests without an SLO have an
  infinite deadline, so a contract-free stream reproduces the pre-SLO
  ``(priority, arrival, rid)`` order — and default priority 0 everywhere
  reproduces plain FIFO-by-arrival — exactly.
* **chunked prefill** (``prefill_chunk > 0``) — an admitted request does
  not prefill its whole prompt in one monolithic pass.  It enters a
  ``prefilling`` lifecycle state (owns a row, holds partial KV, does not
  draft yet) and :meth:`plan` grants it prompt *chunks* under a per-slot
  **token budget** that is shared with decode work: each decode-active
  request costs ``gamma + 1`` LLM query tokens, and whatever remains of
  ``token_budget`` is handed to prefilling requests in rank order, at most
  ``prefill_chunk`` tokens each (Sarathi-style mixed batches).  With
  ``prefill_chunk == 0`` (default) admission prefills monolithically as
  before.
* **recycling** — rows of finished requests are freed inside the engine
  step; the end-of-step ``plan`` immediately re-fills them, so a row never
  idles across a slot boundary while work is queued.
* **preemption** — when the projected KV demand of the running set exceeds
  ``kv_budget`` cells, victims are chosen farthest-from-deadline-first
  (then lowest-priority, ties by latest arrival) and re-enqueued for
  re-prefill — a request already pressed against its deadline is never
  sacrificed for a same-priority request with slack.  At least
  ``min_running`` requests always keep their rows, and an empty pool
  always admits, so the engine can never deadlock at full capacity.

Progress guarantees with chunking: a preempted prefilling request loses
its partial KV (blocks are freed) and restarts from chunk zero on
re-admission; the oldest ``min_running`` row owners are never preempted,
and when no request is decode-active the top-ranked prefilling request is
always granted a chunk even if ``token_budget`` would deny it — the
chunked analogue of the empty-pool admission rule, without which an idle
step would make no progress at all.

The ``static`` policy reproduces the seed behaviour (admit a cohort only
when the pool has fully drained, monolithic prefill) and is kept as the
baseline that ``benchmarks/bench_serving.py`` compares against.

Invariants (the contract the engine relies on; previously stated only in
PR descriptions):

* **Row ownership** — ``running`` holds exactly the requests that own an
  engine pool row (``prefilling`` is a subset of it: row granted, partial
  KV, not drafting).  A request is in at most one of pending / waiting /
  running at any instant, and moves only through the ``mark_*``
  acknowledgements — the scheduler never mutates engine state itself.
* **Budget accounting units** — ``kv_budget`` and :meth:`kv_need` are in
  KV *cells*; with ``block_size > 0`` (paged layout) demand is rounded up
  to whole blocks first, so the budget the policy enforces equals the
  physical blocks the pool holds (``kv_budget // block_size``) — an
  enforced invariant, not a model.  ``token_budget`` and
  :meth:`decode_cost` are in per-slot LLM *query tokens* (a decode slot
  costs its granted depth ``k_i + 1``; a chunk costs its tokens) — the
  two budgets are different currencies and never mix.
* **Speculation margins** — admission and preemption project each
  request at ``ctx + gamma + 1`` cells, where ``cfg.gamma`` is the
  engine's *worst-case* depth (``gamma_max`` under the adaptive
  controller): context plus the deepest draft window plus the
  bonus/correction token.  The engine writes speculative KV at exactly
  ``[ctx, ctx + k_i + 1)`` each slot, so a request the scheduler keeps
  admitted can never scatter out of budget.
"""

from __future__ import annotations

import bisect
import dataclasses
import heapq
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.data.workloads import Request
from repro_torch.serving.stats import SchedulerStats, min_outstanding_deadline

POLICIES = ("continuous", "static")


@dataclasses.dataclass(kw_only=True)
class SchedulerConfig:
    """Keyword-only on purpose: fields are appended as the scheduler grows
    (chunking, priorities) and positional construction would silently shift
    arguments."""
    capacity: int                      # LLM pool rows
    max_len: int = 256
    # maximum speculation window (KV headroom + default decode-token cost).
    # With the adaptive gamma controller this is ``gamma_max``: admission
    # reserves the worst-case window, while the *per-slot token budget* is
    # costed from the actually-granted depths (``set_decode_depths``).
    gamma: int = 4
    kv_budget: Optional[int] = None    # total KV cells; None -> cap*max_len
    policy: str = "continuous"
    min_running: int = 1               # never preempt below this
    # paged layout: KV is allocated in whole blocks, so demand is accounted
    # in block-rounded cells and the budget is the physical block pool —
    # an enforced invariant, not a model.  0 = cell-granular (dense layout).
    block_size: int = 0
    # chunked prefill (continuous policy only): max prompt tokens ingested
    # per request per slot.  0 = monolithic prefill-on-admit.
    prefill_chunk: int = 0
    # per-slot LLM query-token budget shared between decode slots
    # (gamma+1 tokens each) and prefill chunks.  None = decode always
    # proceeds and every prefilling request gets a full chunk.
    token_budget: Optional[int] = None
    # tree speculation: each extra branch forks the request's row
    # copy-on-write, which can copy the straddling tail block plus the
    # branch's share of the speculation window — kv_need reserves that
    # worst case per extra branch so admission cannot over-commit the
    # block pool.  1 = linear (no reservation).
    spec_branches: int = 1
    # honour per-request SLO contracts (Request.slo): admission ranks
    # deadline-closest-first, preemption victims are farthest-from-
    # deadline-first, and the token-budget split sizes prefill chunks
    # against TTFT slack.  False ignores contracts entirely (the
    # deadline-blind baseline); either way, requests WITHOUT an SLO rank
    # exactly by the pre-SLO (priority, arrival, rid) key, so a stream
    # with no contracts is bit-identical under both settings.
    slo_aware: bool = True

    @classmethod
    def from_args(cls, args, *, capacity: Optional[int] = None,
                  kv_budget: Optional[int] = None) -> "SchedulerConfig":
        """Build from a ``launch.serve.build_parser()`` namespace — the
        one flag->config translation tests and benchmarks reuse instead
        of re-deriving fields by hand.  ``capacity``/``kv_budget``
        override the flags (the router splits aggregates per replica).
        ``gamma`` is the engine's WORST-CASE depth (gamma_max under the
        adaptive policy) — the same resolution ``SpinEngine`` applies."""
        gamma = int(getattr(args, "gamma", 4))
        if getattr(args, "gamma_policy", "fixed") == "fixed":
            gmax = gamma
        else:
            gmax = getattr(args, "gamma_max", None)
            gmax = int(gmax) if gmax is not None else 2 * gamma
        paged = getattr(args, "kv_layout", "paged") == "paged"
        branches = (int(getattr(args, "spec_branch", 1))
                    if getattr(args, "spec_shape", "linear") == "tree"
                    else 1)
        return cls(
            capacity=int(capacity if capacity is not None
                         else getattr(args, "capacity", None)
                         or getattr(args, "requests", 8)),
            gamma=gmax,
            kv_budget=(kv_budget if kv_budget is not None
                       else getattr(args, "kv_budget", None)),
            policy=getattr(args, "scheduler", "continuous"),
            block_size=(int(getattr(args, "block_size", 16))
                        if paged else 0),
            prefill_chunk=int(getattr(args, "prefill_chunk", 0)),
            token_budget=getattr(args, "token_budget", None),
            spec_branches=branches,
            slo_aware=getattr(args, "slo_profile", "off") != "off",
        )


@dataclasses.dataclass
class Decision:
    """One slot's scheduling decision, applied by the engine in order:
    preemptions first (rows + KV cells freed), then admissions (row
    granted; prefill starts), then prefill chunk grants
    ``(request, n_tokens)`` — newly admitted requests appear in both
    ``admit`` and ``prefill`` when chunking is enabled."""
    admit: List[Request]
    preempt: List[Request]
    prefill: List[Tuple[Request, int]] = dataclasses.field(
        default_factory=list)

    @property
    def empty(self) -> bool:
        return not (self.admit or self.preempt or self.prefill)


def _rank(r: Request):
    """Admission / victim ranking: deadline-closest-first for requests
    carrying an SLO, then the pre-SLO key ``(priority, arrival, rid)``
    — lower priority value first (more urgent), then FIFO by arrival.

    ``next_deadline()`` is +inf without an SLO, so a stream with no
    contracts orders byte-for-byte like the pre-SLO scheduler; equal
    deadlines (including the all-inf case) fall back to the same total,
    stable ``(priority, arrival, rid)`` order.  Reversed, this is the
    preemption-victim order: farthest-from-deadline-first, THEN lowest
    priority / latest arrival — a request past its deadline is never
    sacrificed for a same-priority request with slack."""
    return (r.next_deadline(), r.priority, r.arrival, r.rid)


def _blind_rank(r: Request):
    """The pre-SLO ranking, kept for ``slo_aware=False`` (the
    deadline-blind baseline the SLO benchmarks compare against)."""
    return (math.inf, r.priority, r.arrival, r.rid)


class ContinuousScheduler:
    """Tracks the request lifecycle: pending (future arrival) -> waiting
    (arrived, no row) -> [prefilling (owns a row, partial KV) ->] running
    (row + full context, drafting) -> finished; preemption moves
    prefilling/running -> waiting with generated tokens intact (partial
    prefill progress is discarded — its blocks are freed)."""

    def __init__(self, cfg: SchedulerConfig):
        if cfg.policy not in POLICIES:
            raise ValueError(f"unknown policy {cfg.policy!r}")
        if cfg.prefill_chunk < 0:
            raise ValueError("prefill_chunk must be >= 0")
        if cfg.token_budget is not None and cfg.token_budget <= 0:
            raise ValueError("token_budget must be positive")
        self.cfg = cfg
        # one ranking for admission AND (reversed) victim selection:
        # deadline-closest-first when contracts are honoured, the pre-SLO
        # (priority, arrival, rid) key when blind
        self._rankkey = _rank if cfg.slo_aware else _blind_rank
        self.kv_budget = (cfg.kv_budget if cfg.kv_budget is not None
                          else cfg.capacity * cfg.max_len)
        self._pending: List = []           # heap of (arrival, seq, Request)
        self._seq = 0
        self.waiting: List[Request] = []   # arrived, sorted by _rank
        self.running: Dict[int, Request] = {}   # every row owner
        self.prefilling: Dict[int, Request] = {}  # subset of running
        self.finished: List[int] = []
        self.preemptions = 0
        self.admissions = 0
        self.stolen = 0                    # queued requests released away
        self.prefill_grants = 0            # chunk grants issued
        self.prefill_tokens = 0            # prompt tokens granted in chunks
        self._wait_since: Dict[int, float] = {}   # rid -> enqueue clock
        self.queue_wait = 0.0              # total waiting-time accumulated
        # per-request granted speculation depths (gamma controller); the
        # token-budget split costs each decode slot at its actual depth
        # instead of a uniform gamma+1.  Missing entries (fresh admits
        # before any grant) fall back to cfg.gamma.
        self.decode_depths: Dict[int, int] = {}
        self.decode_tokens_planned = 0     # Σ (k_i + 1) over planned slots
        # prompt tokens granted by the CURRENT slot's chunk plan; the
        # gamma controller reads this so its depth cap charges the actual
        # prefill work sharing this slot's token budget
        self.last_prefill_granted = 0
        # slot-duration EMA (sim-clock gap between successive plan()
        # calls): converts a TTFT deadline into "slots left", so the
        # chunk split can size a tight request's chunk to finish its
        # prefill before the deadline.  Observation only — with no SLOs
        # (or slo_aware=False) it never changes a decision.
        self._last_plan_now: Optional[float] = None
        self._slot_dt: Optional[float] = None
        self.slo_chunk_boosts = 0          # chunks grown for TTFT slack

    # ----------------------------------------------------------- intake --
    def submit(self, reqs: Sequence[Request]):
        for r in reqs:
            heapq.heappush(self._pending,
                           (float(r.arrival), self._seq, r))
            self._seq += 1

    def poll(self, now: float):
        """Move every request whose arrival time has passed into the
        waiting queue (kept sorted by rank)."""
        while self._pending and self._pending[0][0] <= now + 1e-12:
            arrival, _, r = heapq.heappop(self._pending)
            bisect.insort(self.waiting, r, key=self._rankkey)
            # queue wait starts at the actual arrival, not the first poll
            # that noticed it — several requests landing inside one slot
            # must each be charged their own wait
            self._wait_since[r.rid] = arrival

    @property
    def outstanding(self) -> bool:
        return bool(self._pending or self.waiting or self.running)

    def outstanding_requests(self) -> List[Request]:
        """Every request this scheduler still owes work: running
        (prefilling included), waiting, and not-yet-arrived pending —
        the router's per-replica load view."""
        return (list(self.running.values()) + list(self.waiting)
                + [r for _, _, r in self._pending])

    @property
    def queue_depth(self) -> int:
        """Requests without a row: waiting plus not-yet-arrived pending."""
        return len(self.waiting) + len(self._pending)

    def next_arrival(self) -> Optional[float]:
        return self._pending[0][0] if self._pending else None

    # ------------------------------------------------- steal / requeue --
    def steal_candidates(self) -> List[Request]:
        """Queued requests another replica could serve from scratch:
        arrived but rowless (``waiting``) — no KV, no partial prefill, so
        migration is a plain re-submission.  Worst-ranked first: the
        request that would wait longest here gains most from moving."""
        return list(reversed(self.waiting))

    def release_queued(self, rids: Optional[Sequence[int]] = None, *,
                       include_pending: bool = False) -> List[Request]:
        """Remove queued (rowless) requests from this scheduler and return
        them for hand-off to another replica — the work-stealing / drain
        hook.  ``rids=None`` releases every waiting request;
        ``include_pending`` also releases not-yet-arrived requests
        (drain-before-retire hands the whole queue off).  Row owners
        (running/prefilling) are never released — their KV lives here.

        Accrued queue wait is NOT charged at the source: the request's
        ``arrival`` rides with it, and the receiving scheduler's
        :meth:`poll` re-charges the full arrival->admission wait there,
        so fleet-level queue_wait counts each wait exactly once."""
        want = None if rids is None else set(rids)
        out: List[Request] = []
        kept: List[Request] = []
        for r in self.waiting:
            if want is None or r.rid in want:
                out.append(r)
            else:
                kept.append(r)
        self.waiting = kept
        if include_pending:
            still = []
            for arrival, seq, r in self._pending:
                if want is None or r.rid in want:
                    out.append(r)
                else:
                    still.append((arrival, seq, r))
            if len(still) != len(self._pending):
                self._pending = still
                heapq.heapify(self._pending)
        for r in out:
            self._wait_since.pop(r.rid, None)
        self.stolen += len(out)
        return out

    # ----------------------------------------------------------- policy --
    def kv_need(self, r: Request) -> int:
        """KV cells the request needs for its next slot: committed context
        plus the speculation window (gamma drafts + 1 bonus token), rounded
        up to whole blocks under the paged layout (allocation granularity
        = one block, so the rounded figure is what the pool will hold).
        Prefilling requests are accounted at their full target context —
        admission reserves the whole prompt's worth of budget up front, so
        chunked ingestion can never strand a half-prefilled request without
        blocks."""
        ctx = r.prompt_len + max(0, len(r.emitted or []) - 1)
        need = ctx + self.cfg.gamma + 1
        if self.cfg.block_size > 0:
            b = self.cfg.block_size
            need = -(-need // b) * b
            if self.cfg.spec_branches > 1:
                # per extra branch: CoW copies of the blocks covering the
                # speculation window plus the straddling tail block
                per_branch = (-(-(self.cfg.gamma + 2) // b) + 1) * b
                need += (self.cfg.spec_branches - 1) * per_branch
        return need

    def prefill_target(self, r: Request) -> int:
        """Context tokens the engine must ingest before the request can
        draft: prompt plus committed tokens (minus the one emitted-but-not-
        fed-back token that becomes the pool's last_token)."""
        return r.prompt_len + max(0, len(r.emitted or []) - 1)

    def plan(self, now: float, grant_prefill: bool = True) -> Decision:
        """One slot's decision.  ``grant_prefill=False`` plans admissions
        and preemptions only (used by the engine's end-of-step recycling
        pass, so chunk budgets are spent once per slot, not once per
        ``plan`` call)."""
        self.poll(now)
        if (self._last_plan_now is not None
                and now > self._last_plan_now + 1e-12):
            dt = now - self._last_plan_now
            self._slot_dt = (dt if self._slot_dt is None
                             else 0.5 * self._slot_dt + 0.5 * dt)
        self._last_plan_now = now
        if self.cfg.policy == "static":
            return self._plan_static()
        dec = self._plan_continuous()
        if grant_prefill and self.cfg.prefill_chunk > 0:
            dec.prefill = self._plan_chunks(dec, now)
            self.last_prefill_granted = sum(n for _, n in dec.prefill)
        return dec

    def _plan_static(self) -> Decision:
        """Seed-style gang scheduling: a new cohort is admitted only once
        the pool has fully drained (always monolithic prefill)."""
        admit: List[Request] = []
        if not self.running:
            while self.waiting and len(admit) < self.cfg.capacity:
                admit.append(self.waiting.pop(0))
        return Decision(admit=admit, preempt=[])

    def _plan_continuous(self) -> Decision:
        admit: List[Request] = []
        preempt: List[Request] = []
        # Preempt while projected demand exceeds the KV budget.  Victims
        # are the worst-ranked runners — farthest-from-deadline first
        # once SLOs exist (a request past its deadline is never the
        # victim over a same-priority request with slack), then lowest
        # priority class, ties by latest arrival; the best-ranked
        # min_running requests always keep their rows (guaranteed
        # progress -> no livelock).
        runners = sorted(self.running.values(), key=self._rankkey)
        demand = sum(self.kv_need(r) for r in runners)
        while demand > self.kv_budget and len(runners) > self.cfg.min_running:
            victim = runners.pop()
            demand -= self.kv_need(victim)
            preempt.append(victim)
        # Admit by rank into freed/free rows while the budget allows.  An
        # empty pool admits unconditionally (a single oversized request
        # must still run, otherwise the queue deadlocks).
        occupied = len(self.running) - len(preempt)
        while self.waiting and occupied + len(admit) < self.cfg.capacity:
            r = self.waiting[0]
            if (demand + self.kv_need(r) > self.kv_budget
                    and occupied + len(admit) >= self.cfg.min_running):
                break
            self.waiting.pop(0)
            admit.append(r)
            demand += self.kv_need(r)
        return Decision(admit=admit, preempt=preempt)

    def set_decode_depths(self, depths: Dict[int, int]):
        """Engine acknowledgement of the gamma controller's grants: the
        speculation depth each running request will draft next slot.  The
        token-budget split charges each decode slot ``k_i + 1`` LLM query
        tokens (its drafts + the bonus/correction token) instead of the
        uniform worst case, so shallow grants free budget for prompt
        chunks."""
        self.decode_depths = dict(depths)

    def decode_cost(self, rid: int) -> int:
        """Planned LLM query tokens of one decode slot: granted depth + 1
        (fixed policy / fresh admits: cfg.gamma + 1)."""
        return self.decode_depths.get(rid, self.cfg.gamma) + 1

    def _slo_chunk(self, r: Request, remaining: int, now: float) -> int:
        """TTFT-slack-aware chunk size: the tokens this slot must ingest
        so the request's remaining prefill completes before its TTFT
        deadline at the observed slot cadence.  At most ``prefill_chunk``
        unless the deadline demands more; never below ``prefill_chunk``
        (a tight budget still caps the grant downstream).  Requests
        without an SLO — or a scheduler without a cadence estimate yet —
        keep the flat ``prefill_chunk``."""
        base = min(self.cfg.prefill_chunk, remaining)
        if (not self.cfg.slo_aware or r.slo is None
                or self._slot_dt is None or self._slot_dt <= 0):
            return base
        slack = r.next_deadline() - now
        slots_left = max(1.0, slack / self._slot_dt)
        needed = int(math.ceil(remaining / slots_left))
        if needed > base:
            self.slo_chunk_boosts += 1
            return min(needed, remaining)
        return base

    def _plan_chunks(self, dec: Decision,
                     now: float) -> List[Tuple[Request, int]]:
        """Split this slot's token budget between decode slots and prompt
        chunks.  Decode comes first (every decode-active request costs its
        granted depth + 1 query tokens); the remainder goes to prefilling
        requests in rank order — deadline-closest-first under SLOs —
        capped at ``prefill_chunk`` tokens each unless a request's TTFT
        slack demands a bigger chunk (:meth:`_slo_chunk`).  When nothing
        is decode-active, the top-ranked prefilling request is granted a
        chunk unconditionally — an otherwise-idle slot must make
        progress."""
        victims = {r.rid for r in dec.preempt}
        cands = sorted(
            [r for rid, r in self.prefilling.items() if rid not in victims]
            + list(dec.admit), key=self._rankkey)
        decoders = [rid for rid in self.running
                    if rid not in victims and rid not in self.prefilling]
        n_decode = len(decoders)
        decode_tokens = sum(self.decode_cost(rid) for rid in decoders)
        self.decode_tokens_planned += decode_tokens
        left: Optional[int] = None
        if self.cfg.token_budget is not None:
            left = max(0, self.cfg.token_budget - decode_tokens)
        grants: List[Tuple[Request, int]] = []
        for r in cands:
            remaining = self.prefill_target(r) - r.prefill_pos
            if remaining <= 0:
                continue
            n = self._slo_chunk(r, remaining, now)
            if left is not None:
                n = min(n, left)
            if n <= 0:
                if grants or n_decode > 0:
                    break               # budget exhausted; decode advances
                n = min(self.cfg.prefill_chunk, remaining)  # idle-slot rule
            grants.append((r, n))
            if left is not None:
                left -= n
            self.prefill_grants += 1
            self.prefill_tokens += n
        return grants

    # ------------------------------------------- engine acknowledgements --
    def mark_admitted(self, r: Request, now: float):
        """The request owns a row.  Monolithic mode: it is immediately
        decode-ready.  Chunked mode: it enters the prefilling state and
        leaves it via :meth:`mark_prefill_done`."""
        self.running[r.rid] = r
        self.admissions += 1
        if self.cfg.prefill_chunk > 0 and self.cfg.policy == "continuous":
            r.prefill_pos = 0
            self.prefilling[r.rid] = r
        since = self._wait_since.pop(r.rid, None)
        if since is not None:
            self.queue_wait += max(0.0, now - since)

    def mark_prefill_done(self, r: Request):
        """All context chunks ingested: prefilling -> running (drafting)."""
        self.prefilling.pop(r.rid, None)

    def mark_preempted(self, r: Request, now: float):
        """Back to the waiting queue with emitted tokens intact; the engine
        re-prefills prompt+emitted on re-admission.  Partial prefill
        progress is discarded with the freed blocks.  Queue order stays
        rank-FIFO so a preempted old request outranks newer arrivals of the
        same priority class."""
        self.running.pop(r.rid, None)
        self.prefilling.pop(r.rid, None)
        self.decode_depths.pop(r.rid, None)
        r.prefill_pos = 0
        r.preemptions += 1
        self.preemptions += 1
        bisect.insort(self.waiting, r, key=self._rankkey)
        self._wait_since[r.rid] = now

    def mark_finished(self, rid: int):
        self.running.pop(rid, None)
        self.decode_depths.pop(rid, None)
        self.finished.append(rid)

    # ------------------------------------------------------------ stats --
    def snapshot(self) -> SchedulerStats:
        """The typed point-in-time view (serving/stats.py) the engine
        embeds in its own snapshot: queue/lifecycle counters plus the
        most urgent outstanding next-token deadline."""
        return SchedulerStats(
            queue_depth=self.queue_depth,
            waiting=len(self.waiting),
            running=len(self.running),
            prefilling=len(self.prefilling),
            admissions=self.admissions,
            preemptions=self.preemptions,
            finished=len(self.finished),
            stolen=self.stolen,
            queue_wait=self.queue_wait,
            min_deadline=min_outstanding_deadline(
                self.outstanding_requests()),
        )

    @property
    def stats(self) -> dict:
        return {
            "policy": self.cfg.policy,
            "kv_budget": self.kv_budget,
            "slo_aware": self.cfg.slo_aware,
            "admissions": self.admissions,
            "preemptions": self.preemptions,
            "finished": len(self.finished),
            "stolen": self.stolen,
            "queue_wait": self.queue_wait,
            "prefill_chunk": self.cfg.prefill_chunk,
            "prefill_grants": self.prefill_grants,
            "prefill_tokens": self.prefill_tokens,
            "decode_tokens_planned": self.decode_tokens_planned,
            "slo_chunk_boosts": self.slo_chunk_boosts,
        }
