"""Speculation/verification pipelining via micro-batches (paper §V-B).

Heterogeneous SSMs finish drafting at different times; without pipelining
the LLM idles until the slowest SSM completes (paper Fig. 6a).  SPIN splits
each SSM's batch into micro-batches: as soon as a micro-batch's draft is
done it queues for LLM verification while the SSM drafts the next one
(Fig. 6b).

Two layers here:

* an *event-time simulator* (deterministic, host-side): given per-SSM draft
  time models and an LLM verification time model, compute the makespan and
  LLM idle time of a micro-batched schedule.  This is the "offline profile"
  the paper uses to evaluate splits without running them.

* the paper's split heuristic: start at b0 = 2 micro-batches per SSM and
  keep increasing while simulated throughput does not degrade by more than
  ``tol``; stop at the first significant drop (§V-B).

On a deployment the schedule is realized by dispatching draft and verify
computations to disjoint device groups (serving/engine.py).
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import List, Optional, Sequence, Tuple


@dataclasses.dataclass
class CostModel:
    """Simple latency models (seconds).  Defaults follow the shape of the
    paper's measurements: drafting ~ linear in batch and SSM size;
    verification ~ affine in query tokens + attention KV cells (so padded
    vs decomposed-packed KV grids cost differently, paper §V-A)."""
    ssm_time_per_token: Sequence[float]      # per SSM: sec per drafted token
    ssm_fixed: Sequence[float]               # per SSM: launch overhead
    llm_fixed: float                         # verification launch overhead
    llm_time_per_token: float                # sec per (gamma+1) query token
    gamma: int = 4                           # default draft depth per request
    llm_time_per_kv_cell: float = 0.0        # sec per attended KV cell

    def draft_time(self, ssm: int, batch: int,
                   tokens: Optional[float] = None) -> float:
        """Draft latency for ``batch`` requests; ``tokens`` overrides the
        total drafted-token count (per-request adaptive depths make it
        != batch * gamma)."""
        if batch <= 0:
            return 0.0
        if tokens is None:
            tokens = batch * self.gamma
        return self.ssm_fixed[ssm] + self.ssm_time_per_token[ssm] * tokens

    def verify_time(self, batch: int, kv_cells: float = 0.0,
                    q_tokens: Optional[float] = None) -> float:
        """Verification latency; ``q_tokens`` overrides the LLM query-token
        count (ragged depths: Σ (k_i + 1) instead of batch * (gamma+1))."""
        if batch <= 0:
            return 0.0
        if q_tokens is None:
            q_tokens = batch * (self.gamma + 1)
        return (self.llm_fixed
                + self.llm_time_per_token * q_tokens
                + self.llm_time_per_kv_cell * kv_cells)

    def prefill_time(self, tokens: int, kv_cells: float = 0.0) -> float:
        """LLM time to ingest prompt tokens (monolithic admission or the
        slot's chunk grants): affine in query tokens plus the attended
        KV cells, same per-token rates as verification — prefill queries
        run through the identical forward."""
        if tokens <= 0:
            return 0.0
        return (self.llm_fixed + self.llm_time_per_token * tokens
                + self.llm_time_per_kv_cell * kv_cells)


@dataclasses.dataclass
class SimResult:
    makespan: float
    llm_busy: float
    llm_idle_frac: float
    per_ssm_finish: List[float]


def _per_req(val, j: int, default: float = 0.0) -> float:
    """Per-request quantity for SSM j, given either a scalar (uniform
    across SSMs) or a per-SSM sequence.

    Continuous batching makes per-slot batches ragged: each SSM drafts for
    however many requests are currently assigned to it, and those requests
    have genuinely different context lengths (``kv_cells_per_req``) and —
    with the goodput-aware gamma controller — genuinely different draft
    depths (``depth_per_req``)."""
    if val is None:
        return default
    if isinstance(val, (int, float)):
        return float(val)
    return float(val[j])


def simulate(cost: CostModel, ssm_batches: Sequence[int],
             micro_batches: Sequence[int],
             kv_cells_per_req=0.0, prefill_time: float = 0.0,
             depth_per_req=None, verify_extra_per_req=None) -> SimResult:
    """Event-time simulation of one speculation+verification iteration.

    ssm_batches[j]: requests drafted on SSM j.  micro_batches[j]: number of
    micro-batches SSM j splits into.  The LLM verifies micro-batches FIFO as
    they become ready; verification of micro-batch m overlaps drafting of
    m+1 (paper Fig. 6b).  kv_cells_per_req: attended KV cells per request —
    scalar (padded grid, §V-A) or per-SSM sequence (ragged per-slot batches
    under continuous batching).  depth_per_req: draft depth per request —
    scalar or per-SSM sequence of mean granted depths (the gamma
    controller makes speculation depth a per-request quantity; default
    cost.gamma reproduces the uniform-depth model).  prefill_time: LLM
    time spent ingesting prompt tokens this slot (chunked-prefill grants
    or a monolithic admission); it occupies the LLM before any
    verification starts, while SSM drafting proceeds concurrently — the
    interleaving a token-budget step planner exists to bound.
    verify_extra_per_req: extra LLM query tokens per request beyond the
    linear k+1 — tree speculation verifies one root copy per branch, so
    a b-branch tree costs ``k + b`` query tokens (extra = b - 1); the
    default 0 reproduces the linear model exactly."""
    ready: List[Tuple[float, int, int]] = []   # (ready_time, ssm, size)
    finish = [0.0] * len(ssm_batches)
    for j, (bj, mj) in enumerate(zip(ssm_batches, micro_batches)):
        if bj <= 0:
            continue
        kj = _per_req(depth_per_req, j, cost.gamma)
        mj = max(1, min(mj, bj))
        sizes = [bj // mj + (1 if r < bj % mj else 0) for r in range(mj)]
        t = 0.0
        for sz in sizes:
            t += cost.draft_time(j, sz, tokens=sz * kj)
            heapq.heappush(ready, (t, j, sz))
        finish[j] = t
    llm_t = max(0.0, float(prefill_time))
    busy = llm_t
    while ready:
        rt, j, sz = heapq.heappop(ready)
        start = max(llm_t, rt)
        kj = _per_req(depth_per_req, j, cost.gamma)
        vx = _per_req(verify_extra_per_req, j)
        dur = cost.verify_time(sz, _per_req(kv_cells_per_req, j) * sz,
                               q_tokens=sz * (kj + 1 + vx))
        llm_t = start + dur
        busy += dur
    makespan = llm_t
    idle = 1.0 - busy / makespan if makespan > 0 else 0.0
    return SimResult(makespan=makespan, llm_busy=busy, llm_idle_frac=idle,
                     per_ssm_finish=finish)


def goodput_estimate(cost: CostModel, ssm_batches: Sequence[int],
                     micro_batches: Sequence[int],
                     accept_rates: Sequence[float],
                     kv_cells_per_req=0.0, depth_per_req=None,
                     verify_extra_per_req=None) -> float:
    """Accepted tokens per second for one iteration under the schedule."""
    sim = simulate(cost, ssm_batches, micro_batches, kv_cells_per_req,
                   depth_per_req=depth_per_req,
                   verify_extra_per_req=verify_extra_per_req)
    if sim.makespan <= 0:
        return 0.0
    tokens = sum(b * (a * _per_req(depth_per_req, j, cost.gamma) + 1.0)
                 for j, (b, a) in enumerate(zip(ssm_batches, accept_rates)))
    return tokens / sim.makespan


def choose_micro_batches(cost: CostModel, ssm_batches: Sequence[int],
                         accept_rates: Sequence[float], *, b0: int = 2,
                         tol: float = 0.02, max_mb: int = 16,
                         kv_cells_per_req=0.0,
                         depth_per_req=None,
                         verify_extra_per_req=None) -> Tuple[List[int], float]:
    """Paper §V-B heuristic: iteratively split each SSM's batch further while
    the (offline-profiled) throughput does not significantly degrade."""
    n = len(ssm_batches)
    mb = [1] * n
    best = goodput_estimate(cost, ssm_batches, mb, accept_rates,
                            kv_cells_per_req, depth_per_req,
                            verify_extra_per_req)
    cur = [min(b0, max(1, b)) for b in ssm_batches]
    cur_g = goodput_estimate(cost, ssm_batches, cur, accept_rates,
                             kv_cells_per_req, depth_per_req,
                             verify_extra_per_req)
    if cur_g >= best * (1 - tol):
        mb, best = cur, max(best, cur_g)
        while max(mb) < max_mb:
            nxt = [min(m + 1, max(1, b)) for m, b in zip(mb, ssm_batches)]
            if nxt == mb:
                break
            g = goodput_estimate(cost, ssm_batches, nxt, accept_rates,
                                 kv_cells_per_req, depth_per_req,
                                 verify_extra_per_req)
            if g < best * (1 - tol):        # significant degradation: stop
                break
            if g > best:
                best = g
            mb = nxt
    return mb, best


def sweep_micro_batches(cost: CostModel, ssm_batches: Sequence[int],
                        accept_rates: Sequence[float], max_mb: int = 10
                        ) -> List[Tuple[int, float]]:
    """Goodput for m = 1..max_mb uniform micro-batches (paper Fig. 13)."""
    out = []
    for m in range(1, max_mb + 1):
        g = goodput_estimate(cost, ssm_batches, [m] * len(ssm_batches),
                             accept_rates)
        out.append((m, g))
    return out


def profile_cost_model(ssm_bundles, llm_bundle, gamma: int,
                       sample_batch: int = 2, sample_len: int = 32
                       ) -> CostModel:
    """Offline profiling (paper: 'we can offline profile the inference
    throughput of the LLM with different workloads').  Measures wall-clock
    draft/verify latency of the actual models on their device."""
    import time

    import torch

    def _time(fn, device):
        fn()                       # warm up
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return (time.perf_counter() - t0) / 3

    def _zeros(b, n):
        return torch.zeros((sample_batch, n), dtype=torch.int32,
                           device=b.device)

    def _lens(b):
        return torch.full((sample_batch,), sample_len, dtype=torch.int32,
                          device=b.device)

    per_tok, fixed = [], []
    for b in ssm_bundles:
        _, cache = b.prefill(_zeros(b, sample_len), _lens(b),
                             sample_len + gamma + 2)
        t = _time(lambda c=cache, bb=b: bb.decode(c, _zeros(bb, 1),
                                                  _lens(bb)), b.device)
        per_tok.append(t / sample_batch)
        fixed.append(t * 0.15)       # dispatch overhead (measured slope)
        del cache
    _, cache = llm_bundle.prefill(_zeros(llm_bundle, sample_len),
                                  _lens(llm_bundle), sample_len + gamma + 2)
    tv = _time(lambda: llm_bundle.decode(
        cache, _zeros(llm_bundle, gamma + 1), _lens(llm_bundle)),
        llm_bundle.device)
    per_q = tv / (sample_batch * (gamma + 1))
    return CostModel(ssm_time_per_token=per_tok, ssm_fixed=fixed,
                     llm_fixed=tv * 0.15,
                     llm_time_per_token=0.6 * per_q,
                     # remaining 40% of verify cost scales with KV cells
                     llm_time_per_kv_cell=0.4 * per_q / max(sample_len, 1),
                     gamma=gamma)
