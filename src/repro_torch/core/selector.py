"""Learning-based SSM selection (paper §IV, Algorithms 1+2).

The SSM-selection problem is a multi-armed bandit over heterogeneous SSMs.
Time is divided into epochs k = 1, 2, ...; each epoch runs

  Exploration (alpha slots, grouped into chunks of beta slots): requests get
  RANDOM SSMs, re-drawn once per chunk (chunking bounds the switching cost,
  Fig. 8), batch caps B_j enforced by dropping overflow to other SSMs.
  Goodput observations r_{i,j}(t) update running means g~_{i,j}.

  Exploitation (2^k slots): assignment = maximum-weight bipartite matching
  between requests and B_j-replicated SSM slots on the estimated goodputs —
  the paper's KM algorithm; we use scipy's Hungarian implementation
  (linear_sum_assignment) with a pure-python auction fallback.

Regret = goodput regret + lambda * switching (KV recompute) cost; Theorem 1
gives O(log2 T) — tests/test_selector.py checks the empirical curve.

Baselines from §VI-B2: Greedy (prompt-length buckets) and epsilon-greedy.
"""

from __future__ import annotations

import dataclasses
import random
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

try:
    from scipy.optimize import linear_sum_assignment as _lsa
    _HAVE_SCIPY = True
except Exception:                                      # pragma: no cover
    _HAVE_SCIPY = False


def km_match(weights: np.ndarray) -> List[int]:
    """Maximum-weight matching of rows (requests) to columns (SSM slots).
    Returns col index per row (-1 if unmatched).  weights: (N, S)."""
    n, s = weights.shape
    if _HAVE_SCIPY:
        # pad to square so every request can stay unmatched at weight 0
        size = max(n, s)
        pad = np.zeros((size, size))
        pad[:n, :s] = weights
        rows, cols = _lsa(pad, maximize=True)
        out = [-1] * n
        for r, c in zip(rows, cols):
            if r < n and c < s:
                out[r] = int(c)
        return out
    return _greedy_match(weights)


def _greedy_match(weights: np.ndarray) -> List[int]:  # pragma: no cover
    n, s = weights.shape
    order = np.dstack(np.unravel_index(
        np.argsort(-weights, axis=None), weights.shape))[0]
    used_r, used_c = set(), set()
    out = [-1] * n
    for r, c in order:
        if r in used_r or c in used_c:
            continue
        out[int(r)] = int(c)
        used_r.add(int(r))
        used_c.add(int(c))
    return out


@dataclasses.dataclass
class SelectorConfig:
    n_ssms: int
    batch_limits: Sequence[int]          # B_j per SSM
    alpha: int = 6                       # exploration slots per epoch
    beta: int = 2                        # chunk size (slots per chunk)
    lam: float = 0.1                     # switching-cost weight in regret
    seed: int = 0


class LBSS:
    """Stateful selector: call ``assign(request_ids)`` once per time slot,
    then ``observe(request_id, ssm, goodput)`` with measured goodput.

    Beyond-paper extension: optional ``group_of`` maps request -> cluster
    (e.g. dataset / difficulty-marker).  Goodput estimates are then shared
    WITHIN a cluster, so short-lived requests exploit what earlier requests
    of the same kind already learned (hierarchical bandit).  With no
    group_of each request is its own group = the paper's per-request MAB."""

    def __init__(self, cfg: SelectorConfig, group_of=None):
        self.cfg = cfg
        self.group_of = group_of or {}
        self.rng = random.Random(cfg.seed)
        self.epoch = 1
        self.slot_in_phase = 0
        self.phase = "explore"
        self.sum: Dict[Tuple[int, int], float] = defaultdict(float)
        self.cnt: Dict[Tuple[int, int], int] = defaultdict(int)
        # per-(group, SSM) draft-acceptance running means, the input the
        # goodput-aware gamma controller (core/gamma.py) reads.  Kept
        # separate from goodput: goodput folds in batch/timing effects,
        # acceptance is the pure draft-quality signal the depth argmax
        # needs.
        self.acc_sum: Dict[Tuple[int, int], float] = defaultdict(float)
        self.acc_cnt: Dict[Tuple[int, int], int] = defaultdict(int)
        self._chunk_assign: Dict[int, int] = {}
        self._exploit_assign: Dict[int, int] = {}
        self._exploit_cohort: frozenset = frozenset()
        self.switches = 0
        self._last: Dict[int, int] = {}

    def retire(self, request_id: int):
        """Drop a departed request (finished or preempted) from live
        assignment state.  Under continuous batching the cohort changes
        every slot; stale entries would otherwise occupy matching slots and
        pin exploitation assignments to dead requests.  Learned goodput
        estimates are kept — a preempted request (or its group) resumes
        with everything it already learned."""
        self._chunk_assign.pop(request_id, None)
        self._exploit_assign.pop(request_id, None)
        self._last.pop(request_id, None)
        self._exploit_cohort = self._exploit_cohort - {request_id}

    def _group(self, i: int):
        return self.group_of.get(i, i)

    # -- estimates ----------------------------------------------------------
    def estimate(self, i: int, j: int) -> float:
        g = self._group(i)
        c = self.cnt[(g, j)]
        if c == 0:
            # optimistic default: global mean (encourages coverage)
            tot = sum(self.sum.values())
            n = sum(self.cnt.values())
            return tot / n if n else 0.0
        return self.sum[(g, j)] / c

    def observe(self, request_id: int, ssm: int, goodput: float):
        g = self._group(request_id)
        self.sum[(g, ssm)] += goodput
        self.cnt[(g, ssm)] += 1

    def observe_accept(self, request_id: int, ssm: int, rate: float):
        """Record one iteration's draft-acceptance fraction
        (accepted / drafted) for the request's group on this SSM."""
        g = self._group(request_id)
        self.acc_sum[(g, ssm)] += float(rate)
        self.acc_cnt[(g, ssm)] += 1

    def accept_estimate(self, request_id: int, ssm: int) -> Optional[float]:
        """Mean acceptance rate of the request's group on this SSM; falls
        back to the global mean over all (group, SSM) pairs, and to None
        before any observation at all (the gamma controller then applies
        its prior).  Like ``estimate``, survives retire() — a re-admitted
        request resumes with everything its group already learned."""
        g = self._group(request_id)
        c = self.acc_cnt[(g, ssm)]
        if c:
            return self.acc_sum[(g, ssm)] / c
        n = sum(self.acc_cnt.values())
        if n:
            return sum(self.acc_sum.values()) / n
        return None

    # -- assignment ---------------------------------------------------------
    def _random_capped(self, request_ids: Sequence[int]) -> Dict[int, int]:
        """Algorithm 2 lines 3-11: random choice then cap at B_j."""
        M = self.cfg.n_ssms
        assign = {i: self.rng.randrange(M) for i in request_ids}
        for j in range(M):
            members = [i for i, a in assign.items() if a == j]
            cap = self.cfg.batch_limits[j]
            overflow = members[cap:]
            if overflow:
                # reassign overflow to SSMs with headroom
                for i in overflow:
                    for j2 in sorted(range(M), key=lambda x: self.rng.random()):
                        load = sum(1 for a in assign.values() if a == j2)
                        if load < self.cfg.batch_limits[j2]:
                            assign[i] = j2
                            break
        return assign

    def _matching(self, request_ids: Sequence[int]) -> Dict[int, int]:
        """Exploitation: KM on estimated goodputs with B_j replicas."""
        slots: List[int] = []
        for j in range(self.cfg.n_ssms):
            slots += [j] * self.cfg.batch_limits[j]
        W = np.zeros((len(request_ids), len(slots)))
        for a, i in enumerate(request_ids):
            for b, j in enumerate(slots):
                W[a, b] = self.estimate(i, j)
        cols = km_match(W)
        out = {}
        load = [0] * self.cfg.n_ssms
        unmatched = []
        for i, c in zip(request_ids, cols):
            if c >= 0:
                out[i] = slots[c]
                load[slots[c]] += 1
            else:
                unmatched.append(i)
        # unmatched requests (all-zero estimates / padding-column ties)
        # fill SSMs by remaining headroom — defaulting them all to SSM 0
        # can overflow its batch cap B_0 and with it the draft pool
        for i in unmatched:
            j = min(range(self.cfg.n_ssms),
                    key=lambda x: load[x] - self.cfg.batch_limits[x])
            out[i] = j
            load[j] += 1
        return out

    def assign(self, request_ids: Sequence[int]) -> Dict[int, int]:
        """One time slot: returns request_id -> ssm index."""
        cfg = self.cfg
        if self.phase == "explore":
            if self.slot_in_phase % cfg.beta == 0:
                self._chunk_assign = self._random_capped(request_ids)
            else:
                # keep chunk assignment; new arrivals get random slots —
                # redirected to the least-loaded SSM when the random pick
                # is already at its batch cap (Algorithm 2's overflow
                # rule; same rng stream when caps never bind)
                load = [0] * cfg.n_ssms
                for r in request_ids:
                    a = self._chunk_assign.get(r)
                    if a is not None:
                        load[a] += 1
                for i in request_ids:
                    if i not in self._chunk_assign:
                        j = self.rng.randrange(cfg.n_ssms)
                        if load[j] >= cfg.batch_limits[j]:
                            j = min(range(cfg.n_ssms),
                                    key=lambda x: load[x]
                                    - cfg.batch_limits[x])
                        self._chunk_assign[i] = j
                        load[j] += 1
            out = {i: self._chunk_assign[i] for i in request_ids}
            self.slot_in_phase += 1
            if self.slot_in_phase >= cfg.alpha:
                self.phase = "exploit"
                self.slot_in_phase = 0
                self._exploit_assign = {}
        else:
            cohort = frozenset(request_ids)
            # Re-match whenever the live cohort changed (admission,
            # completion, preemption) — continuous batching means the set
            # of requests is different slot to slot, and a matching
            # computed for an old cohort misallocates the B_j slots.
            if not self._exploit_assign or cohort != self._exploit_cohort:
                self._exploit_assign = self._matching(request_ids)
                self._exploit_cohort = cohort
            out = {i: self._exploit_assign[i] for i in request_ids}
            self.slot_in_phase += 1
            if self.slot_in_phase >= 2 ** self.epoch:
                self.epoch += 1
                self.phase = "explore"
                self.slot_in_phase = 0
        # switching accounting
        for i, j in out.items():
            if i in self._last and self._last[i] != j:
                self.switches += 1
        self._last.update(out)
        return out

    def predicted_destination(self, request_id: int) -> int:
        """Fast-switching hint (§IV-C): the SSM whose KV cache should be
        pre-computed during idle time = argmax estimated goodput."""
        ests = [self.estimate(request_id, j)
                for j in range(self.cfg.n_ssms)]
        return int(np.argmax(ests))


class EpsilonGreedy:
    """§VI-B2 baseline: prob. eps -> best-known SSM, else random."""

    def __init__(self, cfg: SelectorConfig, eps: float = 0.2):
        self.cfg = cfg
        self.eps = eps
        self.rng = random.Random(cfg.seed)
        self.sum = defaultdict(float)
        self.cnt = defaultdict(int)
        self._last: Dict[int, int] = {}
        self.switches = 0

    def observe(self, request_id, ssm, goodput):
        self.sum[(request_id, ssm)] += goodput
        self.cnt[(request_id, ssm)] += 1

    def retire(self, request_id):
        self._last.pop(request_id, None)

    def assign(self, request_ids):
        out = {}
        load = [0] * self.cfg.n_ssms
        for i in request_ids:
            if self.rng.random() < self.eps:
                ests = [self.sum[(i, j)] / self.cnt[(i, j)]
                        if self.cnt[(i, j)] else 0.0
                        for j in range(self.cfg.n_ssms)]
                j = int(np.argmax(ests))
            else:
                j = self.rng.randrange(self.cfg.n_ssms)
            if load[j] >= self.cfg.batch_limits[j]:
                j = min(range(self.cfg.n_ssms),
                        key=lambda x: load[x] - self.cfg.batch_limits[x])
            load[j] += 1
            out[i] = j
            if i in self._last and self._last[i] != j:
                self.switches += 1
        self._last.update(out)
        return out


class GreedyPromptLength:
    """§VI-B2 baseline: short prompts -> small SSMs, long -> large."""

    def __init__(self, cfg: SelectorConfig, prompt_lens: Dict[int, int]):
        self.cfg = cfg
        self.prompt_lens = prompt_lens
        self._last: Dict[int, int] = {}
        self.switches = 0

    def observe(self, *a, **k):
        pass

    def retire(self, request_id):
        self._last.pop(request_id, None)

    def assign(self, request_ids):
        ordered = sorted(request_ids, key=lambda i: self.prompt_lens.get(i, 0))
        out = {}
        slot_iter = []
        for j in range(self.cfg.n_ssms):
            slot_iter += [j] * self.cfg.batch_limits[j]
        for i, j in zip(ordered, slot_iter):
            out[i] = j
        for i in request_ids:
            out.setdefault(i, self.cfg.n_ssms - 1)
        for i, j in out.items():
            if i in self._last and self._last[i] != j:
                self.switches += 1
        self._last.update(out)
        return out
