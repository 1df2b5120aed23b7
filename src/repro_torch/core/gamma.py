"""Goodput-aware speculation-depth control (per-request gamma).

SPIN's LBSS selector (§IV) learns which SSM drafts best for each request,
but the seed engine still drafted a *fixed* ``gamma`` tokens for every
request every slot.  That is the wrong depth almost everywhere: a request
whose drafts are nearly always accepted should speculate deeper (more
committed tokens per LLM verification launch), while a request whose
drafts are mostly rejected burns ``gamma + 1`` verification query tokens
to commit ~1 — SpecServe-style systems make exactly this depth decision
per request, per step.

``GammaController`` chooses a depth ``k ∈ [1, gamma_max]`` for every
decode-active request each slot:

* **expected-goodput argmax** — with per-token acceptance estimate ``a``
  (the selector's per-(request, SSM) running mean, shared within request
  groups like every other LBSS estimate), the expected committed tokens
  of a depth-``k`` iteration under the standard i.i.d. acceptance model
  is ``E(k) = (1 - a^(k+1)) / (1 - a)`` (accepted prefix + bonus token),
  and its marginal cost is ``draft(k) + verify(k + 1)`` from the same
  ``CostModel`` the pipeline simulator uses.  The controller picks the
  ``k`` maximizing ``E(k) / time(k)``.  ``E`` is log-supermodular in
  ``(k, a)``, so the granted depth is monotone non-decreasing in the
  acceptance estimate — property-tested in tests/test_gamma.py.  Before
  the selector has any acceptance observation the controller grants the
  configured default depth ``gamma`` (the cold-start contract of
  ``--gamma`` under the adaptive policy).

* **load-aware cap** — when the step planner's token budget is contended
  (a ``token_budget`` is set and this slot's plan already granted prompt
  chunks from the same budget), the controller trims the deepest grants
  until the decode demand ``Σ (k_i + 1)`` fits the budget net of the
  granted chunk tokens, so speculation depth never starves prompt
  ingestion.  Every request keeps at least depth 1 (the slot still
  commits ≥ 1 token per request).

* **deadline-headroom cap** — when a request carries an SLO (the
  engine passes per-request seconds-to-deadline via ``slo_slack``),
  deep speculation is only granted if the TPOT slack affords a *failed*
  verify: a depth-``k`` iteration whose drafts all get rejected still
  pays ``iteration_time(ssm, k)`` to commit one token, so the depth is
  trimmed to the largest ``k`` whose iteration time fits the slack
  (floor 1).  SpecServe/AdaSpec condition depth on exactly this term;
  deadline-free requests are untouched.

The ``fixed`` policy returns ``cfg.gamma`` for every request
unconditionally and is bit-identical to the pre-controller engine.

Invariants (previously stated only in PR descriptions):

* **Grant bounds** — every granted depth satisfies
  ``1 <= k_i <= gamma_max``: depth 1 is the progress floor (each slot
  still commits >= 1 token per request), ``gamma_max`` is the worst case
  everything else reserves.
* **KV margins** — a depth-``k_i`` slot writes speculative KV at exactly
  ``[ctx, ctx + k_i + 1)`` (drafts + bonus token); the engine grows /
  scrubs per-row windows at ``ctx + k_i + 1``, while admission, pool
  sizing, switch-precompute widths and the scheduler's ``kv_need`` all
  reserve ``ctx + gamma_max + 1`` — a grant can never make an admitted
  request overflow its reservation.
* **Budget currency** — ``token_budget`` / ``reserved_tokens`` are LLM
  query tokens per slot: a decode slot costs ``k_i + 1``, this slot's
  already-granted prompt chunks cost ``reserved_tokens``, and the cap
  trims the deepest grants (deterministically: max depth, ties by rid)
  until the sum fits — the same currency the scheduler's step planner
  spends (``decode_cost``).
* **Losslessness** — depth only moves *when* tokens commit, never
  *which*: greedy speculative decoding emits the LLM's own continuation
  at any depth (tests/test_gamma.py, bench_gamma.py assert
  token-for-token equality between policies).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence

POLICIES = ("fixed", "adaptive")


@dataclasses.dataclass(kw_only=True)
class GammaConfig:
    """Keyword-only like the other engine configs (fields are appended as
    the controller grows)."""

    policy: str = "fixed"
    gamma: int = 4  # fixed depth; adaptive cold-start depth (no estimate)
    gamma_max: int = 4  # adaptive depth cap (fixed policy: == gamma)
    # tree speculation: a depth-k grant is spent as a token TREE of
    # min(branches, k) branches totalling k draft nodes, verified with
    # k + min(branches, k) query tokens (every branch re-verifies its own
    # root copy).  branches=1 is the linear chain: cost k + 1 exactly.
    branches: int = 1
    # replica-class depth cap (elastic fleet): a prefill-heavy replica
    # reserves its verify budget for prompt-chunk ingestion, so its
    # ADAPTIVE grants are clamped to this ceiling (None = no class cap;
    # the fixed policy ignores it — `--gamma-policy fixed` stays
    # bit-identical regardless of replica class).
    depth_cap: Optional[int] = None

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"unknown gamma policy {self.policy!r}")
        if self.gamma < 1:
            raise ValueError("gamma must be >= 1")
        if self.gamma_max < 1:
            raise ValueError("gamma_max must be >= 1")
        if self.branches < 1:
            raise ValueError("branches must be >= 1")
        if self.depth_cap is not None and self.depth_cap < 1:
            raise ValueError("depth_cap must be >= 1 (None = uncapped)")


def expected_tokens(accept: float, k: int) -> float:
    """Expected committed tokens of a depth-k iteration: the accepted
    prefix of k drafts plus the verifier's bonus/correction token, under
    i.i.d. per-token acceptance probability ``accept``."""
    a = min(max(float(accept), 0.0), 1.0)
    if a >= 1.0:
        return float(k + 1)
    return (1.0 - a ** (k + 1)) / (1.0 - a)


class GammaController:
    """Grants a per-request speculation depth each slot.

    ``cost`` is the engine's :class:`repro_torch.core.pipeline.CostModel`;
    ``selector`` is consulted through its optional ``accept_estimate``
    hook (LBSS implements it; baselines without it always grant the
    default depth ``gamma``, degrading the controller to a constant).
    """

    def __init__(self, cfg: GammaConfig, cost, selector=None):
        self.cfg = cfg
        self.cost = cost
        self.selector = selector
        self.granted: Dict[int, int] = {}  # last grant per live request
        self.grants = 0  # total per-request grants issued
        self.depth_sum = 0  # sum of granted depths (mean = sum/grants)
        self.capped = 0  # grants trimmed by the load-aware cap
        self.slo_capped = 0  # grants trimmed by the deadline-headroom cap
        self.class_capped = 0  # grants trimmed by the replica-class cap
        self.depth_hist: Dict[int, int] = {}  # depth -> grant count
        self._best: Dict[tuple, int] = {}  # (ssm, quantized a) -> depth

    # ------------------------------------------------------- estimates --
    def accept_estimate(self, rid: int, ssm: int) -> Optional[float]:
        """The selector's acceptance estimate for (request, SSM), clamped
        to [0, 1]; None before any observation exists (cold start) or
        when the selector has no ``accept_estimate`` hook (baselines)."""
        est = None
        if self.selector is not None:
            hook = getattr(self.selector, "accept_estimate", None)
            if hook is not None:
                est = hook(rid, ssm)
        if est is None:
            return None
        return min(max(float(est), 0.0), 1.0)

    def _depth_for(self, rid: int, ssm: int) -> int:
        est = self.accept_estimate(rid, ssm)
        if est is None:
            # cold start: the configured default depth, clamped to the cap
            return min(self.cfg.gamma, self.cfg.gamma_max)
        return self.best_depth(est, ssm)

    def iteration_time(self, ssm: int, k: int) -> float:
        """Marginal cost of one depth-k draft+verify iteration for one
        request: the same affine models the pipeline simulator uses,
        without the batching/KV terms (they are shared across the slot
        and do not change the per-request argmax).  Under tree
        speculation the verify pass carries ``k + min(branches, k)``
        query tokens (k draft nodes + one root copy per branch)."""
        b_eff = max(1, min(self.cfg.branches, k))
        return self.cost.draft_time(ssm, 1, tokens=k) + self.cost.verify_time(
            1, q_tokens=k + b_eff
        )

    def best_depth(self, accept: float, ssm: int) -> int:
        """argmax_k E(k) / time(k) over k in [1, gamma_max]; ties break
        toward the shallower depth (less KV + verify pressure)."""
        a = min(max(float(accept), 0.0), 1.0)
        key = (ssm, round(a * 256))
        hit = self._best.get(key)
        if hit is not None:
            return hit
        best_k, best_g = 1, -1.0
        for k in range(1, self.cfg.gamma_max + 1):
            g = expected_tokens(a, k) / max(self.iteration_time(ssm, k), 1e-12)
            if g > best_g * (1.0 + 1e-12):
                best_k, best_g = k, g
        self._best[key] = best_k
        return best_k

    # ----------------------------------------------------------- grant --
    def grant(
        self,
        ids: Sequence[int],
        assign: Mapping[int, int],
        *,
        token_budget: Optional[int] = None,
        reserved_tokens: int = 0,
        slo_slack: Optional[Mapping[int, float]] = None,
    ) -> Dict[int, int]:
        """Depths for this slot's decode-active requests.  ``assign`` maps
        request -> SSM (the selector's placement this slot);
        ``reserved_tokens`` is the budget already committed to this
        slot's prefill chunk grants; ``slo_slack`` maps request ->
        seconds until its next-token deadline (only SLO-carrying
        requests appear — absent/None means no deadline pressure)."""
        if self.cfg.policy == "fixed":
            depths = {rid: self.cfg.gamma for rid in ids}
        else:
            depths = {rid: self._depth_for(rid, assign.get(rid, 0)) for rid in ids}
            if self.cfg.depth_cap is not None:
                cap = self.cfg.depth_cap
                for rid, k in depths.items():
                    if k > cap:
                        self.class_capped += k - cap
                        depths[rid] = cap
            self._apply_slo_cap(depths, assign, slo_slack)
            self._apply_budget_cap(depths, token_budget, reserved_tokens)
        for rid, k in depths.items():
            self.granted[rid] = k
            self.grants += 1
            self.depth_sum += k
            self.depth_hist[k] = self.depth_hist.get(k, 0) + 1
        return depths

    def _apply_slo_cap(
        self,
        depths: Dict[int, int],
        assign: Mapping[int, int],
        slo_slack: Optional[Mapping[int, float]],
    ) -> None:
        """Deadline-headroom cap (SpecServe/AdaSpec): a deep grant is only
        worth its KV + verify cost if the request's TPOT slack affords
        the *whole* draft+verify iteration — when drafts get rejected, a
        depth-k iteration still pays ``iteration_time(ssm, k)`` to commit
        one token, so a request close to its deadline must speculate
        shallow.  Trims each SLO-carrying request's depth to the largest
        ``k`` whose iteration time fits its slack; depth 1 is the floor
        (the request still needs a verify launch to make progress at
        all, and a late token beats no token)."""
        if not slo_slack:
            return
        for rid, k in depths.items():
            slack = slo_slack.get(rid)
            if slack is None or slack <= 0 or k <= 1:
                # no contract, or already past the deadline — a late
                # request gains nothing from shallow grants (the next
                # token cannot meet its deadline either way), so it keeps
                # the throughput-optimal depth to catch up fastest
                continue
            ssm = assign.get(rid, 0)
            while k > 1 and self.iteration_time(ssm, k) > slack:
                k -= 1
            if k < depths[rid]:
                self.slo_capped += depths[rid] - k
                depths[rid] = k

    def _apply_budget_cap(
        self,
        depths: Dict[int, int],
        token_budget: Optional[int],
        reserved_tokens: int,
    ) -> None:
        """Trim the deepest grants until decode demand Σ(k_i + 1) fits the
        token budget net of the prompt-chunk tokens this slot's plan
        already granted, so decode + prefill together respect the step
        planner's bound (up to the depth-1 floor, the decode analogue of
        the idle-slot progress rule).  Deterministic: always trims the
        currently-deepest grant, ties by request id."""
        if token_budget is None or not depths:
            return
        avail = token_budget - max(0, int(reserved_tokens))
        avail = max(avail, 2 * len(depths))  # floor: depth 1 + bonus each

        def node_cost(k: int) -> int:
            # verify query tokens of a depth-k grant: the k draft nodes
            # plus one root copy per branch (linear: k + 1)
            return k + max(1, min(self.cfg.branches, k))

        while sum(node_cost(k) for k in depths.values()) > avail:
            rid = min(depths, key=lambda r: (-depths[r], r))
            if depths[rid] <= 1:
                break
            depths[rid] -= 1
            self.capped += 1

    # ---------------------------------------------------------- engine --
    def retire(self, rid: int) -> None:
        self.granted.pop(rid, None)

    @property
    def stats(self) -> dict:
        return {
            "policy": self.cfg.policy,
            "gamma_max": self.cfg.gamma_max,
            "grants": self.grants,
            "mean_depth": self.depth_sum / self.grants if self.grants else 0.0,
            "capped": self.capped,
            "slo_capped": self.slo_capped,
            "class_capped": self.class_capped,
            "depth_hist": dict(sorted(self.depth_hist.items())),
        }
