"""SPIN's runtime engine (paper §III Fig. 7 + §V) with continuous batching,
on the paged KV layout.

Per time slot:
  0. the continuous-batching scheduler (serving/scheduler.py) admits
     arrived requests into free pool rows and preempts lowest-priority
     requests when the KV budget is exceeded.  With ``prefill_chunk=0``
     admission prefills the whole prompt; with ``prefill_chunk>0`` the
     scheduler grants prompt *chunks*, appended into the row's block table
     while other rows keep decoding;
  1. the selector (LBSS) assigns each active request to an SSM; switches go
     through the SwitchManager (pre-computed switching);
  2. the gamma controller (core/gamma.py) grants every request a
     speculation depth k_i in [1, gamma_max];
  3. every SSM drafts its rows' granted depths through paged decode steps;
  4. the LLM verifies all candidates — packed via request decomposition
     (§V-A, one pass under the Eq. 13 segment mask over the live blocks) or
     padded (``use_packed_verify=False``) — accepting at most k_i per row;
  5. accepted tokens are committed, rejected slots rolled back, the SSMs
     catch up, and goodput/acceptance are observed back into the selector;
     rows of finished requests are recycled in the same step.

The engine clock is the simulated time of the calibrated event simulator
in core/pipeline.py (draft/verify overlap with micro-batch pipelining,
§V-B); wall-clock is recorded beside it.  ``fused_kernels="on"`` routes
every paged attention site through the fused kernels (kernels/ops.py): on
the card, the CUDA kernels ``fused_paged_verify`` (LLM verify) and
``fused_paged_decode`` (drafting, catch-up, chunk appends, padded verify).

Layouts the port does not serve yet raise ``ValueError``: the dense KV
layout and models with recurrent state or sliding windows (ROADMAP Queue
1, dense layout).
"""

from __future__ import annotations

import dataclasses
import math
import time
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import decompose as D
from repro_torch.core import pipeline as P
from repro_torch.core import spec_decode as sd
from repro_torch.core.gamma import GammaConfig, GammaController
from repro_torch.core.switching import SwitchManager
from repro_torch.data.workloads import Request
from repro_torch.kernels import autotune, quant
from repro_torch.serving.paged import paged_compatible
from repro_torch.serving.pool import PagedCachePool
from repro_torch.serving.scheduler import ContinuousScheduler, SchedulerConfig
from repro_torch.serving.stats import slo_summary

_NOT_YET = "waits in ROADMAP Queue 1 (dense layout)"


def _bucket(n: int, align: int = 16) -> int:
    return max(align, int(math.ceil(n / align) * align))


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.int32), device=device)


@dataclasses.dataclass(kw_only=True)
class EngineConfig:
    """Keyword-only, fields and defaults as the reference's EngineConfig."""
    gamma: int = 4
    # "fixed": gamma tokens for every request every slot; "adaptive":
    # expected-goodput depth in [1, gamma_max]
    gamma_policy: str = "fixed"
    gamma_max: Optional[int] = None    # None -> 2 * gamma (adaptive only)
    max_len: int = 256
    capacity: int = 16                 # concurrent requests (LLM pool rows)
    use_packed_verify: bool = True
    use_pipeline: bool = True
    micro_batches: Optional[List[int]] = None   # None -> paper heuristic
    packed_bucket: int = 256           # dense packed-KV bucketing (unused)
    straggler_factor: float = 4.0
    straggler_mitigation: bool = True
    seed: int = 0
    scheduler_policy: str = "continuous"   # or "static" (gang baseline)
    # total KV cells before preemption (rounded down to whole blocks and
    # enforced as the physical block pool); None -> capacity * max_len
    kv_budget: Optional[int] = None
    kv_layout: str = "paged"           # "dense": ROADMAP Queue 1
    block_size: int = 16
    prefill_chunk: int = 0             # 0 = monolithic prefill-on-admit
    token_budget: Optional[int] = None
    # "linear" drafts one chain per request; "tree" splits each granted
    # depth across up to spec_branch branches (CoW-forked rows) verified
    # in one packed pass with a topology mask (needs packed verification;
    # falls back to linear with a warning otherwise)
    spec_shape: str = "linear"
    spec_branch: int = 2
    # "on": every paged attention site goes through the fused kernels
    # (kernels/ops.py); "off": gather + plain attention
    fused_kernels: str = "off"
    kv_dtype: str = "bf16"             # paged block storage: bf16/int8/fp8
    slo_aware: bool = True
    replica_class: str = "general"

    @classmethod
    def from_args(cls, args, *, capacity=None, kv_budget=None, seed=None):
        """Build an EngineConfig from a ``launch.serve.build_parser()``
        namespace; cross-flag validation raises ``ValueError``."""
        if args.block_size <= 0:
            raise ValueError("--block-size must be positive")
        if args.prefill_chunk < 0:
            raise ValueError(
                "--prefill-chunk must be >= 0 (0 disables chunking)")
        if args.token_budget is not None and args.token_budget <= 0:
            raise ValueError("--token-budget must be positive (omit it "
                             "for unthrottled slots)")
        if args.gamma <= 0:
            raise ValueError("--gamma must be positive")
        if args.gamma_max is not None and args.gamma_max <= 0:
            raise ValueError(
                "--gamma-max must be positive (omit it for 2 * --gamma)")
        if args.spec_branch < 1:
            raise ValueError("--spec-branch must be >= 1")
        if args.spec_shape == "tree":
            gmax = (args.gamma if args.gamma_policy == "fixed"
                    else (args.gamma_max if args.gamma_max is not None
                          else 2 * args.gamma))
            max_nodes = D.max_tree_nodes()
            if gmax + min(args.spec_branch, gmax) > max_nodes:
                raise ValueError(
                    f"--spec-shape tree needs gamma_max + branches <= "
                    f"{max_nodes} tree nodes for the "
                    f"{D.ANCESTOR_MASK_BITS}-bit ancestor mask (got "
                    f"--gamma-max {gmax}, --spec-branch "
                    f"{args.spec_branch}); lower one of them")
        return cls(
            gamma=args.gamma, gamma_policy=args.gamma_policy,
            gamma_max=args.gamma_max, max_len=256,
            capacity=(capacity if capacity is not None
                      else (args.capacity if args.capacity is not None
                            else args.requests)),
            use_packed_verify=not args.no_packed,
            use_pipeline=not args.no_pipeline,
            scheduler_policy=args.scheduler,
            kv_budget=kv_budget if kv_budget is not None else args.kv_budget,
            kv_layout=args.kv_layout,
            block_size=args.block_size,
            prefill_chunk=args.prefill_chunk,
            token_budget=args.token_budget,
            spec_shape=args.spec_shape,
            spec_branch=args.spec_branch,
            fused_kernels=args.fused_kernels,
            kv_dtype=args.kv_dtype,
            slo_aware=getattr(args, "slo_profile", "off") != "off",
            seed=seed if seed is not None else args.seed)


class SpinEngine:
    def __init__(self, llm: sd.Bundle, ssms: Sequence[sd.Bundle],
                 selector, ecfg: EngineConfig,
                 cost_model: Optional[P.CostModel] = None):
        self.llm = llm
        self.ssms = list(ssms)
        self.selector = selector
        self.ecfg = ecfg
        if ecfg.kv_layout != "paged":
            raise ValueError(
                f"kv_layout {ecfg.kv_layout!r}: the port serves the paged "
                f"layout; the dense layout {_NOT_YET}")
        for b in [llm] + self.ssms:
            if not paged_compatible(b.cfg) or b.has_recurrent_state:
                raise ValueError(
                    f"{b.cfg.name}: models with recurrent state or sliding "
                    f"windows need the dense layout, which {_NOT_YET}")
        if ecfg.spec_shape not in ("linear", "tree"):
            raise ValueError(f"unknown spec_shape {ecfg.spec_shape!r}")
        if ecfg.spec_branch < 1:
            raise ValueError("spec_branch must be >= 1")
        if ecfg.fused_kernels not in ("on", "off"):
            raise ValueError(
                f"unknown fused_kernels {ecfg.fused_kernels!r}")
        if ecfg.kv_dtype not in quant.KV_DTYPE_NAMES:
            raise ValueError(
                f"unknown kv_dtype {ecfg.kv_dtype!r} "
                f"(expected one of {'/'.join(quant.KV_DTYPE_NAMES)})")
        if ecfg.gamma_policy == "fixed":
            self.gamma_max = ecfg.gamma
        else:
            self.gamma_max = (ecfg.gamma_max if ecfg.gamma_max is not None
                              else 2 * ecfg.gamma)
        # tree speculation rides the packed-verify path; padded verify
        # falls back to linear, as in the reference
        self.tree = ecfg.spec_shape == "tree" and ecfg.use_packed_verify
        if ecfg.spec_shape == "tree" and not self.tree:
            warnings.warn(
                "spec_shape='tree' requires the paged KV layout and packed "
                "verification; falling back to linear speculation",
                stacklevel=2)
        self.branches = ecfg.spec_branch if self.tree else 1
        max_nodes = D.max_tree_nodes()
        if self.tree and self.gamma_max + min(ecfg.spec_branch,
                                              self.gamma_max) > max_nodes:
            raise ValueError(
                f"tree speculation needs gamma_max + branches <= "
                f"{max_nodes} tree nodes for the "
                f"{D.ANCESTOR_MASK_BITS}-bit ancestor mask (got gamma_max="
                f"{self.gamma_max} + min(spec_branch={ecfg.spec_branch}, "
                f"gamma_max) = "
                f"{self.gamma_max + min(ecfg.spec_branch, self.gamma_max)}"
                f"); lower --gamma-max or --spec-branch")
        # fused kernels: resolve each site's config ONCE here (None = the
        # gather path)
        self.fused = ecfg.fused_kernels == "on"
        self.kv_dtype = ecfg.kv_dtype
        shape = "tree" if self.tree else "linear"

        def _fused_cfg(kind, b, s="linear"):
            if not self.fused:
                return None
            return autotune.get_config(
                kind, H=b.cfg.n_heads, Kh=b.cfg.n_kv_heads, D=b.cfg.hd,
                gamma_max=self.gamma_max, block_size=ecfg.block_size,
                shape=s, kv_dtype=self.kv_dtype)

        self.fused_llm_decode = _fused_cfg("decode", llm)
        self.fused_llm_verify = _fused_cfg("verify", llm, shape)
        self.fused_ssm_decode = [_fused_cfg("decode", b) for b in self.ssms]
        # each extra branch needs a pool row to draft/verify through
        row_mult = self.branches
        bs = ecfg.block_size
        bpr = math.ceil(ecfg.max_len / bs)
        self.max_len = bpr * bs                      # block-aligned
        budget = (ecfg.kv_budget if ecfg.kv_budget is not None
                  else ecfg.capacity * self.max_len)
        # the scheduler enforces the block-rounded budget; the pool holds
        # max(budget, one full row) physical blocks (deadlock freedom)
        budget_blocks = max(1, budget // bs)
        self.llm_pool = PagedCachePool(
            llm.cfg, ecfg.capacity * row_mult, self.max_len, bs,
            num_blocks=max(budget_blocks, bpr), kv_dtype=self.kv_dtype,
            device=llm.device)
        # draft pools are capacity-sized (fast switching keeps every row
        # draftable); the budget-constrained pool is the LLM's
        self.ssm_pools = [
            PagedCachePool(b.cfg, selector.cfg.batch_limits[j] * row_mult,
                           self.max_len, bs, kv_dtype=self.kv_dtype,
                           device=b.device)
            for j, b in enumerate(self.ssms)]
        sched_budget = budget_blocks * bs
        self.switcher = SwitchManager(self.ssms)
        self.cost = cost_model or P.CostModel(
            ssm_time_per_token=[1e-4 * (j + 1) for j in range(len(ssms))],
            ssm_fixed=[2e-4] * len(ssms),
            llm_fixed=1e-3, llm_time_per_token=5e-4, gamma=ecfg.gamma)
        if ecfg.replica_class not in ("general", "prefill", "decode"):
            raise ValueError(
                f"unknown replica_class {ecfg.replica_class!r} "
                "(general | prefill | decode)")
        depth_cap = (max(1, math.ceil(self.gamma_max / 2))
                     if ecfg.replica_class == "prefill" else None)
        self.gamma_ctl = GammaController(
            GammaConfig(policy=ecfg.gamma_policy, gamma=ecfg.gamma,
                        gamma_max=self.gamma_max, branches=self.branches,
                        depth_cap=depth_cap),
            self.cost, selector)
        self.failed_ssms: set = set()
        self.requests: Dict[int, Request] = {}
        self.assignment: Dict[int, int] = {}
        self.chunked = (ecfg.prefill_chunk > 0
                        and ecfg.scheduler_policy == "continuous")
        self.slo_aware = ecfg.slo_aware
        self.scheduler = ContinuousScheduler(SchedulerConfig(
            capacity=ecfg.capacity, max_len=self.max_len,
            gamma=self.gamma_max,
            kv_budget=sched_budget, policy=ecfg.scheduler_policy,
            block_size=ecfg.block_size,
            prefill_chunk=ecfg.prefill_chunk if self.chunked else 0,
            token_budget=ecfg.token_budget,
            spec_branches=self.branches,
            slo_aware=ecfg.slo_aware))
        # drafting is greedy; the generator serves temperature > 0 draws
        self.gen = torch.Generator(device=llm.device).manual_seed(ecfg.seed)
        # metrics
        self.sim_time = 0.0
        self.wall_time = 0.0
        self.accepted_tokens = 0
        self.total_drafted = 0
        self.verify_tokens_total = 0       # LLM verify query tokens issued
        self.tree_forks = 0                # CoW row forks (tree mode)
        self.tree_adoptions = 0            # slots won by a non-main branch
        self.prefill_tokens_total = 0
        self.slot_log: List[dict] = []
        self.straggler_redispatches = 0
        self._accept_by_req: Dict[int, List[float]] = {}
        self._prefill_tokens_pending = 0
        self._prefill_cells_pending = 0.0
        self._unstamped: set = set()       # rids awaiting first_token_time

    # ------------------------------------------------------------ admin --
    def add_requests(self, reqs: Sequence[Request]):
        """Submit requests; arrival timestamps are honoured on the sim
        clock."""
        for r in reqs:
            need = r.prompt_len + r.max_new + self.gamma_max + 1
            if need > self.max_len:
                raise ValueError(
                    f"request {r.rid} needs up to {need} KV slots "
                    f"(prompt {r.prompt_len} + max_new {r.max_new} + "
                    f"gamma_max+1) > max_len={self.max_len}")
        self.scheduler.submit(reqs)
        self._schedule()

    def _schedule(self, grant_prefill: bool = False):
        """Apply this instant's scheduler decision: preemptions, then
        admissions, then prefill chunks (``grant_prefill`` only at the start
        of a step, so the chunk budget is spent once per slot)."""
        dec = self.scheduler.plan(self.sim_time,
                                  grant_prefill=grant_prefill)
        for r in dec.preempt:
            self._preempt(r)
        for r in dec.admit:
            if r.first_token_time is None:
                self._unstamped.add(r.rid)
            self._begin_admit(r)
        for r, n in dec.prefill:
            self._prefill_chunk(r, n)

    @staticmethod
    def _context_tokens(r: Request) -> np.ndarray:
        """Committed context to (re-)prefill: the prompt plus emitted
        tokens except the last, which becomes the pool's last_token."""
        return np.concatenate([np.asarray(r.prompt, np.int64),
                               np.asarray(r.emitted[:-1] if r.emitted
                                          else [], np.int64)])

    def _begin_admit(self, r: Request):
        """Grant the request a pool row; monolithic mode prefills the whole
        context here, chunked mode only takes the row."""
        self.requests[r.rid] = r
        if self.chunked:
            r.prefill_pos = 0
            self.llm_pool.insert_empty(r.rid)
            self.scheduler.mark_admitted(r, self.sim_time)
            return
        tokens = self._context_tokens(r)
        L = len(tokens)
        row = np.zeros((1, _bucket(L)), np.int32)
        row[0, :L] = tokens
        dev = self.llm.device
        plen = self.llm_pool.prefill_len(row.shape[1])
        logits, cache = self.llm.prefill(_i32(row, dev), _i32([L], dev), plen)
        last = self._first_token(r, logits, L - 1)
        self.llm_pool.insert(r.rid, cache, L, last)
        self._account_prefill(0, L)
        self.scheduler.mark_admitted(r, self.sim_time)

    def _first_token(self, r: Request, logits, idx: int) -> int:
        """The emitted tail on re-admission, else the greedy pick at the
        last context position."""
        if r.emitted:
            return int(r.emitted[-1])
        V = self.llm.cfg.vocab_size
        last = int(torch.argmax(logits[0, idx, :V].float()).item())
        r.emitted = [last]
        return last

    def _account_prefill(self, pos: int, n: int):
        """Record prefill work (n query tokens from context offset pos) for
        the next slot simulation."""
        self._prefill_tokens_pending += n
        self._prefill_cells_pending += n * pos + n * (n + 1) / 2.0

    def _prefill_chunk(self, r: Request, n: int):
        """Append one prompt chunk into the request's existing row; bucket
        padding carries segment -1 so its KV writes land invalidated."""
        rid = r.rid
        ctx = self._context_tokens(r)
        L = len(ctx)
        pos = r.prefill_pos
        n = min(n, L - pos)
        if n <= 0:
            return
        Tb = _bucket(n, 8)
        toks = np.zeros((1, Tb), np.int32)
        toks[0, :n] = ctx[pos:pos + n]
        segs = np.full((1, Tb), -1, np.int32)
        segs[0, :n] = 0
        dev = self.llm.device
        self.llm_pool.ensure(rid, pos + n)
        bt = self.llm_pool.row_table(rid)
        logits, cache = self.llm.append_paged(
            self.llm_pool.cache, _i32(toks, dev), _i32([pos], dev),
            _i32(segs, dev), bt, self.fused_llm_decode)
        self.llm_pool.cache = cache
        r.prefill_pos = pos + n
        row = self.llm_pool.row_of[rid]
        self.llm_pool.lengths[row] = r.prefill_pos
        self._account_prefill(pos, n)
        if r.prefill_pos >= L:
            self.llm_pool.last_token[row] = self._first_token(r, logits,
                                                              n - 1)
            self.scheduler.mark_prefill_done(r)

    def _preempt(self, r: Request):
        """Release the request's row and draft-pool slot; generated tokens
        stay on the Request."""
        rid = r.rid
        if self.llm_pool.has(rid):
            self.llm_pool.evict(rid)
        j = self.assignment.pop(rid, None)
        if j is not None and self.ssm_pools[j].has(rid):
            self.ssm_pools[j].evict(rid)
        if hasattr(self.selector, "retire"):
            self.selector.retire(rid)
        self.gamma_ctl.retire(rid)
        self.scheduler.mark_preempted(r, self.sim_time)

    def _finish(self, r: Request):
        r.done = True
        r.finish_time = self.sim_time
        self.llm_pool.evict(r.rid)
        j = self.assignment.pop(r.rid, None)
        if j is not None and self.ssm_pools[j].has(r.rid):
            self.ssm_pools[j].evict(r.rid)
        if hasattr(self.selector, "retire"):
            self.selector.retire(r.rid)
        self.gamma_ctl.retire(r.rid)
        self.scheduler.mark_finished(r.rid)

    def fail_ssm(self, j: int):
        """Replica failure: drain its requests, zero its capacity."""
        self.failed_ssms.add(j)
        self.selector.cfg.batch_limits[j] = 0
        for rid in list(self.ssm_pools[j].row_of):
            self.ssm_pools[j].evict(rid)
            self.assignment.pop(rid, None)

    # --------------------------------------------------------- one slot --
    def _active(self) -> List[Request]:
        """Decode-ready requests: own a row AND are fully prefilled."""
        pre = self.scheduler.prefilling
        return [r for r in self.requests.values()
                if not r.done and self.llm_pool.has(r.rid)
                and r.rid not in pre]

    def _consume_prefill(self):
        """(time, tokens) of prefill work issued since the last slot
        simulation; resets the pending counters."""
        toks = self._prefill_tokens_pending
        t = self.cost.prefill_time(toks, self._prefill_cells_pending)
        self.prefill_tokens_total += toks
        self._prefill_tokens_pending = 0
        self._prefill_cells_pending = 0.0
        return t, toks

    def _stamp_tokens(self, r: Request):
        """``token_times[j]``: the sim-clock instant token j was committed."""
        if r.token_times is None:
            r.token_times = []
        while len(r.token_times) < len(r.emitted or []):
            r.token_times.append(self.sim_time)

    def _stamp_first_tokens(self):
        """TTFT: stamped at the end of the slot that paid for the prefill."""
        for rid in list(self._unstamped):
            r = self.requests[rid]
            if r.emitted:
                r.first_token_time = self.sim_time
                self._stamp_tokens(r)
                self._unstamped.discard(rid)

    def step(self) -> dict:
        t_wall = time.perf_counter()
        self._schedule(grant_prefill=True)
        active = self._active()
        if not active:
            nxt = self.scheduler.next_arrival()
            if nxt is not None and not self.scheduler.running:
                # pool drained: fast-forward the sim clock to the next
                # arrival and admit it
                self.sim_time = max(self.sim_time, nxt)
                self._schedule(grant_prefill=True)
                active = self._active()
        if not active:
            if self._prefill_tokens_pending > 0:
                # prefill-only slot: every row is still ingesting context
                pre_t, pre_n = self._consume_prefill()
                self.sim_time += pre_t
                self._stamp_first_tokens()
                self.wall_time += time.perf_counter() - t_wall
                rec = {"tokens": 0, "sim_time": pre_t, "llm_idle": 0.0,
                       "micro_batches": [], "active": 0,
                       "running": len(self.scheduler.running),
                       "queued": len(self.scheduler.waiting),
                       "prefill_tokens": pre_n}
                self.slot_log.append(rec)
                return rec
            return {"done": True}
        ids = [r.rid for r in active]
        assign = self.selector.assign(ids)

        # apply switches / placements
        for rid, j in assign.items():
            if j in self.failed_ssms:
                j = min(set(range(len(self.ssms))) - self.failed_ssms)
                assign[rid] = j
            prev = self.assignment.get(rid)
            if prev == j and self.ssm_pools[j].has(rid):
                continue
            if prev is not None and prev != j and \
                    self.ssm_pools[prev].has(rid):
                self.ssm_pools[prev].evict(rid)
            if not self.ssm_pools[j].has(rid):
                self._place_on_ssm(rid, j, assign)
            self.assignment[rid] = j

        # per-request speculation depths for this slot
        slo_slack = None
        if self.slo_aware:
            slo_slack = {r.rid: r.next_deadline() - self.sim_time
                         for r in active if r.slo is not None} or None
        depths = self.gamma_ctl.grant(
            ids, assign,
            token_budget=self.ecfg.token_budget if self.chunked else None,
            reserved_tokens=self.scheduler.last_prefill_granted,
            slo_slack=slo_slack)
        self.scheduler.set_decode_depths(
            {rid: k + self._beff(k) - 1 for rid, k in depths.items()}
            if self.tree else depths)
        # append-a-block growth: cover context + this slot's granted
        # speculation window (k_i + 1) before decode/verify writes land
        self.llm_pool.ensure_rows({
            r.rid: int(self.llm_pool.lengths[self.llm_pool.row_of[r.rid]])
            + depths[r.rid] + 1 for r in active})

        # draft on every SSM pool (static shapes at the pool's slot-max
        # depth; rows granted less contribute only their k_i-token prefix)
        drafts: Dict[int, object] = {}
        per_ssm_batch = []
        per_ssm_depth = []
        per_ssm_vextra = []
        for j, (b, pool) in enumerate(zip(self.ssms, self.ssm_pools)):
            rids = [r for r in ids if assign.get(r) == j]
            per_ssm_batch.append(len(rids))
            if not rids or j in self.failed_ssms:
                per_ssm_depth.append(float(self.cost.gamma))
                per_ssm_vextra.append(0.0)
                continue
            per_ssm_depth.append(float(np.mean([depths[r] for r in rids])))
            per_ssm_vextra.append(float(np.mean(
                [self._beff(depths[r]) - 1 for r in rids])))
            width = max(depths[r] for r in rids)
            if self.tree:
                cand, branch_map = self._draft_pool_tree(
                    j, width, depths, rids)
                for rid in rids:
                    drafts[rid] = [cand[row, :kk]
                                   for row, kk in branch_map[rid]]
            else:
                cand = self._draft_pool(j, width, depths)
                rows = pool.rows(rids)
                for rid, row in zip(rids, rows):
                    drafts[rid] = cand[row, :depths[rid]]
        self.total_drafted += sum(depths.values())
        self.verify_tokens_total += sum(
            depths[rid] + self._beff(depths[rid]) for rid in ids)

        n_acc, out, out_len = self._verify(ids, drafts, depths)

        # simulated slot timeline (pipeline §V-B)
        accept_rates = self._accept_rates_per_ssm(assign, ids, n_acc, depths)
        kv_cells_per_req = self._kv_cells_per_ssm(assign, ids, depths)
        vextra = per_ssm_vextra if self.tree else None
        if self.ecfg.use_pipeline:
            mb = self.ecfg.micro_batches or P.choose_micro_batches(
                self.cost, per_ssm_batch, accept_rates,
                kv_cells_per_req=kv_cells_per_req,
                depth_per_req=per_ssm_depth,
                verify_extra_per_req=vextra)[0]
        else:
            mb = [1] * len(self.ssms)
        pre_t, pre_n = self._consume_prefill()
        slot = self._simulate_slot(per_ssm_batch, mb, kv_cells_per_req,
                                   prefill_time=pre_t,
                                   depth_per_req=per_ssm_depth,
                                   verify_extra_per_req=vextra)

        # commit tokens, update request state, observe goodput + acceptance
        self.sim_time += slot.makespan
        slot_tokens = 0
        observe_accept = getattr(self.selector, "observe_accept", None)
        for i, rid in enumerate(ids):
            r = self.requests[rid]
            k = int(out_len[i])
            r.emitted.extend(int(x) for x in out[i, :k])
            self._stamp_tokens(r)
            slot_tokens += k
            g = k / max(slot.makespan, 1e-9)
            self.selector.observe(rid, assign[rid], g)
            # per-token acceptance over positions actually tested
            tested = min(depths[rid], int(n_acc[i]) + 1)
            rate = float(n_acc[i]) / tested
            if observe_accept is not None:
                observe_accept(rid, assign[rid], rate)
            self._accept_by_req.setdefault(rid, []).append(rate)
            if len(r.emitted) - 1 >= r.max_new:
                self._finish(r)
        self.accepted_tokens += slot_tokens
        self._stamp_first_tokens()
        self.wall_time += time.perf_counter() - t_wall

        self._precompute_switches(ids)
        self._schedule()

        rec = {"tokens": slot_tokens, "sim_time": slot.makespan,
               "llm_idle": slot.llm_idle_frac, "micro_batches": mb,
               "active": len(ids),
               "running": len(self.scheduler.running),
               "queued": len(self.scheduler.waiting),
               "prefill_tokens": pre_n}
        self.slot_log.append(rec)
        return rec

    # ---------------------------------------------------------- internals --
    def _switch_width(self, j: int, length: int) -> int:
        """Cache width for switch prefills on SSM j: the context's blocks
        plus a gamma_max+1 growth margin."""
        need = min(self.max_len, length + self.gamma_max + 1)
        return self.ssm_pools[j].prefill_len(_bucket(need))

    def _place_on_ssm(self, rid: int, j: int, current):
        """Switch-place ``rid`` on SSM j's pool, evicting residents not
        placed here this slot when the pool is full."""
        r = self.requests[rid]
        tokens = np.concatenate([np.asarray(r.prompt),
                                 np.asarray(r.emitted[:-1], np.int64)])
        length = len(tokens)
        cache, _ = self.switcher.switch(rid, j, tokens, length,
                                        self._switch_width(j, length))
        pool = self.ssm_pools[j]
        while not pool.can_admit(length):
            victim = next((rr for rr in pool.row_of
                           if current.get(rr) != j), None)
            if victim is None:
                raise RuntimeError(
                    f"SSM {j} draft pool over-committed: all "
                    f"{len(pool.row_of)} residents are assigned here this "
                    f"slot — selector batch_limits[{j}] exceeds the pool")
            pool.evict(victim)
        pool.insert(rid, cache, length, r.emitted[-1])

    def _precompute_switches(self, ids):
        if not hasattr(self.selector, "predicted_destination"):
            return
        for rid in ids:
            if rid not in self.requests or self.requests[rid].done:
                continue
            dst = self.selector.predicted_destination(rid)
            if dst == self.assignment.get(rid) or dst in self.failed_ssms:
                continue
            r = self.requests[rid]
            tokens = np.concatenate([np.asarray(r.prompt),
                                     np.asarray(r.emitted[:-1], np.int64)])
            self.switcher.precompute(rid, dst, tokens, len(tokens),
                                     self._switch_width(dst, len(tokens)))

    def _draft_pool(self, j: int, width: int, depths) -> np.ndarray:
        """Draft ``width`` tokens for every row of SSM j's pool; returns
        (capacity, width) candidates.  Idle rows own no blocks, so their
        writes are dropped at the source."""
        b = self.ssms[j]
        pool = self.ssm_pools[j]
        # cover draft writes (ctx..ctx+k_i-1) and the catch-up hole fill
        # (ctx+1..ctx+k_i+1) before any decode lands
        pool.ensure_rows({
            rid: int(pool.lengths[row]) + depths.get(rid, width) + 2
            for rid, row in pool.row_of.items()})
        bt, _ = pool.block_table_array()
        cand, _, cache = sd.draft(
            b, pool.cache, _i32(pool.last_token, b.device)[:, None],
            _i32(pool.lengths, b.device), width, self.gen, block_tables=bt,
            fused_cfg=self.fused_ssm_decode[j])
        pool.cache = cache
        return cand.cpu().numpy()

    # ----------------------------------------------------- tree helpers --
    @staticmethod
    def _brid(rid: int, j: int):
        """Pool key for branch j of request rid (never an integer id)."""
        return ("~branch", rid, j)

    def _beff(self, k) -> int:
        """Effective branch count of a depth-k grant: min(branches, k); 1
        in linear mode."""
        return max(1, min(self.branches, int(k))) if self.tree else 1

    def _draft_pool_tree(self, j: int, width: int, depths, rids):
        """Tree drafting on SSM j: fork a CoW pool row per extra branch,
        draft every row greedily with per-row first-step top-k ranks, then
        evict the fork rows.  Returns (cand (capacity, width),
        branch_map: rid -> [(row, k_j), ...] branch-ordered)."""
        b = self.ssms[j]
        pool = self.ssm_pools[j]
        pool.ensure_rows({
            rid: int(pool.lengths[row]) + depths.get(rid, width) + 2
            for rid, row in pool.row_of.items()})
        need = sum(self._beff(depths[rid]) - 1 for rid in rids)
        free = pool.capacity - len(pool.row_of)
        if free < need:
            keep = set(rids)
            for victim in [r for r in pool.row_of if r not in keep]:
                pool.evict(victim)
                free += 1
                if free >= need:
                    break
        branch_map = {}
        forked = []
        for rid in rids:
            bd = D.split_tree_depths(depths[rid], self.branches)
            L = int(pool.lengths[pool.row_of[rid]])
            entries = [(pool.row_of[rid], bd[0])]
            for jj in range(1, len(bd)):
                brid = self._brid(rid, jj)
                entries.append((pool.fork(rid, brid), bd[jj]))
                forked.append(brid)
            if len(bd) > 1:
                for jj in range(1, len(bd)):
                    pool.cow_prepare(self._brid(rid, jj), L, L + width + 2)
                pool.cow_prepare(rid, L, L + width + 2)
            branch_map[rid] = entries
        ranks = np.zeros(pool.capacity, np.int32)
        for rid in rids:
            for bi, (row, _) in enumerate(branch_map[rid]):
                ranks[row] = bi
        bt, _ = pool.block_table_array()
        cand, cache = sd.draft_tree(
            b, pool.cache, _i32(pool.last_token, b.device)[:, None],
            _i32(pool.lengths, b.device), width, ranks, block_tables=bt,
            fused_cfg=self.fused_ssm_decode[j])
        pool.cache = cache
        for brid in forked:
            pool.evict(brid)
        return cand.cpu().numpy(), branch_map

    def _tree_block_maps(self, ids_np, owner_np, tree_rows, W: int):
        """Per-slot tree metadata for the packed pass: block owners of
        branch rows remap to the request's main row (the verify segment),
        and every gathered KV slot gets a tree-node tag — -1 committed, -2
        dead (a branch's CoW copy of committed straddle cells, or a padding
        slot past the branch's depth), n >= 0 a tree node."""
        pool = self.llm_pool
        bs = pool.block_size
        seg_of_row = {row: seg for row, (seg, _, _) in tree_rows.items()}
        owner_seg = np.array(
            [seg_of_row.get(int(o), int(o)) if o >= 0 else -1
             for o in owner_np], np.int32)
        id2m = {int(blk): m for m, blk in enumerate(ids_np)
                if owner_np[m] >= 0}
        node = np.full((len(ids_np), bs), -1, np.int32)
        for row, (seg_row, off, k) in tree_rows.items():
            L = int(pool.lengths[row])
            nb = int(pool._nb[row])
            if row != seg_row and L % bs:
                # branch rows own a private copy of the straddling tail
                # block; its committed cells duplicate the main row's
                bi0 = L // bs
                if bi0 < nb:
                    m = id2m.get(int(pool._table[row, bi0]))
                    if m is not None:
                        node[m, :L % bs] = -2
            for d in range(W + 1):
                p = L + d
                bi = p // bs
                if bi >= nb:
                    break        # writes past the table were dropped
                m = id2m.get(int(pool._table[row, bi]))
                if m is None:
                    continue
                node[m, p % bs] = (off + d) if d <= k else -2
        return owner_seg, node

    def _verify(self, ids, drafts, depths):
        """LLM verification over the full pool (packed or padded) at the
        slot's max granted depth W; rows granted less carry zero-padded
        candidate tails whose match is masked out."""
        W = max(depths[rid] for rid in ids)
        pool = self.llm_pool
        N = pool.capacity
        dev = self.llm.device
        fork_rows: Dict[int, list] = {}
        tree_rows = None
        if self.tree:
            tree_rows = {}
            for rid in ids:
                bd = D.split_tree_depths(depths[rid], self.branches)
                mrow = pool.row_of[rid]
                L = int(pool.lengths[mrow])
                lst = []
                for jj in range(1, len(bd)):
                    brid = self._brid(rid, jj)
                    brow = pool.fork(rid, brid)
                    lst.append((jj, brid, brow))
                    self.tree_forks += 1
                if lst:
                    # un-share the speculation window (main row last, so it
                    # keeps the originals)
                    for jj, brid, brow in lst:
                        pool.cow_prepare(brid, L, L + W + 2)
                    pool.cow_prepare(rid, L, L + W + 2)
                fork_rows[rid] = lst
                tree_rows[mrow] = (mrow, 0, bd[0])
                off = bd[0] + 1
                for jj, brid, brow in lst:
                    tree_rows[brow] = (mrow, off, bd[jj])
                    off += bd[jj] + 1
        cand = np.zeros((N, W), np.int32)
        k_row = np.zeros(N, np.int64)
        lens_np = np.asarray(pool.lengths, np.int64).copy()
        rows = pool.rows(ids)
        for rid, row in zip(ids, rows):
            if self.tree:
                bd = D.split_tree_depths(depths[rid], self.branches)
                chains = drafts.get(
                    rid, [np.zeros(kk, np.int32) for kk in bd])
                cand[row, :len(chains[0])] = chains[0]
                k_row[row] = bd[0]
                for (jj, brid, brow) in fork_rows[rid]:
                    cand[brow, :len(chains[jj])] = chains[jj]
                    k_row[brow] = bd[jj]
            else:
                d = drafts.get(rid, np.zeros(depths[rid], np.int32))
                cand[row, :len(d)] = d
                k_row[row] = depths[rid]
        inp = np.concatenate(
            [np.asarray(pool.last_token, np.int32)[:, None], cand], axis=1)

        if self.ecfg.use_packed_verify:
            logits = self._verify_packed(inp, lens_np, W,
                                         tree_rows=tree_rows)
        else:
            bt, _ = pool.block_table_array()
            logits, pool.cache = self.llm.decode_paged(
                pool.cache, _i32(inp, dev), _i32(lens_np, dev), bt,
                self.fused_llm_decode)
        V = self.llm.cfg.vocab_size
        greedy = torch.argmax(logits[..., :V].float(), dim=-1)
        greedy = greedy.cpu().numpy().astype(np.int64)       # (N, W+1)
        # per-row depth mask: positions at or beyond a row's grant can
        # never match (they hold padding, not drafts)
        in_depth = np.arange(W)[None] < k_row[:, None]
        match = (greedy[:, :W] == cand) & in_depth
        n_acc_all = np.cumprod(match.astype(np.int64), 1).sum(1)
        idx = np.arange(W + 1)[None]
        out_all = np.where(idx < n_acc_all[:, None],
                           np.pad(cand, ((0, 0), (0, 1))), 0).astype(np.int64)
        out_all[np.arange(N), n_acc_all] = greedy[np.arange(N), n_acc_all]

        # tree: adopt the winning branch per request (longest accepted
        # path; ties land on branch 0), evict the losers
        winner_row = {rid: row for rid, row in zip(ids, rows)}
        if self.tree:
            for rid in ids:
                best_j, best_row = 0, winner_row[rid]
                for (jj, brid, brow) in fork_rows[rid]:
                    if int(n_acc_all[brow]) > int(n_acc_all[best_row]):
                        best_j, best_row = jj, brow
                if best_j != 0:
                    pool.evict(rid)
                    pool.rename(self._brid(rid, best_j), rid)
                    self.tree_adoptions += 1
                for (jj, brid, brow) in fork_rows[rid]:
                    if jj != best_j:
                        pool.evict(brid)
                winner_row[rid] = best_row

        # rollback: keep the accepted prefix only (trim the tail in place)
        pool.invalidate_span(lens_np + 1 + n_acc_all, lens_np + W + 1, W=W)
        # prefilling rows take no part in this verify, but the full-pool
        # forward wrote speculative KV at [len, len+W+1): scrub all of it
        pre_rows = [pool.row_of[rid] for rid in self.scheduler.prefilling
                    if rid in pool.row_of]
        if pre_rows:
            lo = np.zeros(N, np.int64)
            hi = np.zeros(N, np.int64)
            lens_now = np.asarray(pool.lengths, np.int64)
            for row in pre_rows:
                lo[row] = lens_now[row]
                hi[row] = lens_now[row] + W + 1
            pool.invalidate_span(lo, hi, W=W + 1)

        # per-SSM catch-up (fill the c_k hole) + rollback on draft pools
        for j, spool in enumerate(self.ssm_pools):
            if not spool.row_of:
                continue
            pl = np.asarray(spool.lengths, np.int64).copy()
            outs_j = np.zeros((spool.capacity, W + 1), np.int32)
            nacc_j = np.zeros(spool.capacity, np.int64)
            for rid, row in spool.row_of.items():
                lrow = pool.row_of.get(rid)
                if lrow is None:
                    continue
                outs_j[row] = out_all[lrow]
                nacc_j[row] = int(n_acc_all[lrow])
            bt, _ = spool.block_table_array()
            sdev = self.ssms[j].device
            _, spool.cache = self.ssms[j].decode_paged(
                spool.cache, _i32(outs_j, sdev), _i32(pl + 1, sdev), bt,
                self.fused_ssm_decode[j])
            spool.invalidate_span(pl + 2 + nacc_j, pl + W + 3, W=W + 1)

        # update lengths / last tokens on pools
        n_acc = np.zeros(len(ids), np.int64)
        out = np.zeros((len(ids), W + 1), np.int64)
        out_len = np.zeros(len(ids), np.int64)
        for i, rid in enumerate(ids):
            row = winner_row[rid]
            n_acc[i] = int(n_acc_all[row])
            out[i] = out_all[row]
            out_len[i] = n_acc[i] + 1
            pool.lengths[row] += out_len[i]
            pool.last_token[row] = out[i, n_acc[i]]
            j = self.assignment[rid]
            srow = self.ssm_pools[j].row_of[rid]
            self.ssm_pools[j].lengths[srow] += out_len[i]
            self.ssm_pools[j].last_token[srow] = out[i, n_acc[i]]
        return n_acc, out, out_len

    def _verify_packed(self, inp, lens_np, W: int, tree_rows=None):
        """Packed verification via request decomposition (§V-A) at depth
        W: the packed KV is the cohort's live blocks, read straight from
        the pool.  ``tree_rows`` (tree mode) maps pool row -> (main row,
        node offset, branch depth)."""
        pool = self.llm_pool
        N = pool.capacity
        dev = self.llm.device
        bt, _ = pool.block_table_array()
        ids_np, owner_np = pool.live_blocks()
        toks = _i32(inp.reshape(1, -1), dev)
        if tree_rows is not None:
            q_rows, q_pos, q_seg, q_anc = D.build_tree_row_layout(
                lens_np, W, tree_rows)
            owner_np, block_node = self._tree_block_maps(
                ids_np, owner_np, tree_rows, W)
            logits, pool.cache = self.llm.verify_paged_tree(
                pool.cache, toks, _i32(q_pos, dev), _i32(q_seg, dev),
                _i32(q_rows, dev), bt, _i32(ids_np, dev),
                _i32(owner_np, dev), _i32(q_anc, dev), _i32(block_node, dev),
                self.fused_llm_verify)
        else:
            q_rows, q_pos, q_seg = D.build_query_layout(lens_np, W)
            logits, pool.cache = self.llm.verify_paged(
                pool.cache, toks, _i32(q_pos, dev), _i32(q_seg, dev),
                _i32(q_rows, dev), bt, _i32(ids_np, dev),
                _i32(owner_np, dev), self.fused_llm_verify)
        return logits[0].reshape(N, W + 1, -1)

    def _kv_cells_per_ssm(self, assign, ids, depths):
        """Attended KV cells per request, per SSM, for the timing model:
        block-granular (a request costs its allocated blocks)."""
        if not ids:
            return 0.0
        raw = {rid: float(self.llm_pool.allocated_cells(rid)) for rid in ids}
        if not self.ecfg.use_packed_verify:
            # padded paged decode attends the bucketed widest table
            return float(max(raw.values()))
        cells = []
        for j in range(len(self.ssms)):
            vals = [raw[rid] for rid in ids if assign.get(rid) == j]
            cells.append(float(np.mean(vals)) if vals else 0.0)
        return cells

    def _accept_rates_per_ssm(self, assign, ids, n_acc, depths):
        rates = []
        for j in range(len(self.ssms)):
            vals = [n_acc[i] / depths[rid] for i, rid in enumerate(ids)
                    if assign.get(rid) == j]
            rates.append(float(np.mean(vals)) if vals else 0.5)
        return rates

    def _simulate_slot(self, per_ssm_batch, mb, kv_cells_per_req=0.0,
                       prefill_time: float = 0.0,
                       depth_per_req=None,
                       verify_extra_per_req=None) -> P.SimResult:
        cost = self.cost
        if self.ecfg.straggler_mitigation:
            cost = self._with_straggler_mitigation(cost, per_ssm_batch)
        return P.simulate(cost, per_ssm_batch, mb, kv_cells_per_req,
                          prefill_time=prefill_time,
                          depth_per_req=depth_per_req,
                          verify_extra_per_req=verify_extra_per_req)

    def _with_straggler_mitigation(self, cost, per_ssm_batch):
        """Inject random stragglers; mitigation re-dispatches the straggling
        micro-batch to the fastest live SSM (bounded delay)."""
        jitter = np.random.default_rng(len(self.slot_log)).exponential(
            1.0, len(self.ssms))
        slow = jitter > self.ecfg.straggler_factor
        if not slow.any():
            return cost
        per_tok = list(cost.ssm_time_per_token)
        fastest = float(min(t for j, t in enumerate(per_tok)
                            if j not in self.failed_ssms))
        for j in range(len(per_tok)):
            if slow[j] and per_ssm_batch[j] > 0:
                self.straggler_redispatches += 1
                per_tok[j] = fastest * 1.5
        return dataclasses.replace(cost, ssm_time_per_token=per_tok)

    # ------------------------------------------------------------- runs --
    def run(self, max_slots: int = 1000) -> dict:
        for _ in range(max_slots):
            rec = self.step()
            if rec.get("done") and not self.scheduler.outstanding:
                break
        return self.stats()

    def stats(self) -> dict:
        lat = [r.latency for r in self.requests.values()
               if r.latency is not None]
        ttft = [r.first_token_time - r.arrival
                for r in self.requests.values()
                if r.first_token_time is not None]
        summ = slo_summary(self.requests.values())
        return {
            "slo_aware": self.slo_aware,
            "slo": {**summ.asdict(),
                    "goodput_under_slo":
                        summ.goodput_under_slo(self.sim_time)},
            "kv_layout": "paged",
            "kv_blocks": self.llm_pool.num_blocks,
            "prefill_chunk": (self.ecfg.prefill_chunk if self.chunked
                              else 0),
            "spec_shape": "tree" if self.tree else "linear",
            "fused_kernels": "on" if self.fused else "off",
            "kv_dtype": self.kv_dtype,
            "spec_branches": self.branches,
            "verify_tokens": self.verify_tokens_total,
            "tree_forks": self.tree_forks,
            "tree_adoptions": self.tree_adoptions,
            "gamma": self.gamma_ctl.stats,
            "accepted_tokens": self.accepted_tokens,
            "prefill_tokens": self.prefill_tokens_total,
            "sim_time": self.sim_time,
            "wall_time": self.wall_time,
            "goodput_sim": self.accepted_tokens / max(self.sim_time, 1e-9),
            "ttft_p50": float(np.percentile(ttft, 50)) if ttft else 0.0,
            "ttft_p95": float(np.percentile(ttft, 95)) if ttft else 0.0,
            "drafted": self.total_drafted,
            "switch": self.switcher.stats,
            "scheduler": self.scheduler.stats,
            "mean_latency": float(np.mean(lat)) if lat else 0.0,
            "p95_latency": float(np.percentile(lat, 95)) if lat else 0.0,
            "straggler_redispatches": self.straggler_redispatches,
            "mean_accept": float(np.mean([
                np.mean(v) for v in self._accept_by_req.values()]))
            if self._accept_by_req else 0.0,
        }
