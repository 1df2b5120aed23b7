"""Serving workloads mirroring the paper's three datasets.

Alpaca / ChatGPT-Prompts (CP) / Chatbot-Instruction-Prompts (CIP) differ in
request difficulty and prompt-length distributions (paper §II-B / §VI-A):
Alpaca is the hardest (large SSMs win), CP the easiest (small SSMs win),
CIP in between; Mix combines all three.  We reproduce those *distributions*
synthetically with an explicit per-request difficulty knob that controls
how predictable the continuation is (see data/pipeline.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np

from repro_torch.data.pipeline import _backbone, synthetic_sequence


@dataclasses.dataclass
class Dataset:
    name: str
    difficulty_mean: float
    difficulty_std: float
    prompt_len_range: tuple
    output_len_range: tuple


DATASETS: Dict[str, Dataset] = {
    # hardest: long, information-dense instructions (hard mode)
    "alpaca": Dataset("alpaca", 0.85, 0.05, (24, 96), (24, 96)),
    # easiest: short, repetitive chat prompts (easy mode)
    "cp": Dataset("cp", 0.05, 0.03, (8, 32), (16, 48)),
    # intermediate: mix of modes
    "cip": Dataset("cip", 0.45, 0.35, (16, 64), (16, 64)),
}


@dataclasses.dataclass(frozen=True)
class SLO:
    """Per-request latency contract (SpecServe/AdaSpec-style serving).

    ``ttft_deadline`` is the seconds-from-arrival budget for the FIRST
    output token; every subsequent token is due ``tpot_target`` seconds
    after the previous one's deadline, so token ``j`` (0-indexed) of a
    request is due at ``arrival + ttft_deadline + j * tpot_target`` on
    the sim clock.  Frozen on purpose: the contract is immutable once a
    request enters the system — schedulers read it, nothing rewrites it.
    """
    ttft_deadline: float       # seconds from arrival to first token
    tpot_target: float         # seconds per subsequent token

    def __post_init__(self):
        if self.ttft_deadline <= 0 or self.tpot_target <= 0:
            raise ValueError("SLO deadlines must be positive "
                             f"(got {self!r})")

    def token_deadline(self, arrival: float, j: int) -> float:
        """Absolute sim-clock deadline of output token ``j`` (0-indexed)."""
        return arrival + self.ttft_deadline + j * self.tpot_target


# Per-class SLO profiles: a profile maps each dataset class to the
# contract its traffic buys.  Values are sim-clock seconds sized for the
# reduced CPU zoo (single-engine service runs at roughly 300 tok/s with
# TTFTs in the tens of milliseconds — see results/BENCH_baseline.json);
# ``assign_slos(scale=)`` rescales everything for other regimes.
# "interactive" marks chat-shaped traffic (cp) strict and batch-shaped
# traffic (alpaca) lax — the mixed strict/lax workload the SLO benchmarks
# serve; "strict"/"lax" apply one contract uniformly.
SLO_PROFILES: Dict[str, Dict[str, SLO]] = {
    "strict": {
        "alpaca": SLO(ttft_deadline=0.050, tpot_target=0.006),
        "cp": SLO(ttft_deadline=0.050, tpot_target=0.006),
        "cip": SLO(ttft_deadline=0.050, tpot_target=0.006),
    },
    "lax": {
        "alpaca": SLO(ttft_deadline=1.0, tpot_target=0.060),
        "cp": SLO(ttft_deadline=1.0, tpot_target=0.060),
        "cip": SLO(ttft_deadline=1.0, tpot_target=0.060),
    },
    "interactive": {
        "alpaca": SLO(ttft_deadline=1.0, tpot_target=0.060),
        "cp": SLO(ttft_deadline=0.050, tpot_target=0.006),
        "cip": SLO(ttft_deadline=0.150, tpot_target=0.015),
    },
}


def assign_slos(reqs: List["Request"], profile: str, *,
                scale: float = 1.0) -> List["Request"]:
    """Stamp per-class SLO contracts onto requests, in place.

    ``profile`` is a key of :data:`SLO_PROFILES` or ``"off"`` (stamp
    nothing — every request keeps ``slo=None`` and the serving stack is
    bit-identical to deadline-blind operation).  ``scale`` multiplies
    every deadline, so one profile serves differently-calibrated cost
    models."""
    if profile == "off":
        return reqs
    try:
        classes = SLO_PROFILES[profile]
    except KeyError:
        raise ValueError(
            f"unknown SLO profile {profile!r} (expected 'off' or one of "
            f"{'/'.join(sorted(SLO_PROFILES))})") from None
    if scale <= 0:
        raise ValueError("SLO scale must be positive")
    for r in reqs:
        base = classes[r.dataset]
        r.slo = SLO(ttft_deadline=base.ttft_deadline * scale,
                    tpot_target=base.tpot_target * scale)
    return reqs


@dataclasses.dataclass
class Request:
    rid: int
    dataset: str
    difficulty: float
    prompt: np.ndarray          # (P,) int32
    max_new: int
    arrival: float = 0.0        # sim-clock arrival timestamp (serving)
    # scheduling class: lower value = more urgent (nice-level semantics).
    # The default 0 everywhere reproduces plain FIFO-by-arrival exactly.
    priority: int = 0
    # latency contract (None = no deadline: the scheduler, gamma
    # controller and router treat the request exactly as before SLOs
    # existed — the `--slo-profile off` bit-identity contract)
    slo: Optional[SLO] = None
    # runtime state
    emitted: Optional[List[int]] = None
    done: bool = False
    preemptions: int = 0
    finish_time: Optional[float] = None
    # chunked prefill: context tokens already ingested into the KV pool
    # (reset to 0 on preemption — partial prefill is discarded with the
    # freed blocks)
    prefill_pos: int = 0
    # sim-clock time the first output token was committed (TTFT source)
    first_token_time: Optional[float] = None
    # sim-clock commit time of every emitted token (parallel to
    # ``emitted``), the deadline-attainment source: token j met its SLO
    # iff token_times[j] <= slo.token_deadline(arrival, j)
    token_times: Optional[List[float]] = None

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def latency(self) -> Optional[float]:
        """End-to-end latency (arrival -> finish) on the sim clock."""
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival

    def next_deadline(self) -> float:
        """Absolute sim-clock deadline of the NEXT token this request
        owes (its TTFT deadline until the first token commits, then the
        running TPOT schedule); +inf without an SLO, so deadline-sorted
        orderings degrade to the deadline-free ranking exactly."""
        if self.slo is None:
            return math.inf
        return self.slo.token_deadline(self.arrival, len(self.emitted or []))


def poisson_arrivals(n: int, rate: float, seed: int = 0,
                     start: float = 0.0) -> np.ndarray:
    """Arrival timestamps of a Poisson process with ``rate`` requests/sec
    (exponential inter-arrival gaps), the standard open-loop serving
    workload model."""
    if rate <= 0:
        raise ValueError("arrival rate must be positive")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, n)
    return start + np.cumsum(gaps)


def _thinned_arrivals(n: int, rate_fn, rate_max: float, seed: int,
                      start: float) -> np.ndarray:
    """First ``n`` arrivals of an inhomogeneous Poisson process with
    instantaneous rate ``rate_fn(t) <= rate_max``, by Lewis-Shedler
    thinning: draw candidate arrivals at the constant envelope rate
    ``rate_max``, keep each with probability ``rate_fn(t) / rate_max``.
    Exact (not binned), and deterministic from the seed."""
    if rate_max <= 0:
        raise ValueError("peak arrival rate must be positive")
    rng = np.random.default_rng(seed)
    out = np.empty(n, np.float64)
    t, k = float(start), 0
    while k < n:
        t += rng.exponential(1.0 / rate_max)
        if rng.random() * rate_max <= rate_fn(t):
            out[k] = t
            k += 1
    return out


def diurnal_arrivals(n: int, *, rate_base: float, rate_peak: float,
                     period: float, seed: int = 0,
                     start: float = 0.0) -> np.ndarray:
    """Arrival timestamps under a sinusoidal day/night load curve: the
    instantaneous rate swings between ``rate_base`` (trough) and
    ``rate_peak`` (peak) with the given period, starting at the trough —
    the canonical autoscaling workload (a static fleet sized for the
    peak idles through every trough; an elastic one follows the curve).
    """
    if not 0 < rate_base <= rate_peak:
        raise ValueError("need 0 < rate_base <= rate_peak")
    if period <= 0:
        raise ValueError("period must be positive")
    mid = 0.5 * (rate_base + rate_peak)
    amp = 0.5 * (rate_peak - rate_base)

    def rate(t):
        # -cos: t=0 is the trough, t=period/2 the peak
        return mid - amp * math.cos(2.0 * math.pi * (t - start) / period)

    return _thinned_arrivals(n, rate, rate_peak, seed, start)


def bursty_arrivals(n: int, *, rate_base: float, rate_peak: float,
                    burst_every: float, burst_len: float, seed: int = 0,
                    start: float = 0.0) -> np.ndarray:
    """Arrival timestamps under a square-wave load: quiet ``rate_base``
    traffic with a ``rate_peak`` burst of length ``burst_len`` every
    ``burst_every`` seconds (the first burst starts one full quiet gap
    in).  Stresses scale-up latency and work stealing: a burst lands on
    whatever fleet the trough left behind."""
    if not 0 < rate_base <= rate_peak:
        raise ValueError("need 0 < rate_base <= rate_peak")
    if burst_every <= 0 or not 0 < burst_len <= burst_every:
        raise ValueError("need 0 < burst_len <= burst_every")

    def rate(t):
        phase = (t - start) % burst_every
        return rate_peak if phase >= burst_every - burst_len else rate_base

    return _thinned_arrivals(n, rate, rate_peak, seed, start)


def assign_arrivals(reqs: List[Request], *, rate: Optional[float] = None,
                    trace: Optional[np.ndarray] = None,
                    seed: int = 0) -> List[Request]:
    """Stamp arrival timestamps onto requests, in place.

    Exactly one of ``rate`` (Poisson process) or ``trace`` (explicit
    timestamps, e.g. replayed from a production log) must be given.
    ``trace`` shorter than the workload raises; extra entries are ignored.
    """
    if (rate is None) == (trace is None):
        raise ValueError("pass exactly one of rate= or trace=")
    if trace is None:
        times = poisson_arrivals(len(reqs), rate, seed)
    else:
        times = np.asarray(trace, np.float64)
        if len(times) < len(reqs):
            raise ValueError(
                f"trace has {len(times)} timestamps for {len(reqs)} requests")
    for r, t in zip(reqs, times):
        r.arrival = float(t)
    return reqs


def make_workload(name: str, n_requests: int, vocab: int, seed: int = 0,
                  scale: float = 1.0,
                  arrival_rate: Optional[float] = None,
                  arrival_trace: Optional[np.ndarray] = None,
                  slo_profile: str = "off",
                  slo_scale: float = 1.0) -> List[Request]:
    """name in {alpaca, cp, cip, mix}.  ``scale`` shrinks lengths for CPU
    tests.  ``arrival_rate`` (Poisson, req/s) or ``arrival_trace``
    (explicit timestamps) stamp streaming arrival times for the
    continuous-batching scheduler; default is everything-at-t=0.
    ``slo_profile`` stamps per-class latency contracts (see
    :func:`assign_slos`); the default ``"off"`` stamps none."""
    rng = np.random.default_rng(seed)
    table = _backbone(np.random.default_rng(seed ^ 0x5EED), vocab)
    if name == "mix":
        names = rng.choice(list(DATASETS), size=n_requests)
    else:
        names = [name] * n_requests
    out = []
    for i, ds_name in enumerate(names):
        ds = DATASETS[str(ds_name)]
        diff = float(np.clip(
            rng.normal(ds.difficulty_mean, ds.difficulty_std), 0.0, 0.9))
        plen = int(max(4, rng.integers(*ds.prompt_len_range) * scale))
        olen = int(max(4, rng.integers(*ds.output_len_range) * scale))
        prompt = synthetic_sequence(rng, plen, vocab, table, diff)
        out.append(Request(rid=i, dataset=str(ds_name), difficulty=diff,
                           prompt=prompt.astype(np.int32), max_new=olen,
                           emitted=[]))
    if arrival_rate is not None or arrival_trace is not None:
        assign_arrivals(out, rate=arrival_rate, trace=arrival_trace,
                        seed=seed ^ 0xA55)
    assign_slos(out, slo_profile, scale=slo_scale)
    return out
