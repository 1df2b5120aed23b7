"""The benchmark's one traffic generator, driven by a traffic file.

A traffic file (``h100bench/traffic/<mix>.json``) holds parameters only:

* ``loop``: ``{"kind": "closed", "clients": N, "think_s": t}`` or
  ``{"kind": "open", "process": "poisson" | "bursty", "rate": r, ...}``;
* ``classes``: each with ``name``, ``share``, ``prompt`` and ``output``
  (inclusive length ranges) and ``difficulty`` (mean, std);
* ``length_law``: ``uniform`` or ``loguniform``;
* ``period``: requests in one period of the stream.

Every seed gets the same multiset of sizes: each class takes its share of a
period, and its prompt and output lengths are stratified quantiles of the
length law, paired by a fixed permutation.  The seed only orders the period
and draws the token content, so two seeds do the same work in another
order.  A closed loop starts each client on a request whose output length
is drawn (stratified again) from the residual-life distribution of the
output lengths, so the clients start spread over their requests' lifetimes
as in a steady state, not all at once.

``DATASETS``, ``_backbone``, ``synthetic_sequence``, ``poisson_arrivals``,
``_thinned_arrivals`` and ``bursty_arrivals`` are frozen copies of
``src/repro_torch/data/workloads.py`` and ``src/repro_torch/data/pipeline.py``
at commit 43decebb2791135c201d6c4c7b06b63dd5d77887, so a later change of
the program cannot move the traffic.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List, Optional

import numpy as np

# ------------------------------------------------------ frozen copies --

N_CTX2 = 131
N_CTX3 = 521

# name -> (difficulty mean, std, prompt range, output range); ranges are
# half-open as ``rng.integers`` takes them
DATASETS: Dict[str, tuple] = {
    "alpaca": (0.85, 0.05, (24, 96), (24, 96)),
    "cp": (0.05, 0.03, (8, 32), (16, 48)),
    "cip": (0.45, 0.35, (16, 64), (16, 64)),
}


def _backbone(rng: np.random.Generator, vocab: int):
    t1 = rng.integers(3, vocab, size=(vocab,))
    t2 = rng.integers(3, vocab, size=(N_CTX2,))
    t3 = rng.integers(3, vocab, size=(N_CTX3,))
    return t1, t2, t3


def _h2(a: int, b: int) -> int:
    return (a * 31 + b * 7) % N_CTX2


def _h3(a: int, b: int, c: int) -> int:
    return (a * 131 + b * 31 + c * 7) % N_CTX3


def mode_of(difficulty: float) -> int:
    return 1 if difficulty < 0.33 else (2 if difficulty < 0.66 else 3)


def synthetic_sequence(rng: np.random.Generator, length: int, vocab: int,
                       tables, difficulty: float) -> np.ndarray:
    t1, t2, t3 = tables
    mode = mode_of(difficulty)
    seq = np.empty(length, np.int64)
    seq[1:3] = rng.integers(3, vocab, 2)
    seq[0] = mode
    noise = rng.random(length) < 0.02
    for t in range(3, length):
        if noise[t]:
            seq[t] = rng.integers(3, vocab)
        elif mode == 1:
            seq[t] = t1[int(seq[t - 1])]
        elif mode == 2:
            seq[t] = t2[_h2(int(seq[t - 1]), int(seq[t - 2]))]
        else:
            seq[t] = t3[_h3(int(seq[t - 1]), int(seq[t - 2]),
                            int(seq[t - 3]))]
    return seq


def poisson_arrivals(n: int, rate: float, seed: int = 0,
                     start: float = 0.0) -> np.ndarray:
    if rate <= 0:
        raise ValueError("arrival rate must be positive")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, n)
    return start + np.cumsum(gaps)


def _thinned_arrivals(n: int, rate_fn, rate_max: float, seed: int,
                      start: float) -> np.ndarray:
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


def bursty_arrivals(n: int, *, rate_base: float, rate_peak: float,
                    burst_every: float, burst_len: float, seed: int = 0,
                    start: float = 0.0) -> np.ndarray:
    if not 0 < rate_base <= rate_peak:
        raise ValueError("need 0 < rate_base <= rate_peak")
    if burst_every <= 0 or not 0 < burst_len <= burst_every:
        raise ValueError("need 0 < burst_len <= burst_every")

    def rate(t):
        phase = (t - start) % burst_every
        return rate_peak if phase >= burst_every - burst_len else rate_base

    return _thinned_arrivals(n, rate, rate_peak, seed, start)


# ----------------------------------------------------- the generator --

@dataclasses.dataclass
class Item:
    """One request as the traffic makes it; the harness wraps it in the
    program's request type."""
    index: int
    cls: str
    difficulty: float
    prompt: np.ndarray           # int32
    max_new: int


def _quantiles(n: int, lo: int, hi: int, law: str) -> np.ndarray:
    """n stratified draws of an integer length in [lo, hi]."""
    u = (np.arange(n) + 0.5) / n
    if law == "uniform":
        v = lo + np.floor(u * (hi - lo + 1))
    elif law == "loguniform":
        v = np.floor(np.exp(math.log(lo) + u * (math.log(hi + 1)
                                                - math.log(lo))))
    else:
        raise ValueError(f"unknown length law {law!r}")
    return np.clip(v, lo, hi).astype(np.int64)


def period_sizes(traffic: dict):
    """The period's (class, prompt length, output length) list, the same
    for every seed."""
    period = int(traffic["period"])
    classes = traffic["classes"]
    total = sum(c["share"] for c in classes)
    counts = [int(round(period * c["share"] / total)) for c in classes]
    counts[-1] = period - sum(counts[:-1])
    law = traffic.get("length_law", "uniform")
    pair = np.random.default_rng(0)
    out = []
    for c, n in zip(classes, counts):
        if n <= 0:
            continue
        pl = _quantiles(n, *c["prompt"], law)
        ol = _quantiles(n, *c["output"], law)[pair.permutation(n)]
        out += [(c, int(p), int(o)) for p, o in zip(pl, ol)]
    return out


def residual_lengths(traffic: dict, n: int) -> np.ndarray:
    """n stratified draws of the residual output length of a request in
    flight at a random instant: P(r = k) is proportional to the share of
    output lengths >= k."""
    lens = np.array([o for _, _, o in period_sizes(traffic)])
    top = int(lens.max())
    weight = np.array([(lens >= k).sum() for k in range(1, top + 1)],
                      np.float64)
    cdf = np.cumsum(weight) / weight.sum()
    u = (np.arange(n) + 0.5) / n
    return np.searchsorted(cdf, u) + 1


class Stream:
    """The seeded request stream of one run: period after period of the
    fixed sizes, each period in its own seeded order."""

    def __init__(self, traffic: dict, vocab: int, seed: int):
        self.traffic = traffic
        self.vocab = vocab
        self.sizes = period_sizes(traffic)
        self.rng = np.random.default_rng([seed, 0x7AF])
        self.tables = _backbone(np.random.default_rng([seed, 0x5EED]), vocab)
        self.n = 0
        self._order: List[int] = []

    def next(self, max_new: Optional[int] = None) -> Item:
        if not self._order:
            self._order = list(self.rng.permutation(len(self.sizes)))
        c, plen, olen = self.sizes[self._order.pop()]
        mean, std = c["difficulty"]
        diff = float(np.clip(self.rng.normal(mean, std), 0.0, 0.9))
        prompt = synthetic_sequence(self.rng, plen, self.vocab, self.tables,
                                    diff).astype(np.int32)
        item = Item(self.n, c["name"], diff, prompt,
                    olen if max_new is None else int(max_new))
        self.n += 1
        return item

    def __iter__(self) -> Iterator[Item]:
        while True:
            yield self.next()


def first_wave(traffic: dict, stream: Stream, seed: int) -> List[Item]:
    """A closed loop's first request per client, with residual output
    lengths in a seeded order."""
    n = int(traffic["loop"]["clients"])
    res = residual_lengths(traffic, n)
    order = np.random.default_rng([seed, 0xF1]).permutation(n)
    return [stream.next(max_new=int(res[i])) for i in order]


def arrival_offsets(traffic: dict, n: int, seed: int) -> np.ndarray:
    """An open loop's first ``n`` due times, in seconds from its start."""
    loop = traffic["loop"]
    proc = loop.get("process", "poisson")
    s = int(np.random.default_rng([seed, 0xA55]).integers(2**31))
    if proc == "poisson":
        return poisson_arrivals(n, float(loop["rate"]), s)
    if proc == "bursty":
        return bursty_arrivals(
            n, rate_base=float(loop["rate_base"]),
            rate_peak=float(loop["rate"]),
            burst_every=float(loop["burst_every_s"]),
            burst_len=float(loop["burst_len_s"]), seed=s)
    raise ValueError(f"unknown arrival process {proc!r}")


def longest_request(traffic: dict, gamma: int) -> int:
    """KV slots the longest request of the mix can need."""
    return max(p + o for _, p, o in period_sizes(traffic)) + gamma + 1
