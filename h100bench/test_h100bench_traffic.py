"""The traffic generator: the same seed gives the same stream, every seed
the same multiset of sizes, and lengths stay in their stated ranges."""

import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from h100bench import traffic as TR

HOME = Path(__file__).resolve().parent
MIXES = sorted((HOME / "traffic").glob("*.json"))


def load(path):
    return json.loads(path.read_text())


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_same_seed_same_stream(path):
    t = load(path)
    a, b = TR.Stream(t, 1000, 2**31 + 5), TR.Stream(t, 1000, 2**31 + 5)
    for _ in range(20):
        x, y = a.next(), b.next()
        assert (x.cls, x.max_new, x.difficulty) == (y.cls, y.max_new,
                                                    y.difficulty)
        assert np.array_equal(x.prompt, y.prompt)


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_sizes_in_range_and_equal_across_seeds(path):
    t = load(path)
    ranges = {c["name"]: c for c in t["classes"]}
    per_seed = []
    for seed in (1, 2**31 + 7):
        s = TR.Stream(t, 1000, seed)
        items = [s.next() for _ in range(t["period"])]
        for it in items:
            c = ranges[it.cls]
            assert c["prompt"][0] <= len(it.prompt) <= c["prompt"][1]
            assert c["output"][0] <= it.max_new <= c["output"][1]
            assert it.prompt.dtype == np.int32
            assert (it.prompt[1:] >= 3).all() and (it.prompt < 1000).all()
        per_seed.append(Counter((it.cls, len(it.prompt), it.max_new)
                                for it in items))
    assert per_seed[0] == per_seed[1]
    shares = Counter(it[0] for it in per_seed[0].elements())
    total = sum(c["share"] for c in t["classes"])
    for c in t["classes"]:
        assert abs(shares[c["name"]] - t["period"] * c["share"] / total) <= 1


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_mix_is_the_papers(path):
    """The mix files hold the port's DATASETS, ranges made inclusive."""
    t = load(path)
    for c in t["classes"]:
        mean, std, (p0, p1), (o0, o1) = TR.DATASETS[c["name"]]
        assert c["difficulty"] == [mean, std]
        assert c["prompt"] == [p0, p1 - 1] and c["output"] == [o0, o1 - 1]
    assert TR.longest_request(t, 4) <= t["engine"]["max_len"]
    assert t["loop"]["clients"] == t["engine"]["capacity"]


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_first_wave_residual_lengths(path):
    t = load(path)
    n = t["loop"]["clients"]
    wave = TR.first_wave(t, TR.Stream(t, 1000, 9), 9)
    assert len(wave) == n
    res = sorted(it.max_new for it in wave)
    assert res == sorted(TR.residual_lengths(t, n))
    top = max(c["output"][1] for c in t["classes"])
    assert 1 <= res[0] and res[-1] <= top
    # residual life is shorter on average than a whole request
    whole = np.mean([o for _, _, o in TR.period_sizes(t)])
    assert np.mean(res) < whole


def test_residual_distribution_by_hand():
    t = {"period": 2, "classes": [{"name": "a", "share": 1, "prompt": [4, 4],
                                   "output": [1, 2], "difficulty": [0, 0]}]}
    # output lengths {1, 2}: P(r=1) = 2/3, P(r=2) = 1/3
    assert list(TR.residual_lengths(t, 3)) == [1, 1, 2]


def test_length_laws():
    u = TR._quantiles(4, 10, 13, "uniform")
    assert list(u) == [10, 11, 12, 13]
    lg = TR._quantiles(1000, 1024, 4096, "loguniform")
    assert lg.min() >= 1024 and lg.max() <= 4096
    assert np.median(lg) < (1024 + 4096) / 2


def test_open_loop_arrivals():
    t = {"loop": {"kind": "open", "process": "poisson", "rate": 5.0}}
    a = TR.arrival_offsets(t, 500, 3)
    assert np.array_equal(a, TR.arrival_offsets(t, 500, 3))
    assert (np.diff(a) > 0).all()
    assert abs(500 / a[-1] - 5.0) < 1.0
    t = {"loop": {"kind": "open", "process": "bursty", "rate": 20.0,
                  "rate_base": 2.0, "burst_every_s": 10.0,
                  "burst_len_s": 2.0}}
    b = TR.arrival_offsets(t, 300, 3)
    assert (np.diff(b) >= 0).all()
