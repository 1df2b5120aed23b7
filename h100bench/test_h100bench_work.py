"""The yardstick's counts against hand counts, one call each."""

import importlib
import json
from pathlib import Path

import pytest
import torch

from h100bench import work
from h100bench.arch import decoder

HOME = Path(__file__).resolve().parent


def meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_verify_work_by_hand():
    # 2 segments: row 0 owns blocks 3, 5; row 1 owns block 7; one pad entry
    a = {"q": meta(6, 4, 8), "k_pool": meta(10, 4, 2, 8),
         "block_ids": torch.tensor([3, 5, 7, 0]),
         "block_owner": torch.tensor([0, 0, 1, -1]),
         "q_seg": torch.tensor([0, 0, 0, 1, 1, -1])}
    nbytes, ops = work.verify_work(a)
    slot = 2 * 8 * 2 * 2 + 8                  # K and V in bf16, seg, pos
    assert nbytes == 3 * 4 * slot + 4 * 8 + 6 * 4 * 2 + 2 * 6 * 4 * 8 * 2
    # row-0 queries see 8 slots, row-1 queries 4; 4 D ops per head
    assert ops == 4 * 8 * 4 * (3 * 8 + 2 * 4)


def test_decode_work_by_hand():
    a = {"q": meta(2, 3, 4, 8), "k_pool": meta(10, 4, 2, 8),
         "block_tables": torch.tensor([[1, 2], [4, -1]])}
    nbytes, ops = work.decode_work(a)
    slot = 2 * 8 * 2 * 2 + 8
    assert nbytes == 3 * 4 * slot + 4 * 4 + 2 * 3 * 8 + 2 * 2 * 3 * 4 * 8 * 2
    assert ops == 4 * 8 * 4 * 3 * (3 * 4)


def test_bound_by_hand():
    ms, which = work.bound(3.35e9, 1.0, torch.bfloat16)
    assert ms == pytest.approx(1.0) and which == "bytes"
    ms, which = work.bound(1.0, 989e9, torch.bfloat16)
    assert ms == pytest.approx(1.0) and which == "operations"


def test_model_flops_by_hand():
    m = json.loads((HOME / "configs" / "qwen2.5-14b-spin.json")
                   .read_text())["llm"]
    d, ff, V, L = 5120, 13824, 152064, 48
    per_layer = d * 40 * 128 + 2 * d * 8 * 128 + 40 * 128 * d + 3 * d * ff
    assert decoder.dense_flops_per_token(m) == 2 * (L * per_layer + d * V)
    # 14.8e9 parameters less the input embedding's 0.8e9: 28.0 GFLOP
    assert 27.5e9 < decoder.dense_flops_per_token(m) < 28.5e9
    # 3 tokens after 5 cached: 6 + 7 + 8 pairs
    assert decoder.causal_pairs(5, 3) == 21
    assert decoder.flops(m, 5, 3) == (
        3 * decoder.dense_flops_per_token(m) + 4 * 40 * 128 * 21 * L)


# ``work.forward_flops`` of each real model at commit
# b1f1c693e5168e125e74172c7ed8bebc8a8c2b01, at (start, n) = (0, 1),
# (5, 3) and (200, 640)
PARENT_FLOPS = {
    ("internlm2-20b-spin", 0): [38585106432, 115776552960, 25086677483520],
    ("internlm2-20b-spin", 1): [3399155712, 10201006080, 2240827883520],
    ("qwen2.5-14b-spin", 0): [27982233600, 83964395520, 18235470643200],
    ("qwen2.5-14b-spin", 1): [988237824, 2966261760, 661070807040],
}


@pytest.mark.parametrize("name,i", sorted(PARENT_FLOPS))
def test_model_flops_are_the_parents(name, i):
    cfg = json.loads((HOME / "configs" / f"{name}.json").read_text())
    m = ([cfg["llm"]] + cfg["ssms"])[i]
    arch = importlib.import_module("h100bench.arch."
                                   + m.get("arch", "decoder"))
    assert [arch.flops(m, s, n) for s, n in ((0, 1), (5, 3), (200, 640))
            ] == PARENT_FLOPS[name, i]


def test_device_time_union_and_gaps():
    spans = [(0.0, 10.0, "a"), (5.0, 15.0, "b"), (20.0, 30.0, "a")]
    busy, per = work.device_time(spans)
    assert busy == pytest.approx(25.0 / 1e3)
    assert per["a"] == (pytest.approx(20.0 / 1e3), 2)
    assert work.idle_gaps(spans, 0.0, 40.0) == [(15.0, 20.0), (30.0, 40.0)]
