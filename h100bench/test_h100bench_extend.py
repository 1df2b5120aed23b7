"""A configuration, traffic files (one an open loop), cells and a metric
reader added to a copy of the benchmark as files and entries only run at
tiny size on the CPU, and give the contract's result line."""

import json

import pytest

from h100bench import harness, tiny

SLOTS = 40             # the window, in engine slots

READER = '''"""queued_per_slot: mean queued requests per window slot."""


def read(rec):
    q = [s["queued"] for s in rec["slots"]]
    return sum(q) / len(q) if q else None
'''


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny.make_root(tmp_path_factory.mktemp("bench"))
    (root / "h100bench" / "metrics" / "queued_per_slot.py").write_text(READER)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "queued_per_slot", "unit": "requests", "better": "lower",
        "source": "program_counter", "layer": "scheduler",
        "moves": "ttft_p90_ms", "workloads": ["tiny.open"]})
    # a second configuration of the same models under LBSS, and its cell
    (root / "h100bench" / "configs" / "tiny-lbss.json").write_text(
        json.dumps(dict(tiny.tiny_config(selector="lbss"), name="tiny-lbss")))
    bench["configs"].append({"name": "tiny-lbss", "source": "tiny",
                             "file": "h100bench/configs/tiny-lbss.json",
                             "reduced": [], "why": "CPU test"})
    bench["workloads"].append({"name": "tiny.lbss", "config": "tiny-lbss",
                               "traffic": "tiny.closed", "chips": 1,
                               "why": "CPU test"})
    for m in bench["per_layer"]:
        if "tiny.closed" in m["workloads"]:
            m["workloads"].append("tiny.lbss")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_closed_loop_cell(root):
    r = harness.run_cell("tiny.closed", 2**31 + 3, 1.0, False, root=root,
                         device="cpu", slots=SLOTS)
    line = json.loads(harness.result_line(r))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] and line["attempted"] > 0
    bench = json.loads((root / "BENCHMARK.json").read_text())
    # the device's readings need the card; the host's read on the CPU
    assert set(line["metrics"]) == {m["name"] for m in bench["end_to_end"]
                                    if m["source"] == "host_clock"}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert line["device"]["count"] == 1
    assert set(line["checks"]) == {"llm_gap", "draft_gap"}


def test_open_loop_cell_traced_with_new_metric(root):
    r = harness.run_cell("tiny.open", 5, 1.0, True, root=root, device="cpu",
                         slots=SLOTS)
    line = json.loads(harness.result_line(r))
    assert line["correct"]
    got = set(line["metrics"])
    # the device's readings need the card; the rest read on the CPU
    assert {"queued_per_slot", "rows_per_slot", "slot_ms", "mfu",
            "draft_ms_per_slot", "verify_ms_per_slot",
            "tokens_per_row_slot", "prefill_ms_per_request"} <= got
    assert not got & {"fused_paged_verify_roofline", "device_idle_share"}
    assert "breakdown" in line and list(line)[-1] == "checks"
    rec = r["record"]
    assert rec["late_s"]
    # spans are timed in the span slots after the window, not in it
    assert rec["span_slots"] == 4 and 0 < rec["spans"]["verify"][1] <= 4


def test_lbss_cell(root):
    r = harness.run_cell("tiny.lbss", 17, 1.0, True, root=root, device="cpu",
                         slots=SLOTS)
    assert r["correct"] and r["metrics"]["mfu"]["value"] > 0
    assert r["metrics"]["prefill_ms_per_request"]["value"] > 0


def test_cells_see_only_their_metrics(root):
    spec = harness.load_cell("tiny.closed", root)
    assert "queued_per_slot" not in {m["name"] for m in spec["per_layer"]}
    assert harness.load_cell("tiny.open", root)["traffic"]["loop"][
        "kind"] == "open"
