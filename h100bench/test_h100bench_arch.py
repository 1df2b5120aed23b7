"""A model of another block kind added as files and entries only: an MoE
LLM (``extend/arch/tiny_moe.py``, its reference
``extend/reference/tiny_moe.py``) with a dense drafter, a configuration
that names them by its models' ``"arch"`` and ``"reference"``, and its
cells, in a copy of the benchmark.  At tiny size on the CPU the cell reads
``correct``; with the arch's top-k one below the reference's it does not."""

import json
import shutil
from pathlib import Path

import pytest

from h100bench import harness, tiny
from h100bench.test_h100bench_imports import FORBIDDEN, top_level_imports

EXT = Path(__file__).resolve().parent / "extend"
SLOTS = 40             # the window, in engine slots
TOP_K = 'm["num_experts_per_tok"]'


def moe_config(name, arch):
    cfg = tiny.tiny_config()
    llm = dict(tiny.model("tiny-moe-llm", 2, 64, 4, 2, 32, 500, False, False),
               arch=arch, reference="tiny_moe", num_experts=4,
               num_experts_per_tok=2)
    return dict(cfg, name=name, llm=llm, ssms=cfg["ssms"][:1])


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny.make_root(tmp_path_factory.mktemp("bench"))
    home = root / "h100bench"
    for kind in ("arch", "reference"):
        shutil.copy(EXT / kind / "tiny_moe.py", home / kind / "tiny_moe.py")
    # the fault: the program routes each token to one expert fewer
    src = (EXT / "arch" / "tiny_moe.py").read_text()
    bad = src.replace(TOP_K, TOP_K + " - 1", 1)
    assert bad != src
    (home / "arch" / "tiny_moe_fewer.py").write_text(bad)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name, arch, cell in (("tiny-moe", "tiny_moe", "tiny.moe"),
                             ("tiny-moe-fewer", "tiny_moe_fewer",
                              "tiny.moe-fewer")):
        (home / "configs" / f"{name}.json").write_text(
            json.dumps(moe_config(name, arch)))
        bench["configs"].append({"name": name, "source": "tiny",
                                 "file": f"h100bench/configs/{name}.json",
                                 "reduced": [], "why": "CPU test"})
        bench["workloads"].append({"name": cell, "config": name,
                                   "traffic": "tiny.closed", "chips": 1,
                                   "why": "CPU test"})
        for m in bench["per_layer"]:
            if "tiny.closed" in m["workloads"]:
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run(root, cell, trace=False, seed=2**31 + 5):
    r = harness.run_cell(cell, seed, 1.0, trace, root=root, device="cpu",
                         slots=SLOTS)
    return r, json.loads(harness.result_line(r))


def test_moe_cell_is_correct(root):
    _, line = run(root, "tiny.moe")
    assert line["correct"] and line["attempted"] > 0, line["checks"]
    bench = json.loads((root / "BENCHMARK.json").read_text())
    assert set(line["metrics"]) == {m["name"] for m in bench["end_to_end"]
                                    if m["source"] == "host_clock"}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["checks"]) == {"llm_gap", "draft_gap"}


def test_moe_cell_traced(root):
    r, line = run(root, "tiny.moe", trace=True, seed=9)
    assert line["correct"], line["checks"]
    assert r["record"]["flops"] > 0 and line["metrics"]["mfu"]["value"] > 0


def test_fewer_experts_than_the_reference_is_caught(root):
    _, line = run(root, "tiny.moe-fewer")
    assert not line["correct"]
    assert line["checks"]["llm_gap"]["value"] > 1e-3, line["checks"]


def test_moe_layout_is_the_ports(root):
    from repro_torch.models import transformer as T
    spec = harness.load_cell("tiny.moe", root)
    m = spec["config"]["llm"]
    arch = harness.model_module(spec, m, "arch")
    params = T.abstract_params(arch.port_config(m, "float32"))
    want = [(("layers", j, k), tuple(v.shape))
            for j, layer in enumerate(params["layers"])
            for k, v in layer.items()]
    want += [((k,), tuple(v.shape)) for k, v in params.items()
             if k != "layers"]
    got = [(p, tuple(s)) for p, s, _ in arch.layout(m, spec["config"]["init"])]
    assert sorted(got) == sorted(want)
    assert "router" in params["layers"][0]


def test_moe_flops_count_the_top_k_experts(root):
    spec = harness.load_cell("tiny.moe", root)
    m = spec["config"]["llm"]
    arch = harness.model_module(spec, m, "arch")
    d, H, Kh, hd, ff, E, k, V, L = 64, 4, 2, 16, 32, 4, 2, 500, 2
    per_layer = (d * (H + 2 * Kh) * hd + H * hd * d      # projections
                 + d * E + k * 3 * d * ff)                # router, experts
    # 3 tokens after 5 cached: 6 + 7 + 8 (query, key) pairs
    assert arch.flops(m, 5, 3) == (2 * 3 * (L * per_layer + d * V)
                                   + 4 * H * hd * 21 * L)


def test_moe_reference_imports_nothing_of_the_program():
    names = top_level_imports(EXT / "reference" / "tiny_moe.py")
    assert not names & (FORBIDDEN | {"repro_torch", "h100bench"}), names
