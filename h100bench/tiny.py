"""A copy of the benchmark with a tiny cell added, for the CPU tests.

:func:`make_root` copies ``BENCHMARK.json`` and the benchmark's folder
into a new directory and adds, as files and entries only, a tiny
configuration of each shape the real ones have (QKV bias and untied
head in the LLM, tied and untied SSMs), a tiny closed-loop and a tiny
open-loop traffic file, their cells, and the per-layer metrics' cells.
``harness.run_cell(..., root=<copy>, device="cpu")`` then runs them here
in seconds, on the kernels' plain versions.
"""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def model(name, L, d, H, Kh, ff, V, bias, tie):
    return {"name": name, "source": "tiny", "num_hidden_layers": L,
            "hidden_size": d, "num_attention_heads": H,
            "num_key_value_heads": Kh, "intermediate_size": ff,
            "vocab_size": V, "qkv_bias": bias, "tie_word_embeddings": tie,
            "rope_theta": 1000000.0, "rms_norm_eps": 1e-6}


def tiny_config(dtype="float32", limit=1e-3, selector="greedy"):
    return {
        "name": "tiny-spin", "source": "tiny", "reference": "decoder",
        "llm": model("tiny-llm", 2, 64, 4, 2, 128, 500, True, False),
        "ssms": [model("tiny-ssm-a", 1, 32, 2, 1, 64, 500, True, True),
                 model("tiny-ssm-b", 2, 48, 4, 4, 96, 500, False, False)],
        "serving": {"dtype": dtype, "kv_layout": "paged", "kv_dtype": "bf16",
                    "block_size": 8, "fused_kernels": "on", "gamma": 3,
                    "gamma_policy": "fixed", "selector": selector,
                    "use_packed_verify": True, "use_pipeline": True},
        "init": {"embed": 0.02, "norm": 0.05, "bias": 0.1},
        "check": {"sample_requests": 3, "sample_drafts": 4,
                  "llm_gap": limit, "draft_gap": limit},
        "assumed": [], "reduced": []}


def tiny_traffic(kind="closed"):
    t = {"classes": [
            {"name": "a", "share": 2, "prompt": [6, 14], "output": [3, 9],
             "difficulty": [0.8, 0.05]},
            {"name": "b", "share": 1, "prompt": [4, 9], "output": [2, 6],
             "difficulty": [0.1, 0.05]}],
         "length_law": "uniform", "period": 12,
         "engine": {"capacity": 4, "max_len": 48, "prefill_chunk": 0},
         "warmup_slots": 2, "span_slots": 4, "idle_slots": 2,
         "trace_slots": 2}
    if kind == "closed":
        t["loop"] = {"kind": "closed", "clients": 4, "think_s": 0.0}
    else:
        t["loop"] = {"kind": "open", "process": "poisson", "rate": 40.0,
                     "schedule": 2000}
        t["length_law"] = "loguniform"
    return t


def make_root(dst: Path, dtype="float32", limit=1e-3) -> Path:
    """The copy, with cells ``tiny.closed`` and ``tiny.open``."""
    dst = Path(dst)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    home = bench["paths"][0]
    shutil.copytree(ROOT / home, dst / home,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (dst / home / "configs" / "tiny-spin.json").write_text(
        json.dumps(tiny_config(dtype, limit)))
    for kind in ("closed", "open"):
        (dst / home / "traffic" / f"tiny.{kind}.json").write_text(
            json.dumps(tiny_traffic(kind)))
    bench = copy.deepcopy(bench)
    bench["configs"].append({"name": "tiny-spin", "source": "tiny",
                             "file": f"{home}/configs/tiny-spin.json",
                             "reduced": [], "why": "CPU test"})
    for kind in ("closed", "open"):
        bench["workloads"].append({"name": f"tiny.{kind}",
                                   "config": "tiny-spin",
                                   "traffic": f"tiny.{kind}", "chips": 1,
                                   "why": "CPU test"})
    for m in bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += ["tiny.closed", "tiny.open"]
    (dst / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dst
