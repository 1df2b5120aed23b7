"""One side of a same-call A/B of the PyTorch port's LLaMA-7B serving
paths on an NVIDIA card: the full-width zoo of ``chip_smoke.py`` (LLaMA-7B
+ LLaMA-68M/265M/616M, random bf16 weights, seeds 0-3), workload ``mix``
(6 requests, scale 0.3, capacity 6, gamma 4), first on the paged layout
with the fused kernels, then on the dense layout; one untimed pass and
three timed runs each (host clock around a run ending in a synchronize).
Prints one line ``AB {json}`` with the wall ms per slot.

    python3 tools/torch_ab_paths.py <checkout root> <label> [paged,dense]

The optional third argument picks the layouts (default both).

Compare two trees in one call, in turns: unpack the other tree (e.g.
``git archive``) into an ignored directory and run parent, change,
change, parent, one process each.  Uses only entry points both trees
share.
"""
import dataclasses
import json
import statistics
import sys
import time

root, label = sys.argv[1], sys.argv[2]
paths = sys.argv[3].split(",") if len(sys.argv) > 3 else ["paged", "dense"]
sys.path.insert(0, root + "/src")

import torch  # noqa: E402

from repro_torch.configs import spin_llama  # noqa: E402
from repro_torch.core import spec_decode as sd  # noqa: E402
from repro_torch.data.workloads import make_workload  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch.serve import make_selector  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving.engine import EngineConfig, SpinEngine  # noqa: E402

if not sd.__file__.startswith(root):
    sys.exit(f"imported {sd.__file__}, not the tree under {root}")
build.build_all()


def bundle(cfg, seed):
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    return sd.Bundle(cfg, T.init_params(cfg, seed, device="cuda"))


llm = bundle(spin_llama.LLAMA_7B, 0)
ssms = [bundle(c, i + 1) for i, c in enumerate(spin_llama.SSM_ZOO[:3])]


def serve(**kw):
    """Serve the workload to the end; (wall ms per slot, slots)."""
    reqs = make_workload("mix", 6, 32000, seed=0, scale=0.3)
    sel = make_selector("lbss", 3, 6, {r.rid: r.prompt_len for r in reqs}, 0,
                        group_of={r.rid: r.dataset for r in reqs})
    eng = SpinEngine(llm, ssms, sel,
                     EngineConfig(gamma=4, capacity=6, max_len=256, **kw))
    eng.add_requests(reqs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(max_slots=400)
    torch.cuda.synchronize()
    slots = len(eng.slot_log)
    return (time.perf_counter() - t0) * 1e3 / slots, slots


out = {"label": label}
for name, kw in (("paged", dict(fused_kernels="on")),
                 ("dense", dict(kv_layout="dense"))):
    if name not in paths:
        continue
    serve(**kw)
    runs = [serve(**kw) for _ in range(3)]
    out[name] = dict(ms_per_slot=[r[0] for r in runs],
                     slots=[r[1] for r in runs],
                     median=statistics.median(r[0] for r in runs))
print("AB " + json.dumps(out), flush=True)
