"""One side of a same-call A/B of the PyTorch port on an NVIDIA card.

Serving mode: the full-width zoo of ``chip_smoke.py`` (LLaMA-7B +
LLaMA-68M/265M/616M, random bf16 weights, seeds 0-3), workload ``mix`` (6
requests, scale 0.3, capacity 6, gamma 4), first on the paged layout with
the fused kernels, then on the dense layout; one untimed pass and three
timed runs each (host clock around a run ending in a synchronize).
Prints one line ``AB {json}`` with the wall ms per slot.

    python3 tools/torch_ab_paths.py <checkout root> <label> [paged,dense]

The optional third argument picks the layouts (default both).

Kernel mode: saved inputs, timed with the kernels of the tree at <root>.

    python3 tools/torch_ab_paths.py <root> prepare <inputs.pt> [parts]
    python3 tools/torch_ab_paths.py <root> <label> kernels <inputs.pt>

``prepare`` (run it with the tree that has ``chip_smoke.py``) saves
``chip_smoke``'s inputs of the parts named (comma-separated; default
``flash,dense,paged,decode``): ``flash`` layer 0's q/k/v of LLaMA-7B (S
2048) and of mixtral-8x22b (S 6144, window 4096) for ``flash_attention``;
``dense`` the largest ``verify_attention`` call of the dense LLaMA-7B
serving path and every check shape of ``verify_attention``; ``paged`` the
largest ``fused_paged_decode`` call of the paged LLaMA-7B serving path and
its largest verify call, for ``fused_paged_verify`` and for
``paged_verify_attention`` (the ops path's input), the largest
``fused_paged_verify`` call of the dbrx-132b paged path (2 layers, G 6),
and every check shape of ``fused_paged_decode``, ``fused_paged_verify``
and ``paged_verify_attention``; ``decode`` the ops path's inputs of
``decode_attention`` (the dense LLaMA-7B serving path's last-layer K/V
grid) and of ``paged_decode_attention`` (the first query of the paged
serving path's largest ``fused_paged_decode`` call), and every check shape
of both.  The check shapes come from ``chip_smoke.kernel_check_cases``.
``kernels`` builds the kernels those inputs need and times each on them
with the tree at <root>: the median of 15 individually timed calls, the L2
cache flushed before each, with the device held busy while the host
enqueues them (``chip_smoke.Timer``'s method), and each output's largest
difference from the plain version; it also reports each source's ptxas
registers and spill bytes per entry.
Prints ``ABK {json}``.

Compare two trees in one call, in turns: unpack the other tree (e.g.
``git archive``) into an ignored directory and run parent, change,
change, parent, one process each, with the labels ``parent`` and
``change``, their ``ABK`` lines appended to one file; then

    python3 tools/torch_ab_paths.py <root> compare <that file>

prints the change's time over the parent's for each case and whether
each source's ptxas registers and spills moved.  Uses only entry points
both trees share.
"""
import dataclasses
import json
import statistics
import sys
import time

root, label = sys.argv[1], sys.argv[2]
mode = sys.argv[3] if len(sys.argv) > 3 else "paged,dense"
sys.path.insert(0, root + "/src")

import torch  # noqa: E402

from repro_torch.core import spec_decode as sd  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

if not sd.__file__.startswith(root):
    sys.exit(f"imported {sd.__file__}, not the tree under {root}")


# kernel name -> (module, source under csrc/)
KERNEL_MODULES = {
    "flash_attention": ("flash_attention", "flash_attention"),
    "fused_paged_verify": ("fused_verify", "fused_verify"),
    "decode_attention": ("decode_attention", "decode_attention"),
    "verify_attention": ("verify_attention", "verify_attention"),
    "fused_paged_decode": ("fused_decode", "fused_decode"),
    "paged_verify_attention": ("paged_attention", "paged_attention"),
    "paged_decode_attention": ("paged_attention", "paged_attention"),
}


def prepare(path, parts):
    """Save {case: {"kernel": name, "args": inputs}} for ``kernels``."""
    sys.path.insert(0, root)
    import chip_smoke as cs
    from repro_torch.configs import registry
    from repro_torch.kernels import ops

    saved = {}
    checks = {"dense": ("verify_attention",),
              "paged": ("fused_paged_decode", "fused_paged_verify",
                        "paged_verify_attention"),
              "decode": ("decode_attention", "paged_decode_attention")}
    wanted = {n for p in parts for n in checks.get(p, ())}
    gen = torch.Generator().manual_seed(11)
    for name, label, a in cs.kernel_check_cases(gen):
        if name in wanted:
            saved[f"{name} check {label}"] = dict(kernel=name, args=a)
    if {"dense", "flash", "paged", "decode"} & set(parts):
        llm, ssms = cs.full_zoo("bfloat16")
        if "dense" in parts or "decode" in parts:
            verify, grid = cs.dense_inputs(llm, ssms)
            if "dense" in parts:
                saved["verify_attention"] = dict(kernel="verify_attention",
                                                 args=verify)
            if "decode" in parts:
                saved["decode_attention ops path"] = dict(
                    kernel="decode_attention", args=grid)
        if "paged" in parts or "decode" in parts:
            with cs.Tap(ops, "fused_paged_verify") as tv, \
                    cs.Tap(ops, "fused_paged_decode") as td:
                cs.serve(llm, ssms, 6, 0.3, capacity=6)
        if "paged" in parts:
            saved["fused_paged_decode paged path"] = dict(
                kernel="fused_paged_decode", args=td.best)
            saved["fused_paged_verify paged path"] = dict(
                kernel="fused_paged_verify", args=tv.best)
            saved["paged_verify_attention ops path"] = dict(
                kernel="paged_verify_attention", args=tv.best)
        if "decode" in parts:
            saved["paged_decode_attention ops path"] = dict(
                kernel="paged_decode_attention",
                args=cs.ops_paged_decode_input(td.best))
        if "flash" in parts:
            qkv = cs.layer0_qkv(llm, 2048, seed=7)
            saved["flash llama-7b"] = dict(kernel="flash_attention",
                                           args=qkv)
        del llm, ssms
        torch.cuda.empty_cache()
    if "flash" in parts:
        llm, _ = cs.full_zoo("bfloat16", cs.MIXTRAL_LAYERS,
                             llm_cfg=registry.get("mixtral-8x22b"))
        saved["flash mixtral-8x22b"] = dict(kernel="flash_attention",
                                            args=cs.layer0_qkv(llm, 6144,
                                                               seed=7))
        del llm
        torch.cuda.empty_cache()
    if "paged" in parts:
        llm, ssms = cs.full_zoo("bfloat16", cs.DBRX_LAYERS,
                                llm_cfg=registry.get("dbrx-132b"))
        with cs.Tap(ops, "fused_paged_verify") as tv:
            cs.serve(llm, ssms, 6, 0.3, capacity=6)
        saved["fused_paged_verify dbrx path"] = dict(
            kernel="fused_paged_verify", args=tv.best)
        del llm, ssms
        torch.cuda.empty_cache()
    for v in saved.values():
        v["args"].pop("model", None)
    torch.save(saved, path)
    print(f"saved {len(saved)} inputs to {path}", flush=True)


def timed(fn, reps=15, spin_cycles=300_000_000):
    """Median device ms of ``reps`` calls, each with the L2 flushed first;
    the device spins while the host enqueues, so no event pair spans host
    time."""
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        spun = torch.cuda.Event()
        torch.cuda._sleep(spin_cycles)
        spun.record()
        for s, e in ev:
            flush.zero_()
            s.record()
            fn()
            e.record()
        host_ahead = not spun.query()
        torch.cuda.synchronize()
        if host_ahead:
            return statistics.median(s.elapsed_time(e) for s, e in ev)
        spin_cycles *= 4
    raise RuntimeError("the host could not enqueue ahead of the device")


def kernels(path):
    import importlib

    saved = torch.load(path)
    names = sorted({v["kernel"] for v in saved.values()})
    sources = sorted({KERNEL_MODULES[n][1] for n in names})
    logs = build.build_all(sources)
    out = {"label": label, "card": torch.cuda.get_device_name(0),
           "ptxas": {n: [[e["entry"], e["registers"], e["spill_bytes"]]
                         for e in build.ptxas_entries(logs[n]["ptxas"])]
                     for n in sources}}
    for case, v in saved.items():
        mod = importlib.import_module("repro_torch.kernels."
                                      + KERNEL_MODULES[v["kernel"]][0])
        kern = getattr(mod, v["kernel"])
        plain = getattr(mod, v["kernel"] + "_plain")
        a = v["args"]
        err = (kern(**a).float() - plain(**a).float()).abs().max().item()
        out[case] = dict(ms=timed(lambda: kern(**a)), max_abs_err=err,
                         shape=list(a["q"].shape))
    print("ABK " + json.dumps(out), flush=True)


def serving(paths):
    from repro_torch.configs import spin_llama
    from repro_torch.data.workloads import make_workload
    from repro_torch.launch.serve import make_selector
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import EngineConfig, SpinEngine

    build.build_all()

    def bundle(cfg, seed):
        cfg = dataclasses.replace(cfg, dtype="bfloat16")
        return sd.Bundle(cfg, T.init_params(cfg, seed, device="cuda"))

    llm = bundle(spin_llama.LLAMA_7B, 0)
    ssms = [bundle(c, i + 1) for i, c in enumerate(spin_llama.SSM_ZOO[:3])]

    def serve(**kw):
        """Serve the workload to the end; (wall ms per slot, slots)."""
        reqs = make_workload("mix", 6, 32000, seed=0, scale=0.3)
        sel = make_selector("lbss", 3, 6,
                            {r.rid: r.prompt_len for r in reqs}, 0,
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


def compare(path):
    """Change over parent for each case of the ``ABK`` lines in ``path``
    (the last four, run as parent, change, change, parent): the mean of
    the change's two times over the mean of the parent's; and whether each
    source's ptxas registers and spills agree entry by entry (each side's
    first run builds)."""
    runs = [json.loads(ln[4:]) for ln in open(path)
            if ln.startswith("ABK ")][-4:]
    if [r["label"] for r in runs] != ["parent", "change", "change",
                                      "parent"]:
        sys.exit(f"{path}: want the labels parent, change, change, parent")
    for case in runs[0]:
        if case in ("label", "card", "ptxas"):
            continue
        ms = [r[case]["ms"] for r in runs]
        ratio = (ms[1] + ms[2]) / (ms[0] + ms[3])
        print(f"{ratio:.3f} {case}: parent {ms[0]:.4f}/{ms[3]:.4f} change "
              f"{ms[1]:.4f}/{ms[2]:.4f} err {runs[1][case]['max_abs_err']:.3g}")
    for src, old in runs[0].get("ptxas", {}).items():
        new = runs[1].get("ptxas", {}).get(src, [])
        same = [e[1:] for e in old] == [e[1:] for e in new]
        print(f"ptxas {src}: {len(old)} / {len(new)} entries, "
              + ("registers and spills equal" if same else "CHANGED"))
        if not same:
            print(f"  parent {old}\n  change {new}")


if label == "prepare":
    prepare(mode, (sys.argv[4] if len(sys.argv) > 4
                   else "flash,dense,paged,decode").split(","))
elif label == "compare":
    compare(mode)
elif mode == "kernels":
    kernels(sys.argv[4])
else:
    serving(mode.split(","))
