"""SPIN serving launcher (PyTorch port).

    python -m repro_torch.launch.serve --dataset mix --requests 16 \
        --selector lbss --gamma 4 --fused-kernels on [--device cuda] \
        [--no-packed] [--no-pipeline] [--arrival-rate 200] \
        [--kv-budget 512] [--scheduler continuous] [--block-size 16] \
        [--kv-layout paged|dense]

Builds the heterogeneous SSM zoo + LLM (reduced LLaMA configs, random
weights from ``--seed``) on ``--device`` (default ``cuda``; ``cpu`` runs
the plain PyTorch versions of the kernels), then drives one engine replica
until the request stream drains and prints its stats as JSON.  The flags
and defaults are the reference launcher's.  ``--kv-layout dense`` serves
from (capacity, max_len) grids, its packed verify through the
``verify_attention`` kernel; ``--spec-shape tree``, ``--kv-dtype
int8/fp8`` and ``--fused-kernels on`` fall back with a warning there, as
in the reference.  The multi-replica router flags (``--replicas > 1``,
``--router-policy``, ``--autoscale``, ``--steal``, ``--replica-classes``)
raise until the router is ported (ROADMAP Queue 1).
"""

from __future__ import annotations

import argparse
import json

from repro_torch.configs import spin_llama
from repro_torch.core import decompose as D
from repro_torch.core import spec_decode as sd
from repro_torch.core.selector import (LBSS, EpsilonGreedy,
                                       GreedyPromptLength, SelectorConfig)
from repro_torch.data.workloads import (bursty_arrivals, diurnal_arrivals,
                                        make_workload)
from repro_torch.models import transformer as T
from repro_torch.models.config import reduced
from repro_torch.serving.engine import EngineConfig, SpinEngine

_ROUTER = "waits for the router port (ROADMAP Queue 1, router)"


def build_zoo(vocab: int, seed: int = 0, n_ssms: int = 3, device="cuda"):
    """Reduced-scale LLM + heterogeneous SSM zoo (shape-faithful families
    of the paper's LLaMA 68M..1.4B lineup), random weights from ``seed``
    (LLM) and ``i + 1`` (SSM i)."""
    cfg_llm = reduced(spin_llama.LLAMA_7B, d_model=96, n_heads=4,
                      n_kv_heads=4, vocab_size=vocab, n_layers=4)
    llm = sd.Bundle(cfg_llm, T.init_params(cfg_llm, seed, device=device))
    dims = [(32, 1), (48, 2), (64, 2), (96, 3), (96, 4)][:n_ssms]
    ssms = []
    for i, (d, L) in enumerate(dims):
        c = reduced(spin_llama.SSM_ZOO[min(i, 4)], d_model=d, n_heads=4,
                    n_kv_heads=4, vocab_size=vocab, n_layers=L)
        ssms.append(sd.Bundle(c, T.init_params(c, i + 1, device=device)))
    return llm, ssms


def make_selector(kind: str, n_ssms: int, cap: int, prompt_lens=None,
                  seed: int = 0, group_of=None):
    scfg = SelectorConfig(n_ssms=n_ssms, batch_limits=[cap] * n_ssms,
                          alpha=6, beta=2, seed=seed)
    if kind == "lbss":
        return LBSS(scfg, group_of=group_of)
    if kind == "eps":
        return EpsilonGreedy(scfg, eps=0.2)
    if kind == "greedy":
        return GreedyPromptLength(scfg, prompt_lens or {})
    raise ValueError(kind)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device the models, pools and kernels run "
                         "on (cuda by default; cpu runs the kernels' plain "
                         "PyTorch versions)")
    ap.add_argument("--dataset", default="mix",
                    choices=["alpaca", "cp", "cip", "mix"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--selector", default="lbss",
                    choices=["lbss", "eps", "greedy"])
    ap.add_argument("--n-ssms", type=int, default=3)
    ap.add_argument("--gamma", type=int, default=4,
                    help="speculation depth (fixed policy) or the "
                         "cold-start default (adaptive)")
    ap.add_argument("--gamma-policy", default="fixed",
                    choices=["fixed", "adaptive"])
    ap.add_argument("--gamma-max", type=int, default=None,
                    help="adaptive speculation-depth cap; default "
                         "2 * --gamma")
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--no-packed", action="store_true")
    ap.add_argument("--no-pipeline", action="store_true")
    ap.add_argument("--max-slots", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=float, default=0.3)
    ap.add_argument("--arrival-rate", type=float, default=None,
                    help="Poisson arrival rate (req/s, sim clock); "
                         "default: all requests arrive at t=0")
    ap.add_argument("--capacity", type=int, default=None,
                    help="LLM pool rows (default: --requests)")
    ap.add_argument("--kv-budget", type=int, default=None,
                    help="total KV cells before preemption (rounded down "
                         "to whole blocks, enforced as the block pool)")
    ap.add_argument("--scheduler", default="continuous",
                    choices=["continuous", "static"])
    ap.add_argument("--kv-layout", default="paged",
                    choices=["paged", "dense"])
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="max prompt tokens ingested per request per slot; "
                         "0 = monolithic prefill-on-admit")
    ap.add_argument("--token-budget", type=int, default=None)
    ap.add_argument("--spec-shape", default="linear",
                    choices=["linear", "tree"])
    ap.add_argument("--spec-branch", type=int, default=2,
                    help="tree-speculation branching factor; gamma_max + "
                         "branches must fit the ancestor-mask node budget "
                         f"({D.max_tree_nodes()} nodes)")
    ap.add_argument("--fused-kernels", default="off", choices=["on", "off"],
                    help="on: every paged attention site goes through the "
                         "fused CUDA kernels (kernels/fused_verify.py, "
                         "fused_decode.py); off: gather + plain attention")
    ap.add_argument("--kv-dtype", default="bf16",
                    choices=["bf16", "int8", "fp8"])
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--router-policy", default=None,
                    choices=["lot", "p2c", "slo"])
    ap.add_argument("--slo-profile", default="off",
                    choices=["off", "strict", "lax", "interactive"])
    ap.add_argument("--slo-scale", type=float, default=1.0)
    ap.add_argument("--arrival-pattern", default="poisson",
                    choices=["poisson", "diurnal", "bursty"])
    ap.add_argument("--autoscale", default="off",
                    choices=["off", "target-occupancy"])
    ap.add_argument("--replicas-min", type=int, default=1)
    ap.add_argument("--replicas-max", type=int, default=None)
    ap.add_argument("--steal", default="auto", choices=["auto", "on", "off"])
    ap.add_argument("--replica-classes", default="")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if (args.replicas != 1 or args.router_policy is not None
            or args.autoscale != "off" or args.steal == "on"
            or args.replica_classes or args.replicas_max is not None):
        ap.error(f"the multi-replica router {_ROUTER}")
    try:
        ecfg = EngineConfig.from_args(args)
    except ValueError as e:
        ap.error(str(e))
    if args.arrival_rate is not None and args.arrival_rate <= 0:
        ap.error("--arrival-rate must be positive (omit it for "
                 "all-at-t=0 arrivals)")
    if args.capacity is not None and args.capacity <= 0:
        ap.error("--capacity must be positive")
    if args.slo_scale <= 0:
        ap.error("--slo-scale must be positive")

    arrival_rate, arrival_trace = args.arrival_rate, None
    if args.arrival_pattern != "poisson":
        if args.arrival_rate is None:
            ap.error("--arrival-pattern diurnal/bursty needs "
                     "--arrival-rate (the peak rate)")
        span = args.requests / args.arrival_rate
        if args.arrival_pattern == "diurnal":
            arrival_trace = diurnal_arrivals(
                args.requests, rate_base=args.arrival_rate / 5.0,
                rate_peak=args.arrival_rate, period=2.0 * span,
                seed=args.seed ^ 0xD1A)
        else:
            arrival_trace = bursty_arrivals(
                args.requests, rate_base=args.arrival_rate / 5.0,
                rate_peak=args.arrival_rate, burst_every=span,
                burst_len=span / 4.0, seed=args.seed ^ 0xB5B)
        arrival_rate = None

    llm, ssms = build_zoo(args.vocab, args.seed, args.n_ssms, args.device)
    reqs = make_workload(args.dataset, args.requests, args.vocab,
                         seed=args.seed, scale=args.scale,
                         arrival_rate=arrival_rate,
                         arrival_trace=arrival_trace,
                         slo_profile=args.slo_profile,
                         slo_scale=args.slo_scale)
    sel = make_selector(args.selector, len(ssms), ecfg.capacity,
                        {r.rid: r.prompt_len for r in reqs}, args.seed,
                        group_of={r.rid: r.dataset for r in reqs})
    try:
        eng = SpinEngine(llm, ssms, sel, ecfg)
    except ValueError as e:
        ap.error(str(e))
    eng.add_requests(reqs)
    stats = eng.run(max_slots=args.max_slots)
    print(json.dumps(stats, indent=2, default=str))
    return stats


if __name__ == "__main__":
    main()
