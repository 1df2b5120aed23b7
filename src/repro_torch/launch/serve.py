"""SPIN serving launcher (PyTorch port).

    python -m repro_torch.launch.serve --dataset mix --requests 16 \
        --selector lbss --gamma 4 --fused-kernels on [--device cuda] \
        [--no-packed] [--no-pipeline] [--arrival-rate 200] \
        [--kv-budget 512] [--scheduler continuous] [--block-size 16] \
        [--kv-layout paged|dense] [--replicas 2 --router-policy lot]

Builds the heterogeneous SSM zoo + LLM (reduced LLaMA configs, random
weights from ``--seed``) on ``--device`` (default ``cuda``; ``cpu`` runs
the plain PyTorch versions of the kernels), then drives the engine until
the request stream drains and prints its stats as JSON.  The flags and
defaults are the reference launcher's.  ``--kv-layout dense`` serves
from (capacity, max_len) grids, its packed verify through the
``verify_attention`` kernel; ``--spec-shape tree``, ``--kv-dtype
int8/fp8`` and ``--fused-kernels on`` fall back with a warning there, as
in the reference.

``--replicas N`` serves the stream through N engine replicas behind the
router (serving/router.py): ``--capacity`` and ``--kv-budget`` are
aggregate figures split across the replicas, ``--router-policy``,
``--autoscale``, ``--steal`` and ``--replica-classes`` shape the fleet.
The replicas share the zoo's bundles and the one device; pools and
selectors are per replica.
"""

from __future__ import annotations

import argparse
import dataclasses
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
from repro_torch.serving.router import (CLASS_KV_WEIGHTS, Router,
                                        RouterConfig, class_engine_config,
                                        parse_replica_classes)


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


def split_evenly(total: int, n: int):
    """Split an aggregate resource into n near-equal shares (remainder to
    the first replicas), so ``--capacity`` and ``--kv-budget`` stay
    aggregate under ``--replicas``.  A share is zero when ``total < n``;
    the caller validates that every replica gets a usable one."""
    base, rem = divmod(int(total), n)
    return [base + (1 if i < rem else 0) for i in range(n)]


def split_weighted(total: int, weights):
    """Split an aggregate resource in proportion to integer weights
    (largest-remainder rounding, ties to the lower index): the
    heterogeneous fleet's KV split, a ``decode`` replica holding a bigger
    share than a ``prefill`` one."""
    wsum = sum(weights)
    raw = [int(total) * w / wsum for w in weights]
    shares = [int(x) for x in raw]
    rem = int(total) - sum(shares)
    order = sorted(range(len(weights)),
                   key=lambda i: (-(raw[i] - shares[i]), i))
    for i in order[:rem]:
        shares[i] += 1
    return shares


def make_engine(llm, ssms, reqs, ecfg: EngineConfig,
                selector: str = "lbss") -> SpinEngine:
    """One engine over the zoo's shared bundles, with its own pools and a
    ``selector`` sized to ``ecfg.capacity`` and seeded with ``ecfg.seed``
    (``reqs`` gives it the prompt lengths and datasets)."""
    sel = make_selector(selector, len(ssms), ecfg.capacity,
                        {r.rid: r.prompt_len for r in reqs}, ecfg.seed,
                        group_of={r.rid: r.dataset for r in reqs})
    return SpinEngine(llm, ssms, sel, ecfg)


def build_fleet(llm, ssms, reqs, base_ecfg: EngineConfig, classes,
                selector: str = "lbss"):
    """A fleet's engines, one per entry of ``classes``: ``base_ecfg``'s
    aggregate capacity split evenly and its KV budget evenly, or weighted
    by class (``CLASS_KV_WEIGHTS``) when any replica is not ``general``;
    each engine's config is its class's (``class_engine_config``)."""
    n = len(classes)
    caps = split_evenly(base_ecfg.capacity, n)
    if base_ecfg.kv_budget is None:
        kvs = [None] * n
    elif any(c != "general" for c in classes):
        kvs = split_weighted(base_ecfg.kv_budget,
                             [CLASS_KV_WEIGHTS[c] for c in classes])
    else:
        kvs = split_evenly(base_ecfg.kv_budget, n)
    return [make_engine(llm, ssms, reqs, dataclasses.replace(
        class_engine_config(base_ecfg, cls), capacity=cap, kv_budget=kv),
        selector) for cap, kv, cls in zip(caps, kvs, classes)]


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
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas behind the router "
                         "(serving/router.py); --capacity and --kv-budget "
                         "are aggregate and split across them")
    ap.add_argument("--router-policy", default=None,
                    choices=["lot", "p2c", "slo"],
                    help="dispatch policy: lot = least outstanding tokens "
                         "(default), p2c = two seeded probes on free KV, "
                         "slo = most SLO headroom; passing it routes even "
                         "one replica through the router")
    ap.add_argument("--slo-profile", default="off",
                    choices=["off", "strict", "lax", "interactive"])
    ap.add_argument("--slo-scale", type=float, default=1.0)
    ap.add_argument("--arrival-pattern", default="poisson",
                    choices=["poisson", "diurnal", "bursty"])
    ap.add_argument("--autoscale", default="off",
                    choices=["off", "target-occupancy"],
                    help="target-occupancy scales the active replicas "
                         "between --replicas-min and --replicas-max, with "
                         "drain-before-retire")
    ap.add_argument("--replicas-min", type=int, default=1)
    ap.add_argument("--replicas-max", type=int, default=None,
                    help="engines built up front for the autoscaler "
                         "(default --replicas)")
    ap.add_argument("--steal", default="auto", choices=["auto", "on", "off"],
                    help="work stealing of queued, rowless requests; auto "
                         "= on exactly when --autoscale is")
    ap.add_argument("--replica-classes", default="",
                    help="heterogeneous fleet, e.g. 'prefill:1,decode:3': "
                         "per-class engine configs and class-affine "
                         "dispatch")
    return ap


def main(argv=None, zoo=None):
    """Serve as the flags say; ``zoo`` (llm, ssms), as
    ``examples/train_distill_ssm_torch.build_zoo`` returns a trained one,
    replaces the random zoo (``--vocab`` and ``--n-ssms`` are then the
    zoo's)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        base_ecfg = EngineConfig.from_args(args)
        rcfg = RouterConfig.from_args(args)
    except ValueError as e:
        ap.error(str(e))
    if args.arrival_rate is not None and args.arrival_rate <= 0:
        ap.error("--arrival-rate must be positive (omit it for "
                 "all-at-t=0 arrivals)")
    if args.capacity is not None and args.capacity <= 0:
        ap.error("--capacity must be positive")
    if args.replicas <= 0:
        ap.error("--replicas must be positive")
    if args.slo_scale <= 0:
        ap.error("--slo-scale must be positive")

    # fleet shape: --replica-classes may set the replica count on its own
    # (--replicas 1 default), and the elastic fleet builds --replicas-max
    # engines up front (standby ones cost nothing on the provisioning
    # ledger until the autoscaler activates them)
    classes = parse_replica_classes(args.replica_classes)
    n_rep = args.replicas
    if classes:
        if args.replicas != 1 and len(classes) != args.replicas:
            ap.error(f"--replica-classes carves {len(classes)} replicas "
                     f"but --replicas says {args.replicas} — drop one "
                     "flag or make them agree")
        n_rep = len(classes)
    n_eng = args.replicas_max if args.replicas_max is not None else n_rep
    if n_eng < n_rep:
        ap.error(f"--replicas-max {n_eng} is below the fleet size "
                 f"{n_rep}")
    if classes and len(classes) != n_eng:
        ap.error(f"--replica-classes carves {len(classes)} replicas but "
                 f"the pre-carved fleet is {n_eng} (--replicas-max) — "
                 "give every slot a class")
    if args.replicas_min > n_eng:
        ap.error(f"--replicas-min {args.replicas_min} exceeds the "
                 f"pre-carved fleet of {n_eng}")
    if not classes:
        classes = ["general"] * n_eng

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

    capacity = base_ecfg.capacity
    if n_eng > capacity:
        ap.error(f"a fleet of {n_eng} exceeds the aggregate --capacity "
                 f"{capacity}: every replica needs at least one pool row")
    if (n_eng > 1 and args.kv_budget is not None
            and args.kv_budget < n_eng * args.block_size):
        ap.error(f"--kv-budget {args.kv_budget} is below one "
                 f"--block-size ({args.block_size}) block per replica: "
                 "a zero-block share degenerates that replica to "
                 "one-request-at-a-time service")

    if zoo is None:
        llm, ssms = build_zoo(args.vocab, args.seed, args.n_ssms,
                              args.device)
    else:
        llm, ssms = zoo
        args.vocab, args.n_ssms = llm.cfg.vocab_size, len(ssms)
    reqs = make_workload(args.dataset, args.requests, args.vocab,
                         seed=args.seed, scale=args.scale,
                         arrival_rate=arrival_rate,
                         arrival_trace=arrival_trace,
                         slo_profile=args.slo_profile,
                         slo_scale=args.slo_scale)

    try:
        # the zoo's bundles are shared; pools and selectors are per replica
        engines = build_fleet(llm, ssms, reqs, base_ecfg, classes,
                              args.selector)
    except ValueError as e:
        ap.error(str(e))
    if n_eng > 1 or args.router_policy is not None or args.autoscale != "off":
        router = Router(engines, rcfg)
        router.submit(reqs)
        stats = router.run(max_slots=args.max_slots)
    else:
        engines[0].add_requests(reqs)
        stats = engines[0].run(max_slots=args.max_slots)
    print(json.dumps(stats, indent=2, default=str))
    return stats


if __name__ == "__main__":
    main()
