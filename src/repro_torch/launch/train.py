"""Fault-tolerant training launcher (PyTorch port).

    python -m repro_torch.launch.train --arch qwen2-0.5b --steps 200 \
        [--device cuda] [--reduced] [--ckpt-dir DIR] [--resume auto] \
        [--simulate-failures]

Trains ``--arch`` (the registry's config, or with ``--reduced`` a tiny
same-family one) on the synthetic ``TokenStream`` with AdamW and a cosine
schedule, on ``--device`` (default ``cuda``; ``cpu`` for a run without a
card).  The flags and the loop are the reference launcher's:

* a checkpoint every ``--ckpt-every`` steps (async, atomic, versioned);
* ``--resume auto`` restores the latest checkpoint, and the retry loop
  around :func:`run` gives crash-restart semantics;
* the data stream is indexed by step, so a restart replays it exactly;
* ``--simulate-failures`` injects one crash at ``--fail-at`` to show the
  recovery.

``--dtype`` sets the parameters' dtype (default: the config's, bf16 for
the registry's models).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import registry
from repro_torch.data.pipeline import TokenStream
from repro_torch.models import transformer as T
from repro_torch.models.config import TORCH_DTYPES, reduced
from repro_torch.optim import AdamW, cosine_schedule


class SimulatedFailure(RuntimeError):
    pass


def run(args) -> dict:
    device = T.resolve_device(args.device)
    cfg = registry.get(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    stream = TokenStream(seed=args.seed, batch=args.batch,
                         seq_len=args.seq_len, vocab=cfg.vocab_size)
    optimizer = AdamW(lr=cosine_schedule(args.lr, args.warmup, args.steps))
    step_fn = T.make_train_step(cfg, optimizer, T.Opts(remat=args.remat))
    mgr = CheckpointManager(args.ckpt_dir, keep=3) if args.ckpt_dir else None

    params = T.init_params(cfg, args.seed, device=device)
    opt_state = optimizer.init(params)
    start = 0
    if mgr and args.resume == "auto" and mgr.latest_step() is not None:
        (params, opt_state), start = mgr.restore((params, opt_state))
        start += 1
        print(f"[train] resumed from step {start - 1}")

    losses = []
    t0 = time.time()
    try:
        for step in range(start, args.steps):
            toks, labels = stream.batch_at(step)
            batch = {"tokens": torch.as_tensor(toks, device=device),
                     "labels": torch.as_tensor(labels, device=device)}
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            losses.append(float(metrics["loss"]))
            if mgr and (step + 1) % args.ckpt_every == 0:
                mgr.save(step, (params, opt_state), blocking=False)
            if args.simulate_failures and step == args.fail_at:
                raise SimulatedFailure(f"injected failure at step {step}")
            if step % 20 == 0:
                print(f"[train] step {step} loss {losses[-1]:.4f} "
                      f"({(time.time() - t0):.1f}s)", flush=True)
    except SimulatedFailure:
        # the in-process restart must not race this run's async writer
        # (a crashed process's writer dies with it)
        if mgr:
            mgr.wait()
        raise
    if mgr:
        mgr.save(args.steps - 1, (params, opt_state), blocking=True)
        mgr.wait()
    return {"final_loss": losses[-1] if losses else float("nan"),
            "losses": losses, "resumed_from": start}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda by default)")
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config")
    ap.add_argument("--dtype", default=None, choices=sorted(TORCH_DTYPES),
                    help="parameter and compute dtype (default: the "
                         "config's)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--remat", default="none", choices=list(T.REMAT))
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default="auto", choices=["auto", "none"])
    ap.add_argument("--simulate-failures", action="store_true")
    ap.add_argument("--fail-at", type=int, default=30)
    ap.add_argument("--max-restarts", type=int, default=3)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    # crash-restart loop (the in-process analogue of a cluster restarter)
    for attempt in range(args.max_restarts + 1):
        try:
            out = run(args)
            print(f"[train] done: final loss {out['final_loss']:.4f} "
                  f"(resumed_from={out['resumed_from']})")
            return out
        except SimulatedFailure as e:
            print(f"[train] FAILURE: {e}; restarting "
                  f"({attempt + 1}/{args.max_restarts})")
            args.simulate_failures = False   # crash once, then recover
    raise RuntimeError("exceeded max restarts")


if __name__ == "__main__":
    main()
