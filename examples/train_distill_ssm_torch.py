"""Train the LLM and the heterogeneous SSM zoo (PyTorch port).

    PYTHONPATH=src python examples/train_distill_ssm_torch.py \
        [--steps 250] [--force] [--device cuda]

The five SSMs (a capacity ladder of shape-faithful reductions of LLaMA
68M..1.4B) and the LLM are trained on the two-scale synthetic corpus, so
that acceptance depends on SSM capacity x request difficulty: a small SSM
does well on easy requests, a large one wins the hard ones (the paper's
Fig. 2/3).  The trained zoo is cached under ``results/zoo_torch/``
(``CheckpointManager``) and restored on the next run; ``--force``
retrains.  Runs on the card by default; ``--device cpu`` runs without one.

:func:`build_zoo` returns the zoo as ``spec_decode.Bundle`` s, which
``repro_torch.launch.serve.main(argv, zoo=...)`` serves
(``examples/serve_spin_torch.py --zoo``).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional, Tuple

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import spin_llama
from repro_torch.core import spec_decode as sd
from repro_torch.data.pipeline import TokenStream
from repro_torch.models import transformer as T
from repro_torch.models.config import reduced
from repro_torch.optim import AdamW, cosine_schedule

VOCAB = 128
ZOO_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "results", "zoo_torch")

# (template config, d_model, n_layers): the capacity ladder of LLaMA-68M ..
# LLaMA-1.4B
SSM_SPECS = [
    (spin_llama.LLAMA_68M, 16, 1),
    (spin_llama.LLAMA_265M, 32, 1),
    (spin_llama.LLAMA_616M, 48, 2),
    (spin_llama.LLAMA_1_1B, 64, 2),
    (spin_llama.LLAMA_1_4B, 96, 3),
]
LLM_SPEC = (spin_llama.LLAMA_7B, 128, 3)
SSM_NAMES = ["68m", "265m", "616m", "1.1b", "1.4b"]


def _cfg(base, d, L):
    return reduced(base, d_model=d, n_layers=L, n_heads=4, n_kv_heads=4,
                   vocab_size=VOCAB, head_dim=d // 4)


def recipe(cfg, steps: int, lr: Optional[float] = None):
    """The capacity-scaled recipe: (learning rate, steps).  Bigger models
    take more steps and a gentler rate."""
    n = cfg.params_count()
    if lr is None:
        lr = 1e-2 if n < 3e5 else 5e-3
    return lr, int(steps * (1.0 + min(1.0, n / 1.5e6)))


def train(cfg, steps: int, seed: int, lr: Optional[float] = None,
          device="cuda", params=None, max_steps: Optional[int] = None,
          log=print) -> Tuple[dict, List[float]]:
    """Train ``cfg`` by :func:`recipe` from ``params`` (default: the
    initializer at ``seed``); ``max_steps`` stops early, the schedule
    unchanged.  Returns (params, the loss of every step taken)."""
    device = T.resolve_device(device)
    lr, steps = recipe(cfg, steps, lr)
    stream = TokenStream(seed=11, batch=16, seq_len=64, vocab=VOCAB)
    opt = AdamW(lr=cosine_schedule(lr, 30, steps), weight_decay=0.01)
    if params is None:
        params = T.init_params(cfg, seed, device=device)
    state = opt.init(params)
    step_fn = T.make_train_step(cfg, opt, T.Opts(remat="none"))
    losses = []
    for s in range(steps if max_steps is None else min(steps, max_steps)):
        toks, labels = stream.batch_at(s)
        batch = {"tokens": torch.as_tensor(toks, device=device),
                 "labels": torch.as_tensor(labels, device=device)}
        params, state, metrics = step_fn(params, state, batch)
        losses.append(float(metrics["loss"]))
    log(f"  trained {cfg.name}: {cfg.n_layers}L x {cfg.d_model}d "
        f"{len(losses)} steps, final loss {losses[-1]:.3f}")
    return params, losses


def zoo_configs():
    """(the LLM's config, the SSMs' configs, smallest first)."""
    return _cfg(*LLM_SPEC), [_cfg(*s) for s in SSM_SPECS]


def build_zoo(steps: int = 250, force: bool = False, device="cuda",
              zoo_dir: str = ZOO_DIR, log=print, record=None
              ) -> Tuple[sd.Bundle, List[sd.Bundle]]:
    """(llm, [ssm_smallest .. ssm_largest]), trained and cached in
    ``zoo_dir`` (restored from there unless ``force``).  ``record``, a
    dict, receives each trained model's steps, final loss and seconds."""
    device = T.resolve_device(device)
    llm_cfg, ssm_cfgs = zoo_configs()
    mgr = CheckpointManager(zoo_dir, keep=1)
    if not force and mgr.latest_step() is not None:
        template = {"llm": T.init_params(llm_cfg, 0, device=device),
                    **{f"ssm{i}": T.init_params(c, 0, device=device)
                       for i, c in enumerate(ssm_cfgs)}}
        try:
            trees, _ = mgr.restore(template)
            log("[zoo] restored cached models")
            return (sd.Bundle(llm_cfg, trees["llm"]),
                    [sd.Bundle(c, trees[f"ssm{i}"])
                     for i, c in enumerate(ssm_cfgs)])
        except (KeyError, ValueError, RuntimeError) as e:
            log(f"[zoo] cache miss ({e}); retraining")
    t0 = time.time()
    log("[zoo] training LLM + 5 heterogeneous SSMs on the synthetic "
        "corpus ...")
    trees = {}
    for key, cfg, n, seed in [("llm", llm_cfg, int(steps * 1.5), 0)] + [
            (f"ssm{i}", c, steps, i + 1) for i, c in enumerate(ssm_cfgs)]:
        t = time.time()
        trees[key], losses = train(cfg, n, seed, device=device, log=log)
        if device.type == "cuda":
            torch.cuda.synchronize()
        if record is not None:
            record[key] = dict(name=cfg.name, steps=len(losses),
                               final_loss=losses[-1],
                               seconds=time.time() - t)
    mgr.save(0, trees)
    log(f"[zoo] done in {time.time() - t0:.0f}s")
    return (sd.Bundle(llm_cfg, trees["llm"]),
            [sd.Bundle(c, trees[f"ssm{i}"]) for i, c in enumerate(ssm_cfgs)])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--force", action="store_true", help="retrain")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    llm, ssms = build_zoo(steps=args.steps, force=args.force,
                          device=args.device)
    print(f"\nLLM: {llm.cfg.n_layers}L x {llm.cfg.d_model}d "
          f"({llm.cfg.params_count() / 1e3:.0f}k params)")
    for n, s in zip(SSM_NAMES, ssms):
        print(f"SSM[{n}]: {s.cfg.n_layers}L x {s.cfg.d_model}d "
              f"({s.cfg.params_count() / 1e3:.0f}k params)")
    return llm, ssms


if __name__ == "__main__":
    main()
