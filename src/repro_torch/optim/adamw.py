"""AdamW and learning-rate schedules.

Moments are kept in float32 whatever the parameters' dtype; weight decay
is decoupled; clipping by the global gradient norm (float32, over every
leaf) is part of the update.  Parameters and moments are updated in place.
Which leaves are decayed is the caller's choice (``decay``); the training
step passes the reference's rule (``models.transformer.decay_mask``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.models.params import map_tensors, tensor_leaves


class AdamWState(NamedTuple):
    step: torch.Tensor       # int32 scalar on the host
    mu: dict
    nu: dict


def linear_warmup(peak_lr: float, warmup: int) -> Callable:
    def fn(step):
        return peak_lr * min(1.0, (step + 1) / max(warmup, 1))
    return fn


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> Callable:
    def fn(step):
        warm = (step + 1) / max(warmup, 1)
        frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * frac))
        return peak_lr * min(warm, cos)
    return fn


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params) -> AdamWState:
        def f32(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return AdamWState(step=torch.zeros((), dtype=torch.int32),
                          mu=map_tensors(f32, params),
                          nu=map_tensors(f32, params))

    @torch.no_grad()
    def update(self, params, grads, state: AdamWState,
               decay: Optional[dict] = None):
        """One step over trees of one structure.  ``decay`` (a tree of
        bools) says which leaves take weight decay; None decays the leaves
        of rank >= 2.  Returns (params, state), both updated in place."""
        step = int(state.step) + 1
        lr = self.lr(step) if callable(self.lr) else self.lr
        if self.clip_norm:
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                   for g in tensor_leaves(grads)))
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
        else:
            scale = 1.0
        b1, b2 = self.b1, self.b2
        c1, c2 = 1 - b1 ** step, 1 - b2 ** step
        if decay is None:
            decay = map_tensors(lambda p: p.dim() >= 2, params)

        def upd(p, g, m, v, dec):
            g = g.float() * scale
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            delta = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            if dec and self.weight_decay:
                delta = delta + self.weight_decay * p.float()
            p.copy_((p.float() - lr * delta).to(p.dtype))

        map_tensors(upd, params, grads, state.mu, state.nu, decay)
        return params, AdamWState(
            step=torch.tensor(step, dtype=torch.int32), mu=state.mu,
            nu=state.nu)
