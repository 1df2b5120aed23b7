"""Parameter spec trees.

Model code declares a nested structure (dicts and lists) of ``P`` leaf specs
(shape + logical axis names + init).  :func:`init_params` turns the spec into
tensors on a device, drawing from an explicit ``torch.Generator``;
:func:`count` sums the spec's sizes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class P:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis name per dim (None = replicated)
    init: str = "normal"  # normal | zeros | ones
    scale: Optional[float] = None  # default: 1/sqrt(fan_in)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_leaf(x) -> bool:
    return isinstance(x, P)


def tree_map(fn, tree):
    """Map ``fn`` over the ``P`` leaves of a dict/list spec tree."""
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    raise TypeError(f"unexpected spec node {type(tree)}")


def leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def init_params(spec, generator: torch.Generator, dtype, device):
    """Materialize parameter tensors from a spec tree.

    Normal leaves draw ``N(0, 1) * scale`` in float32 on ``device`` from
    ``generator`` (which must live on the same device type) and cast to
    ``dtype``; the default scale is ``1/sqrt(fan_in)`` with
    ``fan_in = shape[-2]`` for every leaf of rank >= 2, exactly as the
    reference initializer (so for ``wq (d, heads, head_dim)`` it is the
    head count)."""

    def make(p: P):
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dtype, device=device)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=dtype, device=device)
        fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
        scale = p.scale if p.scale is not None else 1.0 / math.sqrt(fan_in)
        x = torch.randn(
            p.shape, generator=generator, dtype=torch.float32, device=device
        )
        return (x * scale).to(dtype)

    return tree_map(make, spec)


def count(spec) -> int:
    return sum(math.prod(p.shape) for p in leaves(spec))


def from_jax_numpy(tree, cfg, device, dtype=None):
    """The reference's parameter tree, as numpy arrays
    (``jax.tree.map(np.asarray, params)``), as the port's parameters.

    The reference stacks the dense block's weights along a leading layer
    axis under ``tree["scan"]["u0_attn"]``; the port keeps a per-layer
    list under ``"layers"``.  Arrays pass through float32 (numpy has no
    bfloat16) and land in ``dtype`` (default: the config's compute dtype).
    """
    dtype = dtype or cfg.compute_dtype

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device,
                            dtype=dtype)

    out = {k: t(v) for k, v in tree.items() if k != "scan"}
    stacked = tree["scan"]["u0_attn"]
    out["layers"] = [
        {name: t(a[layer]) for name, a in stacked.items()}
        for layer in range(cfg.n_layers)
    ]
    return out
