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


def tensor_leaves(tree):
    """The tensors of a dict/list/tuple tree, in its iteration order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensor_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensor_leaves(v)]
    return [tree]


def map_tensors(fn, tree, *rest):
    """``fn`` over the leaves of trees of one structure (dicts, lists,
    tuples and named tuples), leaf by leaf."""
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [map_tensors(fn, *xs) for xs in zip(tree, *rest)]
        return (type(tree)(*out) if hasattr(tree, "_fields")
                else type(tree)(out))
    return fn(tree, *rest)


def count(spec) -> int:
    return sum(math.prod(p.shape) for p in leaves(spec))


def from_jax_numpy(tree, cfg, device, dtype=None):
    """The reference's parameter tree, as numpy arrays
    (``jax.tree.map(np.asarray, params)``), as the port's parameters.

    The reference stacks unit position ``i`` of kind ``kind`` along a
    leading unit axis under ``tree["scan"][f"u{i}_{kind}"]`` and keeps the
    trailing blocks as ``tree[f"tail{i}_{kind}"]``; the port keeps one
    block dict per application under ``"layers"``, in application order
    (unit 0's blocks, unit 1's, ..., then the tail).  ``embed``,
    ``lm_head``, ``final_norm`` and ``shared_attn`` pass through where the
    tree has them.  Arrays pass through float32 (numpy has no bfloat16)
    and land in ``dtype`` (default: the config's compute dtype).
    """
    dtype = dtype or cfg.compute_dtype

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device,
                            dtype=dtype)

    def block(leaves, unit=None):
        return {name: t(a if unit is None else a[unit])
                for name, a in leaves.items()}

    out = {k: t(tree[k]) for k in ("embed", "lm_head", "final_norm")
           if k in tree}
    if "shared_attn" in tree:
        out["shared_attn"] = block(tree["shared_attn"])
    out["layers"] = [
        block(tree["scan"][f"u{i}_{kind}"], unit)
        for unit in range(cfg.n_units) for i, kind in enumerate(cfg.unit)
    ] + [block(tree[f"tail{i}_{kind}"]) for i, kind in enumerate(cfg.tail)]
    return out


def reference_key(key: str, cfg):
    """The reference tree's path of the port leaf at ``key`` (a "/"-joined
    path such as ``layers/5/wq`` or ``1/mu/layers/5/wq``), and the index
    along the reference's leading unit axis (None outside ``scan``): the
    mapping of :func:`from_jax_numpy`, layer ``n`` of the body being unit
    ``n // len(unit)``'s block ``n % len(unit)``."""
    parts = key.split("/")
    if "layers" not in parts:
        return key, None
    i = parts.index("layers")
    n, width = int(parts[i + 1]), len(cfg.unit)
    if n < cfg.n_units * width:
        name, unit = ["scan", f"u{n % width}_{cfg.unit[n % width]}"], \
            n // width
    else:
        j = n - cfg.n_units * width
        name, unit = [f"tail{j}_{cfg.tail[j]}"], None
    return "/".join(parts[:i] + name + parts[i + 2:]), unit
