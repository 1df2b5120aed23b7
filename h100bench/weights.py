"""Random weights in the program's parameter layout, made from the seed.

The layout is the model's architecture module's (``arch/<name>.py``,
named by the model entry's ``"arch"``, ``decoder`` by default):
``layout(m, init)`` lists every leaf's path, shape and standard deviation
in buffer order.  A CPU test holds each layout to the port's parameter
spec.

Every leaf is a view of one flat buffer in the serving dtype, filled by a
few large ``torch.randn`` calls from a generator on the device and scaled
per leaf by its standard deviation.
"""

from __future__ import annotations

import math

import torch

CHUNK = 1 << 30          # elements per randn call


def model_seed(seed: int, index: int) -> int:
    """The generator seed of model ``index`` (0 the LLM, 1.. the SSMs)."""
    return (int(seed) * 1_000_003 + 7919 * index) % (2**63 - 1)


def make(leaves, seed: int, device, dtype=torch.bfloat16):
    """The parameter tree of the layout ``leaves`` ([(path, shape, std)],
    an architecture module's ``layout``), on ``device``, from ``seed``."""
    device = torch.device(device)
    total = sum(math.prod(shape) for _, shape, _ in leaves)
    flat = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for lo in range(0, total, CHUNK):
        hi = min(total, lo + CHUNK)
        torch.randn(hi - lo, generator=gen, dtype=dtype, device=device,
                    out=flat[lo:hi])
    n_layers = 1 + max((p[1] for p, _, _ in leaves if p[0] == "layers"),
                       default=-1)
    params = {"layers": [{} for _ in range(n_layers)]}
    off = 0
    for path, shape, std in leaves:
        n = math.prod(shape)
        leaf = flat[off:off + n].view(shape)
        leaf.mul_(std)
        off += n
        if path[0] == "layers":
            params["layers"][path[1]][path[2]] = leaf
        else:
            params[path[0]] = leaf
    return params
