"""A decoder whose every layer's MLP is the port's top-k mixture of
experts (``MOE`` blocks): an architecture module that the extension test
adds to a copy of the benchmark as a file, beside a configuration that
names it by ``"arch": "tiny_moe"``.

The model entry has the decoder's keys, with ``intermediate_size`` each
expert's width, plus ``num_experts`` and ``num_experts_per_tok``.  A layer
is the decoder's attention leaves, then ``router`` (d, E) and the expert
stacks ``w_gate``/``w_up`` (E, d, ff), ``w_down`` (E, ff, d), as
``repro_torch.models.transformer`` lays out an ``MOE`` block.  Dropless:
the capacity factor E / top_k gives every expert room for every token.
"""

from __future__ import annotations

import dataclasses
import math

from h100bench.arch import decoder as D


def port_config(m: dict, dtype: str):
    from repro_torch.models.config import MOE
    E, k = m["num_experts"], m["num_experts_per_tok"]
    return dataclasses.replace(D.port_config(m, dtype), family="moe",
                               unit=(MOE,), n_experts=E, top_k=k,
                               capacity_factor=E / k)


def layout(m: dict, init: dict):
    d, ff, E = m["hidden_size"], m["intermediate_size"], m["num_experts"]
    experts = [("router", (d, E), 1 / math.sqrt(d)),
               ("w_gate", (E, d, ff), 1 / math.sqrt(d)),
               ("w_up", (E, d, ff), 1 / math.sqrt(d)),
               ("w_down", (E, ff, d), 1 / math.sqrt(ff))]
    out = D.outer_leaves(m, init)
    for i in range(m["num_hidden_layers"]):
        out += [(("layers", i, name), shape, std) for name, shape, std
                in D.attention_leaves(m, init) + experts]
    return out


def flops(m: dict, start: int, n: int) -> int:
    """The router and the top-k experts a token is sent to, not every
    expert."""
    d, ff = m["hidden_size"], m["intermediate_size"]
    moe = 2 * d * m["num_experts"] + m["num_experts_per_tok"] * 6 * d * ff
    per_token = (m["num_hidden_layers"] * (D.projection_flops(m) + moe)
                 + D.head_flops(m))
    return (n * per_token
            + D.attention_flops(m, D.causal_pairs(start, n)))
