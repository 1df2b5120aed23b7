"""Mixture-of-Experts FFN: the capacity-bounded training path and the
dropless serving path.

:func:`moe_ffn` (top-k routing, capacity-bounded, sort-free) is the port of
the reference's ``models/moe.py``.  Dispatch places each (token,
choice) pair at its rank inside its expert; pairs ranked past the capacity
``C`` are dropped.  The expert products run as batched matmuls over the
(E, C) slots, as the reference leaves them to XLA.

Two places where PyTorch differs from JAX and the port keeps the
reference's result:

* ``lax.top_k`` breaks ties by the lower index; ``torch.topk`` promises no
  order, so the experts come from a stable sort on ``-probs``;
* the reference scatters dropped pairs through the out-of-range expert
  ``E`` (``mode="drop"``); here they land in one spare slot past the
  (E, C) grid, which is cut off, so no index is ever out of bounds and no
  host sync is needed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (constrain, is_dtensor,
                                              row_gather)
from repro_torch.kernels import ops
from repro_torch.serving import trace


def capacity(n_tokens: int, n_experts: int, top_k: int, cf: float) -> int:
    c = int(n_tokens * top_k * cf / n_experts)
    return max(128, int((c + 127) // 128 * 128))  # 128-aligned


def moe_ffn(x, router_w, w_gate, w_up, w_down, *, top_k: int, cf: float):
    """x: (T, d).  w_*: (E, d, ff) / (E, ff, d).  Returns (out (T, d),
    load-balancing aux loss, router z-loss)."""
    T, d = x.shape
    E = router_w.shape[1]
    C = capacity(T, E, top_k, cf)

    logits = x.float() @ router_w.float()  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    expert_ids = torch.sort(-probs, dim=-1, stable=True).indices[:, :top_k]
    gate_vals = torch.gather(probs, 1, expert_ids)  # (T, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    flat_e = expert_ids.reshape(-1)  # (T*k,)
    onehot = F.one_hot(flat_e, E)  # (T*k, E)
    # rank of each pair inside its expert
    pos = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(-1)
    keep = pos < C
    token_idx = torch.arange(T, device=x.device).repeat_interleave(top_k)

    # slot of each kept pair in the flat (E*C) grid; dropped pairs go to
    # the spare slot E*C.  Unfilled slots keep token 0 with validity 0.
    flat = torch.where(keep, flat_e * C + pos, E * C)
    slot_tok = torch.zeros(E * C + 1, dtype=torch.long,
                           device=x.device).scatter(0, flat, token_idx)
    slot_valid = torch.zeros(E * C + 1, dtype=x.dtype,
                             device=x.device).scatter(
        0, flat, torch.ones_like(flat, dtype=x.dtype))
    slot_tok = slot_tok[: E * C].view(E, C)
    slot_valid = slot_valid[: E * C].view(E, C)

    at = torch.where(keep, pos, 0)
    cap = None
    if is_dtensor(x):
        # under a rule table the (E, C) grid is laid out by one of two
        # plans, whichever moves fewer bytes: many slots (training,
        # prefill) split the capacity as the table lays it out and gather
        # the experts' weights for their use (3 E d ff elements); few
        # (decode) leave the weights where they are, split the grid's d as
        # theirs and sum the partial products (twice 2 E C ff).  The
        # gathers of dispatch and combine take their own cheaper layouts.
        stationary = 4 * C * x.element_size() < 3 * d * w_gate.element_size()
        cap = None if stationary else "exp_cap"
        slot_tok, slot_valid = (constrain(a, "experts", cap)
                                for a in (slot_tok, slot_valid))
        flat_e, at = (constrain(a, "batch") for a in (flat_e, at))
        xin = row_gather(x, slot_tok)
        if stationary:
            xin = constrain(xin, "experts", None, "exp_embed")
        else:
            w_gate, w_up = (constrain(w, "experts", None, "mlp")
                            for w in (w_gate, w_up))
            w_down = constrain(w_down, "experts", "mlp", None)
    else:
        xin = x[slot_tok]
    xin = xin * slot_valid[..., None]  # (E, C, d)
    g, u = torch.bmm(xin, w_gate), torch.bmm(xin, w_up)
    if is_dtensor(g):
        g, u = (constrain(a, "experts", cap, "mlp") for a in (g, u))
    h = F.silu(g) * u
    y = torch.bmm(h, w_down)  # (E, C, d)

    # combine: each (token, choice) reads its expert's output slot
    if is_dtensor(y):
        yk = row_gather(y, flat_e, at)
    else:
        yk = y[flat_e, at]  # (T*k, d)
    yk = yk * keep[:, None].to(y.dtype)
    yk = yk.reshape(T, top_k, d) * gate_vals[..., None].to(y.dtype)
    out = yk.sum(1)

    # load-balancing aux loss (Switch-style) + router z-loss
    me = probs.mean(0)
    ce = F.one_hot(expert_ids[:, 0], E).float().mean(0)
    aux = E * torch.sum(me * ce)
    zloss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return out.to(x.dtype), aux, zloss


# ------------------------------------------------------------ dropless --
# The serving forwards' experts: every (token, choice) pair computed, none
# dropped, through ``ops.moe_experts`` (on the card a grouped kernel over
# the experts routed to; looked up as an attribute at each call).

def route(x, p, cfg):
    """(expert ids (T, k), weights (T, k) float32) of tokens x (T, d).
    ``softmax``: the top-k of the softmax renormalised, as ``moe_ffn``
    routes.  ``sigmoid``: scores s = sigmoid(x W_r) in float32, the top-k
    of s + ``expert_bias`` selected, weighted by s alone divided by their
    sum plus 1e-20, times ``cfg.route_scale``."""
    logits = x.float() @ p["router"].float()
    k = cfg.top_k
    if cfg.router == "sigmoid":
        s = torch.sigmoid(logits)
        ids = torch.topk(s + p["expert_bias"].float(), k, dim=-1).indices
        w = torch.gather(s, 1, ids)
        return ids, w / (w.sum(-1, keepdim=True) + 1e-20) * cfg.route_scale
    probs = torch.softmax(logits, dim=-1)
    ids = torch.sort(-probs, dim=-1, stable=True).indices[:, :k]
    w = torch.gather(probs, 1, ids)
    return ids, w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)


def dropless(x, p, cfg):
    """The MoE FFN of tokens x (T, d) with no capacity: the routed experts
    (``ops.moe_experts``) plus the shared experts (``ws_*``, one SwiGLU of
    their summed width).  Counts ``moe_calls`` and ``moe_pairs`` (T x
    top_k) in the serving tracer, from shapes alone."""
    ids, w = route(x, p, cfg)
    trace.count("moe_calls")
    trace.count("moe_pairs", ids.numel())
    out = ops.moe_experts(x, ids, w, p["w_gate"], p["w_up"], p["w_down"])
    if cfg.n_shared_experts:
        out = out + F.silu(x @ p["ws_gate"]) * (x @ p["ws_up"]) @ p["ws_down"]
    return out
