"""Plain PyTorch reference of ``arch/tiny_moe.py``'s decoder: the
decoder reference's attention (``decoder.py`` beside this file), then a
mixture of experts in float32: a softmax router, the top ``k`` experts
renormalised to sum to 1, SwiGLU experts, no capacity and no drops.

Imports nothing of the program.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import torch
import torch.nn.functional as F


def _decoder():
    path = Path(__file__).with_name("decoder.py")
    spec = importlib.util.spec_from_file_location("tiny_moe_decoder", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


D = _decoder()


def experts(h, p, m, quant):
    """h (n, d) through the router and its top-k experts."""
    probs = torch.softmax(D.matmul(h, p["router"], quant), -1)
    gate, idx = probs.topk(m["num_experts_per_tok"], dim=-1)
    gate = gate / gate.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(m["num_experts"]):
        rows, choice = (idx == e).nonzero(as_tuple=True)
        x = h[rows]
        a = (F.silu(D.matmul(x, p["w_gate"][e], quant))
             * D.matmul(x, p["w_up"][e], quant))
        y = D.matmul(a, p["w_down"][e], quant)
        out.index_add_(0, rows, gate[rows, choice, None] * y)
    return out


def layer(x, p, m, quant):
    x = D.attention(x, p, m, quant)
    B, S, d = x.shape
    h = D.rms_norm(x, p["ln2"], m["rms_norm_eps"]).reshape(B * S, d)
    return x + experts(h, p, m, quant).view(B, S, d)


def hidden(params, m, tokens, quant=None):
    """Final-normed hidden states (B, S, d), float32, of token rows
    ``tokens`` (B, S)."""
    with D.exact_float32():
        x = F.embedding(tokens.long(), params["embed"]).float()
        for p in params["layers"]:
            x = layer(x, p, m, quant)
        return D.rms_norm(x, params["final_norm"], m["rms_norm_eps"])


logits = D.logits
