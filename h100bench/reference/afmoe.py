"""Plain PyTorch reference of ``arch/afmoe.py``'s decoder (Trinity-Mini).

The layer as the AFMoE modeling file describes it (the published
``config.json`` names no key for the parts marked *):

    x = Embed(t) * sqrt(d)                          (* mup_enabled)
    layer l (sliding iff layer_types[l] is sliding_attention):
      h = RMSNorm_in(x)
      q = RMSNorm_q(h Wq) per head, k = RMSNorm_k(h Wk) per head, v = h Wv
      sliding: q, k = RoPE(q, k); full: no rotary    (* QK-norm, rotary)
      a = softmax(q k^T / sqrt(hd) + mask) v       causal; sliding also
                                                   kv_pos > q_pos - window
      a = a * sigmoid(h Wg)                        (* output gate)
      x = x + RMSNorm_post_attn(a Wo)              (* sandwich norms)
      u = RMSNorm_pre_mlp(x)
      dense: f = SwiGLU(u)
      MoE:   s = sigmoid(u Wr); idx = top-k(s + expert_bias)
             w = s[idx] / (sum s[idx] + 1e-20) * route_scale
             f = sum_j w_j SwiGLU_idx_j(u) + SwiGLU_shared(u)
      x = x + RMSNorm_post_mlp(f)
    logits = RMSNorm_final(x) W_head

In float32 with TF32 off, every sequence run whole from its first token,
queries in chunks so that long prompts fit, each expert over the rows
routed to it; no capacity and no drops.  ``quant="fp8"`` is the control
(every matmul's weight and input in float8 e4m3, as ``decoder.py`` does).
It reuses ``decoder.py`` beside this file for the norms, rotary, the
matmul and the head.  Imports nothing of the program.
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import torch
import torch.nn.functional as F


def _decoder():
    path = Path(__file__).with_name("decoder.py")
    spec = importlib.util.spec_from_file_location("afmoe_decoder", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


D = _decoder()
Q_CHUNK = 512          # query rows a score block


def attention(h, p, m, window, rotary, quant):
    """The gated attention of normed rows h (B, S, d), before Wo's norm."""
    B, S, d = h.shape
    H, Kh, hd = m["num_attention_heads"], m["num_key_value_heads"], m["head_dim"]
    eps = m["rms_norm_eps"]
    hf = h.reshape(B * S, d)
    q = D.matmul(hf, p["wq"].reshape(d, H * hd), quant).view(B, S, H, hd)
    k = D.matmul(hf, p["wk"].reshape(d, Kh * hd), quant).view(B, S, Kh, hd)
    v = D.matmul(hf, p["wv"].reshape(d, Kh * hd), quant).view(B, S, Kh, hd)
    q, k = D.rms_norm(q, p["q_norm"], eps), D.rms_norm(k, p["k_norm"], eps)
    if rotary:
        q, k = D.rope(q, m["rope_theta"]), D.rope(k, m["rope_theta"])
    G = H // Kh
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    pos = torch.arange(S, device=h.device)
    o = torch.empty(B, S, H, hd, dtype=torch.float32, device=h.device)
    for lo in range(0, S, Q_CHUNK):
        hi = min(S, lo + Q_CHUNK)
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, lo:hi], k) / math.sqrt(hd)
        ok = pos[None, :] <= pos[lo:hi, None]
        if window:
            ok &= pos[None, :] > pos[lo:hi, None] - window
        s = s.masked_fill(~ok, float("-inf"))
        o[:, lo:hi] = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    gate = torch.sigmoid(D.matmul(hf, p["wg"].reshape(d, H * hd), quant))
    return D.matmul(o.reshape(B * S, H * hd) * gate,
                    p["wo"].reshape(H * hd, d), quant).view(B, S, d)


def swiglu(x, wg, wu, wd, quant):
    return D.matmul(F.silu(D.matmul(x, wg, quant)) * D.matmul(x, wu, quant),
                    wd, quant)


def experts(u, p, m, quant):
    """Rows u (n, d) through the sigmoid router, their top-k experts and
    the shared expert."""
    s = torch.sigmoid(D.matmul(u, p["router"], quant))
    idx = torch.topk(s + p["expert_bias"].float(), m["num_experts_per_tok"],
                     dim=-1).indices
    w = s.gather(1, idx)
    if m["route_norm"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    w = w * m["route_scale"]
    out = swiglu(u, p["ws_gate"], p["ws_up"], p["ws_down"], quant)
    for e in range(m["num_experts"]):
        rows, choice = (idx == e).nonzero(as_tuple=True)
        if rows.numel():
            y = swiglu(u[rows], p["w_gate"][e], p["w_up"][e], p["w_down"][e],
                       quant)
            out.index_add_(0, rows, w[rows, choice, None] * y)
    return out


def layer(x, p, m, i, quant):
    B, S, d = x.shape
    eps = m["rms_norm_eps"]
    sliding = m["layer_types"][i] == "sliding_attention"
    a = attention(D.rms_norm(x, p["ln1"], eps), p, m,
                  m["sliding_window"] if sliding else 0, sliding, quant)
    x = x + D.rms_norm(a, p["ln1_out"], eps)
    u = D.rms_norm(x, p["ln2"], eps).reshape(B * S, d)
    if i < m["num_dense_layers"]:
        f = swiglu(u, p["w_gate"], p["w_up"], p["w_down"], quant)
    else:
        f = experts(u, p, m, quant)
    return x + D.rms_norm(f.view(B, S, d), p["ln2_out"], eps)


def hidden(params, m, tokens, quant=None):
    """Final-normed hidden states (B, S, d), float32, of token rows
    ``tokens`` (B, S) (rows padded at the end: causality keeps the
    padding out of every earlier position)."""
    with D.exact_float32():
        x = F.embedding(tokens.long(), params["embed"]).float()
        if m["mup_enabled"]:
            x = x * math.sqrt(m["hidden_size"])
        for i, p in enumerate(params["layers"]):
            x = layer(x, p, m, i, quant)
        return D.rms_norm(x, params["final_norm"], m["rms_norm_eps"])


logits = D.logits
