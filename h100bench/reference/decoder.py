"""Plain PyTorch reference of the served decoders (Qwen2.5, InternLM2).

A pre-norm decoder as the models' papers and configs describe it:
RMSNorm (scale stored as ``1 + w``), q/k/v projections with the optional
QKV bias, rotary embeddings on the two halves of each head (theta from
the config), causal grouped-query attention, the output projection, a
SwiGLU MLP, a final RMSNorm and the LM head (the transposed embedding
where the model ties them).  No kernel, cache or batching trick: every
sequence is run whole from its first token.

It computes in float32 from the served weights' values, one layer at a
time (each layer's weights are upcast only while it runs), with TF32 off.
``quant="fp8"`` is the control: every matmul's weight (per output
channel) and input (per row) rounded to float8 e4m3 first, the precision
next below the served bfloat16.

Imports nothing of the program.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0
VOCAB_CHUNK = 32768


def head_dim(m: dict) -> int:
    return m.get("head_dim") or m["hidden_size"] // m["num_attention_heads"]


@contextlib.contextmanager
def exact_float32():
    """Float32 matmuls in float32 (no TF32) while the reference runs."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def fp8(x, dim):
    """``x`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (its absolute max maps to the format's largest value)."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def matmul(x, w, quant):
    """x (n, k) @ w (k, m) in float32; the control rounds both to fp8."""
    w = w.float()
    if quant == "fp8":
        return fp8(x, -1) @ fp8(w, 0)
    return x @ w


def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (
        1.0 + w.float())


def rope(x, theta):
    """x (B, S, heads, hd) at positions 0..S-1."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freq = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                        device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freq
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(x, p, m, quant):
    """x plus the layer's causal self-attention of ``rms_norm(x)``."""
    B, S, d = x.shape
    H, Kh, hd = m["num_attention_heads"], m["num_key_value_heads"], head_dim(m)
    eps = m["rms_norm_eps"]
    h = rms_norm(x, p["ln1"], eps).reshape(B * S, d)
    q = matmul(h, p["wq"].reshape(d, H * hd), quant).view(B, S, H, hd)
    k = matmul(h, p["wk"].reshape(d, Kh * hd), quant).view(B, S, Kh, hd)
    v = matmul(h, p["wv"].reshape(d, Kh * hd), quant).view(B, S, Kh, hd)
    if "bq" in p:
        q, k, v = q + p["bq"].float(), k + p["bk"].float(), v + p["bv"].float()
    q, k = rope(q, m["rope_theta"]), rope(k, m["rope_theta"])
    G = H // Kh
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    return x + matmul(o.reshape(B * S, H * hd), p["wo"].reshape(H * hd, d),
                      quant).view(B, S, d)


def layer(x, p, m, quant):
    x = attention(x, p, m, quant)
    B, S, d = x.shape
    h = rms_norm(x, p["ln2"], m["rms_norm_eps"]).reshape(B * S, d)
    a = F.silu(matmul(h, p["w_gate"], quant)) * matmul(h, p["w_up"], quant)
    return x + matmul(a, p["w_down"], quant).view(B, S, d)


def hidden(params, m, tokens, quant=None):
    """Final-normed hidden states (B, S, d), float32, of token rows
    ``tokens`` (B, S) (rows padded at the end: causality keeps the
    padding out of every earlier position)."""
    with exact_float32():
        x = F.embedding(tokens.long(), params["embed"]).float()
        for p in params["layers"]:
            x = layer(x, p, m, quant)
        return rms_norm(x, params["final_norm"], m["rms_norm_eps"])


def logits(params, m, rows, quant=None):
    """Logits (n, vocab), float32, of hidden rows (n, d)."""
    V = m["vocab_size"]
    head = (params["embed"].T if m["tie_word_embeddings"]
            else params["lm_head"])
    with exact_float32():
        return torch.cat([matmul(rows, head[:, lo:min(V, lo + VOCAB_CHUNK)],
                                 quant)
                          for lo in range(0, V, VOCAB_CHUNK)], dim=1)
