"""The AFMoE decoder (Trinity-Mini): an architecture module (``decoder.py``
says what one defines).

The model entry has the published ``config.json``'s keys: ``hidden_size``,
``num_hidden_layers``, ``num_attention_heads``, ``num_key_value_heads``,
``head_dim``, ``intermediate_size`` (the leading dense layers' SwiGLU),
``moe_intermediate_size`` (each expert's and the shared expert's),
``num_experts``, ``num_experts_per_tok``, ``num_shared_experts``,
``num_dense_layers``, ``layer_types`` (``sliding_attention`` with window
``sliding_window`` and rotary, or ``full_attention`` without rotary),
``score_func`` (``sigmoid``), ``route_norm`` (true), ``route_scale``,
``n_group``/``topk_group`` (1: no group-limited routing),
``mup_enabled`` (embeddings scaled by the square root of the width),
``rms_norm_eps``, ``rope_theta``, ``vocab_size``, ``tie_word_embeddings``.

A layer's leaves, as ``repro_torch.models.transformer.param_spec`` lays
out a gated block: the decoder's ``ln1``, ``wq``, ``wk``, ``wv``, ``wo``,
``ln2``; the per-head norms ``q_norm``/``k_norm`` (head_dim,); the output
gate ``wg`` (d, H, hd); the sandwich norms ``ln1_out``/``ln2_out`` (d,);
then a dense layer's ``w_gate``/``w_up`` (d, ff), ``w_down`` (ff, d), or
an MoE layer's ``router`` (d, E), ``expert_bias`` (E,), the expert stacks
``w_gate``/``w_up`` (E, d, f), ``w_down`` (E, f, d) and the shared
expert's ``ws_gate``/``ws_up`` (d, S f), ``ws_down`` (S f, d).  Norm
weights are stored as ``w`` with the scale ``1 + w``, std
``init["norm"]``; the expert bias has std ``init["expert_bias"]``; every
matrix std 1 / sqrt(its input width) (q, k, v and the gate: d).  The
token embeddings have std ``init["afmoe_embed"]``: at random weights each
layer adds two normed updates (the sandwich norms) to the stream, so the
stream's scale before the first layer, ``afmoe_embed`` x sqrt(d), is what
a routing flip moves it by; where it is near 1, bf16's flips of near-tied
top-k selections cascade through the layers and the served tokens leave
the float32 reference as far as float8's do (PERF.md, section 2).  At
the stream's scale of 1 x sqrt(d), a bf16 stream would round each update
to the stream's last bit, so the port keeps the stream and the logits in
float32 (``ModelConfig.float32_stream``).
"""

from __future__ import annotations

import math

from h100bench.arch import decoder as D

SLIDING = "sliding_attention"


def windows(m: dict):
    """Per layer, its attention window (0 = full)."""
    return tuple(m["sliding_window"] if t == SLIDING else 0
                 for t in m["layer_types"])


def port_config(m: dict, dtype: str):
    from repro_torch.models.config import ATTN, MOE, ModelConfig
    L, nd = m["num_hidden_layers"], m["num_dense_layers"]
    if (m["score_func"] != "sigmoid" or not m["route_norm"]
            or m["n_group"] != 1 or m["topk_group"] != 1
            or len(m["layer_types"]) != L):
        raise ValueError(f"{m['name']}: the port serves normalised sigmoid "
                         f"routing without expert groups, one layer type a "
                         f"layer")
    E, k = m["num_experts"], m["num_experts_per_tok"]
    return ModelConfig(
        name=m["name"], family="moe", n_layers=L, d_model=m["hidden_size"],
        n_heads=m["num_attention_heads"],
        n_kv_heads=m["num_key_value_heads"],
        d_ff=m["moe_intermediate_size"], vocab_size=m["vocab_size"],
        head_dim=m["head_dim"], n_experts=E, top_k=k,
        capacity_factor=E / k, router="sigmoid",
        route_scale=float(m["route_scale"]),
        n_shared_experts=m["num_shared_experts"],
        dense_ff=m["intermediate_size"], unit=(ATTN,) * nd + (MOE,) * (L - nd),
        layer_windows=windows(m),
        layer_rope=tuple(t == SLIDING for t in m["layer_types"]),
        gated=True,
        embed_scale=(math.sqrt(m["hidden_size"]) if m["mup_enabled"]
                     else 1.0),
        float32_stream=True,
        rope_theta=float(m["rope_theta"]), norm_eps=float(m["rms_norm_eps"]),
        tie_embeddings=bool(m["tie_word_embeddings"]), dtype=dtype)


# ------------------------------------------------------------- layout --

def layer_leaves(m: dict, init: dict, dense: bool):
    d, H, hd = m["hidden_size"], m["num_attention_heads"], m["head_dim"]
    leaves = D.attention_leaves(dict(m, qkv_bias=False), init) + [
        ("q_norm", (hd,), init["norm"]), ("k_norm", (hd,), init["norm"]),
        ("wg", (d, H, hd), 1 / math.sqrt(d)),
        ("ln1_out", (d,), init["norm"]), ("ln2_out", (d,), init["norm"])]
    if dense:
        return leaves + D.mlp_leaves(m)
    E, f = m["num_experts"], m["moe_intermediate_size"]
    fs = m["num_shared_experts"] * f
    return leaves + [
        ("router", (d, E), 1 / math.sqrt(d)),
        ("expert_bias", (E,), init["expert_bias"]),
        ("w_gate", (E, d, f), 1 / math.sqrt(d)),
        ("w_up", (E, d, f), 1 / math.sqrt(d)),
        ("w_down", (E, f, d), 1 / math.sqrt(f)),
        ("ws_gate", (d, fs), 1 / math.sqrt(d)),
        ("ws_up", (d, fs), 1 / math.sqrt(d)),
        ("ws_down", (fs, d), 1 / math.sqrt(fs))]


def layout(m: dict, init: dict):
    """[(path, shape, std)] of every leaf, in buffer order.  The port's
    config is built first: a port that cannot serve the model fails here,
    before any weight is made."""
    port_config(m, "bfloat16")
    out = D.outer_leaves(m, dict(init, embed=init["afmoe_embed"]))
    for i in range(m["num_hidden_layers"]):
        dense = i < m["num_dense_layers"]
        out += [(("layers", i, name), shape, std) for name, shape, std
                in layer_leaves(m, init, dense)]
    return out


# ------------------------------------------------------- model FLOPs --
# 2 per multiply-add of a matmul; norms, rotary, softmax and the top-k
# selection left out

def window_pairs(start: int, n: int, window: int) -> int:
    """(query, key) pairs of ``n`` tokens after ``start`` cached ones, each
    attending itself and at most ``window`` - 1 earlier keys (0: all)."""
    if not window:
        return D.causal_pairs(start, n)
    # token at position p attends min(p + 1, window) keys
    lo, hi = start + 1, start + n
    full = max(0, hi - max(lo, window + 1) + 1)
    a, b = lo, min(hi, window)
    part = (a + b) * (b - a + 1) // 2 if b >= a else 0
    return part + full * window


def flops(m: dict, start: int, n: int) -> int:
    """Projections, the output gate, the leading dense layers' MLP, the
    router, the top-k experts and the shared expert a token is sent to,
    the LM head; attention over each layer's window."""
    d, H, hd = m["hidden_size"], m["num_attention_heads"], m["head_dim"]
    L, nd = m["num_hidden_layers"], m["num_dense_layers"]
    f = m["moe_intermediate_size"]
    proj = D.projection_flops(m) + 2 * d * H * hd
    moe = (2 * d * m["num_experts"]
           + (m["num_experts_per_tok"] + m["num_shared_experts"]) * 6 * d * f)
    per_token = (L * proj + nd * 6 * d * m["intermediate_size"]
                 + (L - nd) * moe + D.head_flops(m))
    pairs = sum(window_pairs(start, n, w) for w in windows(m))
    return n * per_token + 4 * H * hd * pairs
