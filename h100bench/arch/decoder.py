"""The dense pre-norm decoder (Qwen2.5, InternLM2): the port's config of a
model, its parameter layout and its model FLOPs.

An architecture module.  A model entry of a configuration file (``llm``
or one of ``ssms``) names its module by ``"arch"``, ``decoder`` where it
names none, and the harness loads ``<bench>/arch/<arch>.py``.  Each such
module defines

* ``port_config(m, dtype)``: the port's ``ModelConfig`` of model ``m``;
* ``layout(m, init)``: ``[(path, shape, std)]`` of every parameter leaf in
  buffer order, paths ``("layers", i, leaf)`` or ``(leaf,)`` as the port's
  parameter tree has them (``weights.make`` fills them from the seed);
* ``flops(m, start, n)``: the model FLOPs of ``n`` tokens of one sequence
  after ``start`` cached ones, counting only what the model computes.

This one: ``embed`` (padded vocab, d), ``lm_head`` (d, padded vocab)
unless tied, ``final_norm`` (d,), and per layer ``ln1``, ``wq`` (d, H, hd),
``wk``/``wv`` (d, Kh, hd), ``wo`` (H, hd, d), ``ln2``, the QKV biases where
the model has them, ``w_gate``/``w_up`` (d, ff) and ``w_down`` (ff, d), as
``repro_torch.models.transformer.param_spec`` lays out an ``ATTN`` block.
Norm weights are stored as ``w`` with the scale ``1 + w``.  q, k and v
take fan_in = d (so attention logits have unit scale), the other matrices
fan_in = their input width, the embedding ``init["embed"]``, norms
``init["norm"]`` and biases ``init["bias"]``.
"""

from __future__ import annotations

import math


def padded_vocab(m: dict) -> int:
    return int(math.ceil(m["vocab_size"] / 256) * 256)


def head_dim(m: dict) -> int:
    return m.get("head_dim") or m["hidden_size"] // m["num_attention_heads"]


def port_config(m: dict, dtype: str):
    from repro_torch.models.config import ATTN, ModelConfig
    return ModelConfig(
        name=m["name"], family="dense", n_layers=m["num_hidden_layers"],
        d_model=m["hidden_size"], n_heads=m["num_attention_heads"],
        n_kv_heads=m["num_key_value_heads"], d_ff=m["intermediate_size"],
        vocab_size=m["vocab_size"], head_dim=head_dim(m),
        qkv_bias=bool(m.get("qkv_bias")), unit=(ATTN,),
        rope_theta=float(m["rope_theta"]), norm_eps=float(m["rms_norm_eps"]),
        tie_embeddings=bool(m["tie_word_embeddings"]), dtype=dtype)


# ------------------------------------------------------------- layout --

def outer_leaves(m: dict, init: dict):
    """The embedding, the LM head unless tied, the final norm."""
    d, V = m["hidden_size"], padded_vocab(m)
    out = [(("embed",), (V, d), init["embed"])]
    if not m["tie_word_embeddings"]:
        out.append((("lm_head",), (d, V), 1 / math.sqrt(d)))
    out.append((("final_norm",), (d,), init["norm"]))
    return out


def attention_leaves(m: dict, init: dict):
    """(leaf, shape, std) of a layer's norms, projections and biases."""
    d, H, Kh, hd = (m["hidden_size"], m["num_attention_heads"],
                    m["num_key_value_heads"], head_dim(m))
    leaves = [("ln1", (d,), init["norm"]),
              ("wq", (d, H, hd), 1 / math.sqrt(d)),
              ("wk", (d, Kh, hd), 1 / math.sqrt(d)),
              ("wv", (d, Kh, hd), 1 / math.sqrt(d)),
              ("wo", (H, hd, d), 1 / math.sqrt(H * hd)),
              ("ln2", (d,), init["norm"])]
    if m.get("qkv_bias"):
        leaves += [("bq", (H, hd), init["bias"]),
                   ("bk", (Kh, hd), init["bias"]),
                   ("bv", (Kh, hd), init["bias"])]
    return leaves


def mlp_leaves(m: dict):
    d, ff = m["hidden_size"], m["intermediate_size"]
    return [("w_gate", (d, ff), 1 / math.sqrt(d)),
            ("w_up", (d, ff), 1 / math.sqrt(d)),
            ("w_down", (ff, d), 1 / math.sqrt(ff))]


def layout(m: dict, init: dict):
    """[(path, shape, std)] of every leaf, in buffer order."""
    out = outer_leaves(m, init)
    for i in range(m["num_hidden_layers"]):
        out += [(("layers", i, name), shape, std) for name, shape, std
                in attention_leaves(m, init) + mlp_leaves(m)]
    return out


# ------------------------------------------------------- model FLOPs --
# 2 per multiply-add of a matmul; norms, rotary and softmax left out

def projection_flops(m: dict) -> int:
    """One token through one layer's q, k, v and output projections."""
    d, H, Kh, hd = (m["hidden_size"], m["num_attention_heads"],
                    m["num_key_value_heads"], head_dim(m))
    return 2 * (d * (H + 2 * Kh) * hd + H * hd * d)


def head_flops(m: dict) -> int:
    """One token through the LM head over the published vocabulary."""
    return 2 * m["hidden_size"] * m["vocab_size"]


def dense_flops_per_token(m: dict) -> int:
    """Matmul FLOPs of one token through a decoder of the config's widths:
    the projections, the SwiGLU MLP and the LM head."""
    mlp = 2 * 3 * m["hidden_size"] * m["intermediate_size"]
    return (m["num_hidden_layers"] * (projection_flops(m) + mlp)
            + head_flops(m))


def attention_flops(m: dict, attended: int) -> int:
    """FLOPs of scores and values over ``attended`` (query, key) pairs,
    summed over the layers."""
    return (4 * m["num_attention_heads"] * head_dim(m) * attended
            * m["num_hidden_layers"])


def causal_pairs(start: int, n: int) -> int:
    """(query, key) pairs of ``n`` causal tokens after ``start`` cached
    ones, each token attending itself."""
    return n * start + n * (n + 1) // 2


def flops(m: dict, start: int, n: int) -> int:
    """Model FLOPs of ``n`` tokens of one sequence after ``start`` cached
    ones."""
    return (n * dense_flops_per_token(m)
            + attention_flops(m, causal_pairs(start, n)))
