"""Random weights in the program's parameter layout, made from the seed.

The layout is the port's (``repro_torch.models.transformer.param_spec``
for a dense decoder): ``embed`` (padded vocab, d), ``lm_head`` (d, padded
vocab) unless tied, ``final_norm`` (d,), and per layer ``ln1``, ``wq`` (d,
H, hd), ``wk``/``wv`` (d, Kh, hd), ``wo`` (H, hd, d), ``ln2``, the QKV
biases where the model has them, ``w_gate``/``w_up`` (d, ff) and
``w_down`` (ff, d).  Norm weights are stored as ``w`` with the scale
``1 + w``.  A CPU test holds this layout to the port's spec.

Every leaf is a view of one flat buffer in the serving dtype, filled by a
few large ``torch.randn`` calls from a generator on the device and scaled
per leaf: q, k and v take fan_in = d (so attention logits have unit
scale), the other matrices fan_in = their input width, the embedding
``init["embed"]``, norms ``init["norm"]`` and biases ``init["bias"]``.
"""

from __future__ import annotations

import math

import torch

CHUNK = 1 << 30          # elements per randn call


def padded_vocab(m: dict) -> int:
    return int(math.ceil(m["vocab_size"] / 256) * 256)


def head_dim(m: dict) -> int:
    return m.get("head_dim") or m["hidden_size"] // m["num_attention_heads"]


def layout(m: dict, init: dict):
    """[(path, shape, std)] of every leaf, in buffer order."""
    d, H, Kh, hd = (m["hidden_size"], m["num_attention_heads"],
                    m["num_key_value_heads"], head_dim(m))
    ff, V = m["intermediate_size"], padded_vocab(m)
    out = [(("embed",), (V, d), init["embed"])]
    if not m["tie_word_embeddings"]:
        out.append((("lm_head",), (d, V), 1 / math.sqrt(d)))
    out.append((("final_norm",), (d,), init["norm"]))
    for i in range(m["num_hidden_layers"]):
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
        leaves += [("w_gate", (d, ff), 1 / math.sqrt(d)),
                   ("w_up", (d, ff), 1 / math.sqrt(d)),
                   ("w_down", (ff, d), 1 / math.sqrt(ff))]
        out += [(("layers", i, name), shape, std)
                for name, shape, std in leaves]
    return out


def model_seed(seed: int, index: int) -> int:
    """The generator seed of model ``index`` (0 the LLM, 1.. the SSMs)."""
    return (int(seed) * 1_000_003 + 7919 * index) % (2**63 - 1)


def make(m: dict, init: dict, seed: int, device, dtype=torch.bfloat16):
    """The parameter tree of model ``m``, on ``device``, from ``seed``."""
    device = torch.device(device)
    leaves = layout(m, init)
    total = sum(math.prod(shape) for _, shape, _ in leaves)
    flat = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for lo in range(0, total, CHUNK):
        hi = min(total, lo + CHUNK)
        torch.randn(hi - lo, generator=gen, dtype=dtype, device=device,
                    out=flat[lo:hi])
    params = {"layers": [{} for _ in range(m["num_hidden_layers"])]}
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

