"""Dense GQA decode: one query token per row against a (B, S, Kh, D)
cache, slots at or past ``lengths[b]`` masked.

``decode_attention`` is the wrapper, public through
``kernels.ops.decode_attention``.  On a CPU tensor it runs the plain version
(:func:`decode_attention_plain`).  On a CUDA tensor it launches the
hand-written kernel ``csrc/decode_attention.cu`` or raises; there is no
fallback on the card.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, ref

NAME = "decode_attention"

# The plain version: masked attention over each row's cache.
decode_attention_plain = ref.decode_attention_ref


def _c_fn():
    fn = build.load("decode_attention").spin_decode_attention
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 5 + [i] * 7 + [ctypes.c_float, p]
    fn.restype = i
    return fn


def decode_attention(q, k, v, lengths):
    """q: (B, H, D); k, v: (B, S, Kh, D); lengths: (B,) int32 live prefix
    per row.  Returns (B, H, D) in q's dtype; a row of length 0 gives
    zeros."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lengths)
    B, H, D = q.shape
    S, Kh = k.shape[1], k.shape[2]
    q_code, kv_code = build.check_dense(q, k, v, (B, S, Kh, D))
    build.check_int("lengths", lengths, (B,), q.device)
    out = torch.empty_like(q)
    ptr = build.ptr
    rc = _c_fn()(ptr(q), ptr(k), ptr(v), ptr(lengths), ptr(out), B, S, H, Kh,
                 D, q_code, kv_code, 1.0 / math.sqrt(D), build.stream_of(q))
    build.raise_on(rc, NAME)
    build.LAUNCHES[NAME] += 1
    return out
