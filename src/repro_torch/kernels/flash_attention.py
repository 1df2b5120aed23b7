"""Causal (optionally sliding-window) prefill attention, GQA.

``flash_attention`` is the wrapper, public through
``kernels.ops.flash_attention``.  On a CPU tensor it runs the plain version
(:func:`flash_attention_plain`, ``ref.mha_ref``: the whole masked score
matrix in float32).  On a CUDA tensor it launches the hand-written kernel
``csrc/flash_attention.cu`` or raises; there is no fallback on the card.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, ref

NAME = "flash_attention"
MAX_GROUP = 64  # query heads per kv head: csrc/flash_attention.cu kRows


# The plain version: the whole masked score matrix, float32 softmax.
flash_attention_plain = ref.mha_ref


def _c_fn():
    fn = build.load("flash_attention").spin_flash_attention
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 4 + [i] * 7 + [ctypes.c_float, p]
    fn.restype = i
    return fn


def flash_attention(q, k, v, *, window: int = 0):
    """q: (B, S, H, D); k, v: (B, S, Kh, D), H % Kh == 0.  Query t attends
    key s iff s <= t and, with ``window > 0``, s > t - window.  Returns
    (B, S, H, D) in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention takes CPU or CUDA tensors, got "
                         f"{q.device}")
    B, S, H, D = q.shape
    Kh = k.shape[2]
    if H % Kh or H // Kh > MAX_GROUP or D > build.MAX_D:
        raise ValueError(f"unsupported head geometry H={H} Kh={Kh} D={D} "
                         f"(H % Kh == 0, H / Kh <= {MAX_GROUP}, "
                         f"D <= {build.MAX_D})")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    for name, t, shape in (("q", q, (B, S, H, D)), ("k", k, (B, S, Kh, D)),
                           ("v", v, (B, S, Kh, D))):
        # q, k and v of one float32 or bfloat16 dtype
        build.check_tensor(name, t, shape, {q.dtype} & set(build.Q_CODES),
                           q.device)
    out = torch.empty_like(q)
    ptr = build.ptr
    rc = _c_fn()(ptr(q), ptr(k), ptr(v), ptr(out), B, S, H, Kh, D,
                 int(window), build.Q_CODES[q.dtype], 1.0 / math.sqrt(D),
                 build.stream_of(q))
    build.raise_on(rc, NAME)
    build.LAUNCHES[NAME] += 1
    return out
