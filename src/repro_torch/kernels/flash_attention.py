"""Causal (optionally sliding-window) prefill attention, GQA.

``flash_attention`` is the wrapper, public through
``kernels.ops.flash_attention``.  On a CPU tensor it runs the plain version
(:func:`flash_attention_plain`, ``ref.mha_ref``: the whole masked score
matrix in float32).  On a CUDA tensor it launches one of the two
hand-written kernels of ``csrc/flash_attention.cu``, picked by
:func:`route` from the dtype: bf16 on the tensor cores (``mma.sync``),
float32 on the CUDA cores.  There is no fallback on the card: a build or
launch failure raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, ref

NAME = "flash_attention"
MAX_GROUP = 64  # query heads per kv head: csrc/flash_attention.cu kRows
# head dims the tensor-core kernel is instantiated for (multiples of 16)
MMA_HEAD_DIMS = (64, 96, 128)
# route -> C entry point of csrc/flash_attention.cu
ENTRY = {"mma": "spin_flash_attention_bf16",
         "scalar": "spin_flash_attention_f32"}


# The plain version: the whole masked score matrix, float32 softmax.
flash_attention_plain = ref.mha_ref


def route(dtype, D: int) -> str:
    """The kernel a CUDA call launches: ``"mma"`` (tensor cores) for
    bfloat16 with D in :data:`MMA_HEAD_DIMS`, ``"scalar"`` (CUDA cores)
    for float32 with D <= 128; TF32 tensor cores would miss the float32
    tolerance of 1e-4.  Raises for anything else."""
    if dtype == torch.bfloat16 and D in MMA_HEAD_DIMS:
        return "mma"
    if dtype == torch.float32 and 0 < D <= build.MAX_D:
        return "scalar"
    raise ValueError(f"flash_attention takes bfloat16 with D in "
                     f"{MMA_HEAD_DIMS} or float32 with D <= {build.MAX_D}, "
                     f"got {dtype} D={D}")


def _c_fn(kind):
    fn = getattr(build.load("flash_attention"), ENTRY[kind])
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 4 + [i] * 6 + [ctypes.c_float, p]
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
    if H % Kh or H // Kh > MAX_GROUP:
        raise ValueError(f"unsupported head geometry H={H} Kh={Kh} "
                         f"(H % Kh == 0, H / Kh <= {MAX_GROUP})")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    kind = route(q.dtype, D)
    for name, t, shape in (("q", q, (B, S, H, D)), ("k", k, (B, S, Kh, D)),
                           ("v", v, (B, S, Kh, D))):
        build.check_tensor(name, t, shape, (q.dtype,), q.device)
    out = torch.empty_like(q)
    ptr = build.ptr
    rc = _c_fn(kind)(ptr(q), ptr(k), ptr(v), ptr(out), B, S, H, Kh, D,
                     int(window), 1.0 / math.sqrt(D), build.stream_of(q))
    build.raise_on(rc, NAME)
    build.LAUNCHES[NAME] += 1
    return out
