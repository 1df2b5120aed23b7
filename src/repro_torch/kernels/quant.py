"""Quantized paged-KV block helpers.

Precision spent on speculative KV state is capacity overhead, so the paged
pools can store K/V as ``int8`` (symmetric, qmax 127) or fp8
``torch.float8_e4m3fn`` (qmax 448) with a float32 scale sidecar of shape
``(num_blocks, block_size, Kh)`` per layer, one scale per (slot, kv head).
Per-slot granularity means appending into a partially filled block never
requantizes earlier slots; per-head granularity keeps quiet heads from being
crushed by a loud sibling.

Quantize-on-write happens at the two scatter sites (``serving/pool.py``
admission, ``serving/paged._write_kv`` appends); dequantize happens inside
the CUDA kernels (``scale * q`` on the tile in shared memory) or
post-gather on the plain path.

``"bf16"`` (the default ``--kv-dtype``) means "store the model's compute
dtype": no scale leaves exist.
"""

from __future__ import annotations

import torch

# kv-dtype name -> (storage dtype, symmetric quantization range)
KV_DTYPES = {
    "int8": (torch.int8, 127.0),
    "fp8": (torch.float8_e4m3fn, 448.0),
}
KV_DTYPE_NAMES = ("bf16",) + tuple(KV_DTYPES)


def is_quantized(name: str) -> bool:
    return name in KV_DTYPES


def storage_dtype(name: str):
    """Pool leaf dtype for a kv-dtype name; None = compute dtype."""
    if name in KV_DTYPES:
        return KV_DTYPES[name][0]
    if name == "bf16":
        return None
    raise ValueError(
        f"kv_dtype must be one of {'/'.join(KV_DTYPE_NAMES)}, got {name!r}")


def dtype_name(dt) -> str:
    """kv-dtype name of a pool leaf dtype (autotune keys, stats)."""
    for name, (qdt, _) in KV_DTYPES.items():
        if dt == qdt:
            return name
    return "bf16"


def qmax_of(dt) -> float:
    for qdt, qmax in KV_DTYPES.values():
        if dt == qdt:
            return qmax
    raise ValueError(f"{dt} is not a quantized KV dtype")


def quantize(x, qdt):
    """Symmetric per-last-axis quantization: ``x (..., D)`` ->
    ``(q (..., D) in qdt, scale (...) float32)`` with
    ``scale = amax / qmax`` so ``scale * q ~= x``.  All-zero rows get
    scale 0 and quantize to exact zeros.  int8 rounds half to even."""
    qmax = qmax_of(qdt)
    xf = x.float()
    scale = torch.amax(torch.abs(xf), dim=-1) / qmax
    q = xf / torch.where(scale > 0, scale, 1.0)[..., None]
    q = torch.clamp(q, -qmax, qmax)
    if qdt == torch.int8:
        q = torch.round(q)
    return q.to(qdt), scale


def dequantize(q, scale, dtype=torch.float32):
    """``scale * q`` with the scale broadcast over the trailing D axis."""
    return (q.float() * scale[..., None].float()).to(dtype)
