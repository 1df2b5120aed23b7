"""Build, load and bind the CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch headers:
a build takes seconds).  Libraries go to ``build/repro_torch_kernels/`` at
the root of the checkout, named by a hash of the sources and flags, so a
changed source is rebuilt and a stale library is never loaded.  The build
happens at first use; :func:`build_all` starts one ``nvcc`` per source, all
at once, and waits for them.

The wrappers (``fused_verify.py``, ``fused_decode.py``) share the argument
checks below and count their launches in :data:`LAUNCHES`.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
KERNELS = ("fused_verify", "fused_decode")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# query rows (GQA heads x query tokens) one CTA holds: paged_common.cuh
MAX_ROWS = 16
MAX_D = 128
# dtype codes shared with paged_common.cuh (enum DType)
Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
            torch.float8_e4m3fn: 3}

# kernel launches per wrapper name; each wrapper adds one where it launches
LAUNCHES: collections.Counter = collections.Counter()
# per-kernel build record: {"seconds": wall seconds, "ptxas": compiler notes}
BUILD_LOG: Dict[str, dict] = {}
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every kernel in ``names`` (default: all) that has no
    up-to-date library, one ``nvcc`` process per source, in parallel.
    Raises with the compiler's output if any build fails."""
    names = list(KERNELS if names is None else names)
    procs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            BUILD_LOG.setdefault(name, {"seconds": 0.0, "ptxas": "cached"})
            continue
        cmd = [nvcc(), *NVCC_FLAGS, "-o"]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd += [tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target, time.perf_counter())
    errors = []
    for name, (proc, tmp, target, t0) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0, "ptxas": out}
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {name}.cu:\n{out}")
        else:
            os.replace(tmp, target)
    if errors:
        raise RuntimeError("\n".join(errors))
    return BUILD_LOG


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        if not library_path(name).exists():
            build_all([name])
        lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
    return lib


# ------------------------------------------------------------- binding --

def ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream_of(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def query_tile(tokens: int, group: int, other_ctas: int, device) -> int:
    """Query tokens per CTA: as many as fit (MAX_ROWS rows of ``group``
    heads each) while the grid still has about two CTAs per SM; at short
    contexts the kernels are latency-bound, so more, smaller CTAs finish
    sooner.  ``other_ctas`` is the grid's size without the query axis."""
    sms = _sm_count(device)
    fill = (tokens * other_ctas) // (2 * sms)
    return max(1, min(MAX_ROWS // group, fill))


_SMS: Dict[int, int] = {}


def _sm_count(device) -> int:
    idx = device.index if device.index is not None else 0
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc} "
                           f"({torch.cuda.get_device_name()})")


def _check(name, t, shape, dtypes, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of "
                         f"{sorted(str(d) for d in dtypes)}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_int(name, t, shape, device):
    """An optional int32 index/tag tensor (None passes)."""
    if t is not None:
        _check(name, t, shape, (torch.int32,), device)


def check_pools(q, k_pool, v_pool, pool_seg, pool_pos, k_scale, v_scale):
    """Checks shared by both kernels; returns (q dtype code, kv code)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {dev}")
    N, bs, Kh, D = k_pool.shape
    H = q.shape[-2]
    if q.shape[-1] != D or D > MAX_D or H % Kh:
        raise ValueError(f"unsupported head geometry H={H} Kh={Kh} D={D} "
                         f"(q head dim {q.shape[-1]}, D <= {MAX_D})")
    if (H // Kh) > MAX_ROWS:
        raise ValueError(f"GQA group {H // Kh} exceeds {MAX_ROWS} rows/CTA")
    _check("q", q, q.shape, tuple(Q_CODES), dev)
    _check("k_pool", k_pool, (N, bs, Kh, D), tuple(KV_CODES), dev)
    _check("v_pool", v_pool, (N, bs, Kh, D), (k_pool.dtype,), dev)
    check_int("pool_seg", pool_seg, (N, bs), dev)
    check_int("pool_pos", pool_pos, (N, bs), dev)
    quantized = k_pool.dtype in (torch.int8, torch.float8_e4m3fn)
    if quantized != (k_scale is not None) or (k_scale is None) != (
            v_scale is None):
        raise ValueError("int8/fp8 pools need k_scale and v_scale; "
                         "float pools take none")
    if quantized:
        _check("k_scale", k_scale, (N, bs, Kh), (torch.float32,), dev)
        _check("v_scale", v_scale, (N, bs, Kh), (torch.float32,), dev)
    return Q_CODES[q.dtype], KV_CODES[k_pool.dtype]
