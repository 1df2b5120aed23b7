"""Build, load and bind the CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch headers:
a build takes seconds).  Libraries go to ``build/repro_torch_kernels/`` at
the root of the checkout, named by a hash of the sources and flags, so a
changed source is rebuilt and a stale library is never loaded.  The build
happens at first use; :func:`build_all` starts one ``nvcc`` per source, all
at once, and waits for them.

The wrappers (``fused_verify.py``, ``fused_decode.py``,
``verify_attention.py``, ``decode_attention.py``, ``paged_attention.py``,
``flash_attention.py``, ``moe_experts.py``) share the argument checks below and count their
launches in :data:`LAUNCHES`.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
KERNELS = ("fused_verify", "fused_decode", "verify_attention",
           "decode_attention", "paged_attention", "flash_attention",
           "moe_experts")
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
# calls of the packed verify (#1 fused_paged_verify, #4
# paged_verify_attention) whose plan split a segment's entries into chunks,
# so that the last chunk of a tile merges float32 partials
VERIFY_SPLITS = 0
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


def ptxas_entries(text: str) -> list:
    """Per kernel entry in ``nvcc -Xptxas -v`` output: its short name (the
    function name and the start of its template arguments, as mangled),
    registers, spill bytes (stores + loads) and static shared memory."""
    out, name, spill = [], None, 0
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            short = re.search(r"\d+([A-Za-z_]+_kernel)(\w{0,40})", name)
            smem = re.search(r"(\d+) bytes smem", ln)
            out.append(dict(
                entry="".join(short.groups()) if short else name[:48],
                registers=int(m.group(1)), spill_bytes=spill,
                static_smem=int(smem.group(1)) if smem else 0))
            name = None
    return out


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


def query_tile(tokens: int, group: int, other_ctas: int, sms: int) -> int:
    """Query tokens per CTA: as many as fit (MAX_ROWS rows of ``group``
    heads each) while the grid still has about two CTAs per SM; at short
    contexts the kernels are latency-bound, so more, smaller CTAs finish
    sooner.  ``other_ctas`` is the grid's size without the query axis."""
    fill = (tokens * other_ctas) // (2 * sms)
    return max(1, min(MAX_ROWS // group, fill))


# The tile pipeline of csrc/tile_pipeline.cuh (split fused_paged_decode,
# paged_verify_attention): 32-slot K/V tiles in shared memory, dealt to
# teams of warps, each team with its own stages of cp.async buffers.
KV_TILE = 32          # slots per tile: csrc/paged_common.cuh kTile
WARPS = 4             # kWarps
ROWS_PER_WARP = 4     # kRowsPerWarp
MAX_STAGES = 4
# shared memory of an SM (the H100's 228 KiB; a CTA may take 227) and the
# stage bytes a CTA may take at two CTAs per SM, with room for the queries
# and the block lists
SMEM_PER_SM = 228 * 1024
STAGE_BUDGET = 108 * 1024


def stage_bytes(D: int, kv_bytes: int) -> int:
    """One stage of tile_pipeline.cuh (``pipe::stage_bytes``): 32 K rows
    padded to an odd number of 16-byte chunks, 32 V rows in whole chunks,
    six 32-word tag arrays."""
    chunks = -(-D * kv_bytes // 16)
    k_row = chunks + (chunks % 2 == 0)
    return KV_TILE * 16 * (k_row + chunks) + 6 * KV_TILE * 4


def tile_pipeline(rows: int, tiles: int, D: int, kv_bytes: int, ctas: int,
                  sms: int, wpt: int = 0, stages: int = 0):
    """(warps per team, stages per team) for a grid of ``ctas`` CTAs of
    ``rows`` query rows over at most ``tiles`` 32-slot tiles each.  A team
    has as many warps as it takes to give each at most one row (up to all
    four): a warp with one row runs the short code (csrc/tile_pipeline.cuh,
    ``Rows<1>``), measured faster on the H100 than more teams whose warps
    score several rows each.  Each team gets as many stages as its share of
    the tiles needs, up to :data:`MAX_STAGES` and a byte budget:
    :data:`STAGE_BUDGET` (two CTAs per SM), less where the grid needs three
    or four CTAs per SM to be resident at once; at least one.  A nonzero ``wpt`` or ``stages`` (a tuned config's,
    ``autotune.FusedConfig``) replaces the rule's; one the kernel cannot
    launch raises ``ValueError``: a team size other than 1, 2 or 4, more
    than :data:`ROWS_PER_WARP` rows a warp, more than :data:`MAX_STAGES`
    stages, or more than one stage over :data:`STAGE_BUDGET` (the budget at
    two CTAs per SM, whatever the grid: a config that launches at one call
    launches at every call)."""
    if wpt:
        if wpt not in (1, 2, WARPS) or rows > ROWS_PER_WARP * wpt:
            raise ValueError(f"{wpt} warps a team cannot hold {rows} query "
                             f"rows (1, 2 or {WARPS} warps, at most "
                             f"{ROWS_PER_WARP} rows a warp)")
    else:
        wpt = 1 if rows <= 1 else (2 if rows <= 2 else WARPS)
    teams = WARPS // wpt
    per_stage = teams * stage_bytes(D, kv_bytes)
    if stages:
        if stages > MAX_STAGES or stages * per_stage > max(per_stage,
                                                           STAGE_BUDGET):
            raise ValueError(
                f"{stages} stages of {teams} teams take {stages * per_stage}"
                f" bytes of shared memory; the budget is {STAGE_BUDGET} "
                f"(at most {MAX_STAGES} stages)")
        return wpt, stages
    per_sm = max(2, min(4, -(-ctas // sms)))
    budget = min(STAGE_BUDGET, SMEM_PER_SM // per_sm - 3 * 1024)
    need = max(1, -(-tiles // teams))
    return wpt, max(1, min(MAX_STAGES, need, budget // per_stage))


# Per (device, stream): int32 counters of the split kernels' in-launch
# merge (the last CTA of a group merges and resets its own counter to 0),
# zero between calls; calls on one stream are ordered, so the kernels of
# one stream share them.  Grown on demand.
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def merge_counters(device, stream: int, n: int) -> torch.Tensor:
    key = (device.index or 0, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[key] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                           device=device)
    return buf


def run_scratch(runs: int, rows: int, H: int, D: int, groups: int, device,
                stream: int):
    """(pm, pl, pacc, counters) of a split kernel's in-launch merge: the
    float32 partials pm, pl (runs, rows, H) and pacc (runs, rows, H, D),
    and :func:`merge_counters` for ``groups`` merging groups; four Nones
    with one run (its CTAs write the output, nothing merges)."""
    if runs == 1:
        return None, None, None, None
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty((runs, rows, H), **f32),
            torch.empty((runs, rows, H), **f32),
            torch.empty((runs, rows, H, D), **f32),
            merge_counters(device, stream, groups))


_SMS: Dict[int, int] = {}


def sm_count(device) -> int:
    idx = device.index if device.index is not None else 0
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc} "
                           f"({torch.cuda.get_device_name()})")


def check_tensor(name, t, shape, dtypes, device):
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
        check_tensor(name, t, shape, (torch.int32,), device)


def check_heads(q, k):
    """Device and head geometry of a query / key pair (heads on axis -2,
    head dim last)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {dev}")
    H, Kh, D = q.shape[-2], k.shape[-2], k.shape[-1]
    if q.shape[-1] != D or D > MAX_D or H % Kh:
        raise ValueError(f"unsupported head geometry H={H} Kh={Kh} D={D} "
                         f"(q head dim {q.shape[-1]}, D <= {MAX_D})")
    if (H // Kh) > MAX_ROWS:
        raise ValueError(f"GQA group {H // Kh} exceeds {MAX_ROWS} rows/CTA")
    check_tensor("q", q, q.shape, tuple(Q_CODES), dev)


def check_dense(q, k, v, k_shape):
    """Checks of the dense kernels (float K/V, no scales); returns (q dtype
    code, kv code)."""
    check_heads(q, k)
    check_tensor("k", k, k_shape, (torch.float32, torch.bfloat16),
                 q.device)
    check_tensor("v", v, k_shape, (k.dtype,), q.device)
    return Q_CODES[q.dtype], KV_CODES[k.dtype]


def check_pools(q, k_pool, v_pool, pool_seg, pool_pos, k_scale, v_scale):
    """Checks shared by the paged kernels; returns (q dtype code, kv
    code).  ``pool_seg``/``pool_pos`` may be None (paged decode)."""
    check_heads(q, k_pool)
    dev = q.device
    N, bs, Kh, D = k_pool.shape
    check_tensor("k_pool", k_pool, (N, bs, Kh, D), tuple(KV_CODES), dev)
    check_tensor("v_pool", v_pool, (N, bs, Kh, D), (k_pool.dtype,),
                 dev)
    check_int("pool_seg", pool_seg, (N, bs), dev)
    check_int("pool_pos", pool_pos, (N, bs), dev)
    quantized = k_pool.dtype in (torch.int8, torch.float8_e4m3fn)
    if quantized != (k_scale is not None) or (k_scale is None) != (
            v_scale is None):
        raise ValueError("int8/fp8 pools need k_scale and v_scale; "
                         "float pools take none")
    if quantized:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            check_tensor(name, t, (N, bs, Kh), (torch.float32,), dev)
    return Q_CODES[q.dtype], KV_CODES[k_pool.dtype]
