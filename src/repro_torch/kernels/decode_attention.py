"""Dense GQA decode: one query token per row against a (B, S, Kh, D)
cache, slots at or past ``lengths[b]`` masked.

``decode_attention`` is the wrapper, public through
``kernels.ops.decode_attention``.  On a CPU tensor it runs the plain version
(:func:`decode_attention_plain`).  On a CUDA tensor it launches the
hand-written kernel ``csrc/decode_attention.cu`` or raises; there is no
fallback on the card.  The kernel splits each row over runs of 32-slot
tiles (:func:`run_plan`), the last live run of a row merging the others'
partials in the same launch; it is the run-of-tiles kernel of
``csrc/decode_runs.cuh``, which ``paged_attention.paged_decode_attention``
runs over a block pool with the same plan.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, ref

NAME = "decode_attention"

# The plain version: masked attention over each row's cache.
decode_attention_plain = ref.decode_attention_ref

RUN_CTAS_PER_SM = 2
MAX_RUNS = 32        # bounds the float32 partials' scratch


def run_plan(B: int, S: int, G: int, Kh: int, D: int, kv_bytes: int,
             sms: int):
    """(tiles per run, runs, warps per team, stages) of one call over a
    (B, S, Kh, D) cache, one CTA per (row, kv head, run).  The runs cut
    the ``ceil(S / 32)`` tiles of a row (the host knows no length: a run
    past a row's live prefix exits at once on the card) and bring the grid
    to about :data:`RUN_CTAS_PER_SM` CTAs per SM, at most :data:`MAX_RUNS`
    of them; every tile lies in exactly one run and no run is empty (S =
    0: one empty run, which writes zeros).  Teams and stages are
    :func:`build.tile_pipeline`'s for the G query rows.  The paged decode
    takes the same plan at S = NB * bs."""
    tiles = max(1, -(-S // build.KV_TILE))
    base = B * Kh
    want = max(1, round(RUN_CTAS_PER_SM * sms / base))
    per_run = -(-tiles // min(want, MAX_RUNS, tiles))
    runs = -(-tiles // per_run)
    wpt, stages = build.tile_pipeline(G, per_run, D, kv_bytes, base * runs,
                                      sms)
    return per_run, runs, wpt, stages


def _c_fn():
    fn = build.load("decode_attention").spin_decode_attention
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 9 + [i] * 11 + [ctypes.c_float, p]
    fn.restype = i
    return fn


def decode_attention(q, k, v, lengths):
    """q: (B, H, D); k, v: (B, S, Kh, D); lengths: (B,) int32 live prefix
    per row.  Returns (B, H, D) in q's dtype; a row of length 0 gives
    zeros.  On the card: one launch over (row, kv head, run of tiles);
    one count in :data:`build.LAUNCHES` per call."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lengths)
    B, H, D = q.shape
    S, Kh = k.shape[1], k.shape[2]
    q_code, kv_code = build.check_dense(q, k, v, (B, S, Kh, D))
    build.check_int("lengths", lengths, (B,), q.device)
    per_run, runs, wpt, stages = run_plan(
        B, S, H // Kh, Kh, D, k.element_size(), build.sm_count(q.device))
    stream = build.stream_of(q)
    pm, pl, pacc, counters = build.run_scratch(runs, B, H, D, B * Kh,
                                               q.device, stream)
    out = torch.empty_like(q)
    ptr = build.ptr
    rc = _c_fn()(ptr(q), ptr(k), ptr(v), ptr(lengths), ptr(pm), ptr(pl),
                 ptr(pacc), ptr(counters), ptr(out), B, S, H, Kh, D, per_run,
                 runs, wpt, stages, q_code, kv_code, 1.0 / math.sqrt(D),
                 stream)
    build.raise_on(rc, NAME)
    build.LAUNCHES[NAME] += 1
    return out
