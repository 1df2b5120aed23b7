"""Dense packed verification: SPIN's Eq. (13) over one flat KV buffer
whose slots carry (segment, position) tags and optional tree-node tags.

The dense KV layout's packed verify (``core/decompose.make_attn_override``)
calls it once per LLM layer on ``[packed KV ; new KV]``.
``verify_attention`` is the wrapper.  On a CPU tensor it runs the plain
version (:func:`verify_attention_plain`: masked attention over the whole
buffer).  On a CUDA tensor it launches the hand-written kernels of
``csrc/verify_attention.cu`` (split-KV partials over runs of 32-slot
tiles, then their merge; :func:`split_plan` sizes the grid) or raises;
there is no fallback on the card.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, ref

NAME = "verify_attention"
KV_TILE = build.KV_TILE
TAG_GROUP = 4      # tiles whose tags a CTA reads in one pass (kWarps)
MAX_RUNS = 32      # runs per call: bounds the float32 partials' scratch
CTAS_PER_SM = 8    # most CTAs read one round of tags and exit

# The plain version: direct masked attention over the flat buffer.
verify_attention_plain = ref.verify_attention_ref


def split_plan(Tq: int, G: int, Kh: int, Tkv: int, sms: int):
    """(query tokens per CTA, tiles per run, runs) of one call.  A run is at
    least one pass of :data:`TAG_GROUP` tiles, and there are at most
    :data:`MAX_RUNS`; every tile lies in exactly one run and no run is
    empty.  The query tile is as small as keeps about
    :data:`CTAS_PER_SM` CTAs per SM (at most ``build.MAX_ROWS // G``
    tokens): the kernel is latency-bound and a CTA's rows are scored one
    after another per warp."""
    tiles = -(-Tkv // KV_TILE)
    per_run = max(TAG_GROUP, -(-tiles // MAX_RUNS))
    runs = -(-tiles // per_run)
    ctas = Kh * max(runs, 1)
    bq = max(1, min(build.MAX_ROWS // G, Tq * ctas // (CTAS_PER_SM * sms)))
    return bq, per_run, runs


def _c_fn():
    fn = build.load("verify_attention").spin_verify_attention
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 13 + [i] * 10 + [ctypes.c_float, p]
    fn.restype = i
    return fn


def verify_attention(q, k, v, q_seg, q_pos, kv_seg, kv_pos, q_anc=None,
                     kv_node=None):
    """Packed verification over a flat tagged buffer.

    q: (Tq, H, D); k, v: (Tkv, Kh, D); q_seg/q_pos: (Tq,) (seg -1 = padding
    query, zero output); kv_seg/kv_pos: (Tkv,) (seg -1 = padding cell,
    never attended); optional tree topology q_anc (Tq,) ancestor bitmask /
    kv_node (Tkv,) node tag (-1 always, < -1 never, n >= 0 iff bit n of
    q_anc).  A query attends slot j iff the segments are equal,
    kv_pos <= q_pos and the tree term holds.  Returns (Tq, H, D) in q's
    dtype.  On the card: a partial kernel over (query tile, kv head, run of
    tiles) into float32 scratch, then a merge kernel; one count in
    :data:`build.LAUNCHES` per call."""
    if q.device.type == "cpu":
        return verify_attention_plain(q, k, v, q_seg, q_pos, kv_seg, kv_pos,
                                      q_anc, kv_node)
    if (q_anc is None) != (kv_node is None):
        raise ValueError("q_anc and kv_node come together")
    Tq, H, D = q.shape
    Tkv, Kh = k.shape[0], k.shape[1]
    q_code, kv_code = build.check_dense(q, k, v, (Tkv, Kh, D))
    for name, t, n in (("q_seg", q_seg, Tq), ("q_pos", q_pos, Tq),
                       ("q_anc", q_anc, Tq), ("kv_seg", kv_seg, Tkv),
                       ("kv_pos", kv_pos, Tkv), ("kv_node", kv_node, Tkv)):
        build.check_int(name, t, (n,), q.device)
    bq, per_run, runs = split_plan(Tq, H // Kh, Kh, Tkv,
                                   build.sm_count(q.device))
    f32 = dict(dtype=torch.float32, device=q.device)
    pm = torch.empty((runs, Tq, H), **f32)
    pl = torch.empty((runs, Tq, H), **f32)
    pacc = torch.empty((runs, Tq, H, D), **f32)
    out = torch.empty_like(q)
    ptr = build.ptr
    rc = _c_fn()(
        ptr(q), ptr(k), ptr(v), ptr(q_seg), ptr(q_pos), ptr(q_anc),
        ptr(kv_seg), ptr(kv_pos), ptr(kv_node), ptr(pm), ptr(pl), ptr(pacc),
        ptr(out), Tq, Tkv, H, Kh, D, bq, per_run, runs, q_code, kv_code,
        1.0 / math.sqrt(D), build.stream_of(q))
    build.raise_on(rc, NAME)
    build.LAUNCHES[NAME] += 1
    return out
