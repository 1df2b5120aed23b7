"""The yardstick: the H100's peaks, a kernel call's bytes and operations
and the device's busy time in a trace (model FLOPs: ``arch/<name>.py``).

``device_time``, ``verify_work``, ``decode_work`` and ``bound`` are frozen
copies of ``chip_smoke.py`` at commit
43decebb2791135c201d6c4c7b06b63dd5d77887 (``device_time`` here also leaves
out the profiler's own annotations, which are spans and not device work).
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet, dense rates
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
            torch.float32: 67e12}
PEAK_BF16 = 989e12

# names of host-side annotations the profiler also shows on the device,
# which are spans and not device work
ANNOTATIONS = ("h100bench::", "ProfilerStep")


def _kv_slot_bytes(a, Kh, D):
    per = Kh * D * a["k_pool"].element_size() * 2 + 8      # K, V, seg, pos
    return per + (Kh * 8 if a.get("k_scale") is not None else 0)


def verify_work(a):
    """(bytes, operations) ``fused_paged_verify`` needs on these inputs:
    the live blocks' K/V (+ scales, seg, pos) once, the query side and the
    block list once, the output once; 4 D ops per (query head, attended
    slot), slots counted per segment."""
    Tq, H, D = a["q"].shape
    bs, Kh = a["k_pool"].shape[1], a["k_pool"].shape[2]
    M = a["block_ids"].shape[0]
    owner = a["block_owner"].cpu()
    live = owner >= 0
    nbytes = (int(live.sum()) * bs * _kv_slot_bytes(a, Kh, D) + M * 8
              + Tq * 4 * (3 if a.get("q_anc") is not None else 2)
              + (M * bs * 4 if a.get("block_node") is not None else 0)
              + 2 * a["q"].numel() * a["q"].element_size())
    per_seg = torch.bincount(owner[live].long(),
                             minlength=int(a["q_seg"].max()) + 2) * bs
    qs = a["q_seg"].cpu().long()
    slots = int(per_seg[qs[qs >= 0]].sum())
    return nbytes, 4 * D * H * slots


def decode_work(a):
    """(bytes, operations) ``fused_paged_decode`` needs: the unique blocks
    of the tables once, the tables, the query side and the output once; 4 D
    ops per (query head, query token, allocated slot of its row)."""
    B, T, H, D = a["q"].shape
    bs, Kh = a["k_pool"].shape[1], a["k_pool"].shape[2]
    bt = a["block_tables"].cpu()
    uniq = torch.unique(bt[bt >= 0]).numel()
    nbytes = (uniq * bs * _kv_slot_bytes(a, Kh, D) + bt.numel() * 4
              + B * T * 8 + 2 * a["q"].numel() * a["q"].element_size())
    slots = int((bt >= 0).sum()) * bs
    return nbytes, 4 * D * H * T * slots


def bound(nbytes, ops, dtype):
    """The least time of a call in ms, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def device_time(spans):
    """The device's busy time in ms (the union of the intervals of every
    kernel, copy and memset it ran) and the device ms and calls per
    name."""
    busy, end, per = 0.0, float("-inf"), {}
    for s, e, name in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
        us, n = per.get(name, (0.0, 0))
        per[name] = (us + e - s, n + 1)
    return busy / 1e3, {k: (us / 1e3, n) for k, (us, n) in per.items()}


def idle_gaps(spans, t0, t1):
    """(start us, end us) of the gaps in [t0, t1] where no device work
    ran."""
    gaps, cur = [], t0
    for s, e, _ in spans:
        if s > cur:
            gaps.append((cur, min(s, t1)))
        cur = max(cur, e)
        if cur >= t1:
            break
    if cur < t1:
        gaps.append((cur, t1))
    return [(a, b) for a, b in gaps if b > a]
