"""Fused paged verification: SPIN's packed Eq. (13) pass streaming K/V
straight from the paged block pool, one launch per attention layer.

``fused_paged_verify`` is the wrapper.  On a CPU tensor it runs the plain
version (:func:`fused_paged_verify_plain`: gather the live blocks into a
flat packed view, then direct masked attention).  On a CUDA tensor it
launches the hand-written kernel ``csrc/fused_verify.cu`` or raises; there
is no fallback on the card.  The kernel is the one of
``csrc/verify_runs.cuh`` that ``paged_attention.paged_verify_attention``
launches too, sized by the same plan (``paged_attention.verify_plan``): one
CTA per (segment tile, group of kv heads, chunk), bf16 queries on the
tensor cores.
"""

from __future__ import annotations

from repro_torch.kernels import paged_attention, ref

NAME = "fused_paged_verify"

# The plain version: gather the live blocks, then direct Eq. (13) attention.
fused_paged_verify_plain = ref.paged_verify_ref


def fused_paged_verify(q, k_pool, v_pool, pool_seg, pool_pos, q_seg, q_pos,
                       block_ids, block_owner, q_anc=None, block_node=None,
                       k_scale=None, v_scale=None, config=None, window=0):
    """Single-launch packed verification.

    q: (Tq, H, D); pools: (N, bs, Kh, D); pool_seg/pool_pos: (N, bs);
    q_seg/q_pos: (Tq,); block_ids/block_owner: (M,) live physical blocks and
    the segment owning each (-1 = padding entry, never read); optional tree
    topology q_anc (Tq,) / block_node (M, bs), indexed by gathered entry m;
    optional (N, bs, Kh) float32 scales for int8/fp8 pools; ``config``: a
    tuned ``autotune.FusedConfig`` over ``paged_attention.verify_plan`` (the
    plain version ignores it); ``window`` > 0 masks the slots at or before
    q_pos - window too (0: none).  Returns (Tq, H, D) in q's dtype.  On the
    card: one launch over (segment tile, kv head group, chunk), each CTA
    streaming its segment's blocks once; where the plan splits (long lists
    a query token), float32 partials merged by each tile's last chunk in
    the same launch."""
    if q.device.type == "cpu":
        return fused_paged_verify_plain(
            q, k_pool, v_pool, pool_seg, pool_pos, q_seg, q_pos, block_ids,
            block_owner, q_anc, block_node, k_scale, v_scale, window)
    return paged_attention.launch_verify(
        "fused_verify", NAME, q, k_pool, v_pool, pool_seg, pool_pos, q_seg,
        q_pos, block_ids, block_owner, q_anc, block_node, k_scale, v_scale,
        config, window)
