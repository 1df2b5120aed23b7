"""Public wrappers for the port's kernels.

Each takes the reference's ``config`` keyword (a ``autotune.FusedConfig``;
the CUDA kernels fix their own tiles, see ``autotune.py``) and dispatches on
the tensors' device: the plain PyTorch version on the CPU, the CUDA kernel
on the card.  The other Pallas kernels of the reference (flash, paged,
verify and decode attention) are queued in ROADMAP Queue 2.
"""

from __future__ import annotations

from repro_torch.kernels.fused_decode import fused_paged_decode as _decode
from repro_torch.kernels.fused_verify import fused_paged_verify as _verify


def fused_paged_verify(q, k_pool, v_pool, pool_seg, pool_pos, q_seg, q_pos,
                       block_ids, block_owner, q_anc=None, block_node=None,
                       k_scale=None, v_scale=None, *, config=None):
    """Single-launch packed verification (kernels/fused_verify.py)."""
    return _verify(q, k_pool, v_pool, pool_seg, pool_pos, q_seg, q_pos,
                   block_ids, block_owner, q_anc, block_node, k_scale,
                   v_scale)


def fused_paged_decode(q, k_pool, v_pool, pool_seg, pool_pos, q_seg, q_pos,
                       block_tables, k_scale=None, v_scale=None, *,
                       config=None):
    """Single-launch multi-token paged decode (kernels/fused_decode.py)."""
    return _decode(q, k_pool, v_pool, pool_seg, pool_pos, q_seg, q_pos,
                   block_tables, k_scale, v_scale)
