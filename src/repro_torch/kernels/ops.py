"""Public wrappers for the port's kernels, with the reference's ``ops``
signatures.  Each dispatches on the tensors' device: the plain PyTorch
version on the CPU, the CUDA kernel on the card.  The fused kernels take a
tuned tile config (``config``, an ``autotune.FusedConfig``; None = the
kernel's own plan) on to their launch; the other tile arguments (``bq``,
``bk``) are the reference's TPU tiles, accepted and ignored: those kernels
plan their own launch.  Every Pallas kernel of the reference has its CUDA
kernel here; ``moe_experts`` (the serving path's dropless experts) has a
CUDA kernel and no Pallas original.
"""

from __future__ import annotations

from repro_torch.kernels.decode_attention import decode_attention as _dense
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.fused_decode import fused_paged_decode as _decode
from repro_torch.kernels.fused_verify import fused_paged_verify as _verify
from repro_torch.kernels.moe_experts import moe_experts as _experts
from repro_torch.kernels.paged_attention import (
    paged_decode_attention as _paged_decode,
    paged_verify_attention as _paged_verify)
from repro_torch.kernels.verify_attention import verify_attention as _packed


def verify_attention(q, k, v, q_seg, q_pos, kv_seg, kv_pos, q_anc=None,
                     kv_node=None, *, bq: int = 128, bk: int = 128):
    """Dense packed verification over a flat tagged KV buffer
    (kernels/verify_attention.py); optional tree topology q_anc/kv_node."""
    return _packed(q, k, v, q_seg, q_pos, kv_seg, kv_pos, q_anc, kv_node)


def flash_attention(q, k, v, *, window: int = 0, bq: int = 128,
                    bk: int = 128):
    """Causal prefill attention, optional sliding window, GQA
    (kernels/flash_attention.py)."""
    return _flash(q, k, v, window=window)


def decode_attention(q, k, v, lengths, *, bk=None):
    """Dense GQA decode (kernels/decode_attention.py).  As in the
    reference, an explicit ``bk`` must divide the cache length S: a cache
    is allocated aligned instead of pad-copied per step."""
    S = k.shape[1]
    if bk is not None and S % bk:
        raise ValueError(
            f"KV length {S} is not a multiple of bk={bk}; allocate the "
            f"cache block-aligned (or pick bk dividing S) instead of "
            f"paying a full-cache pad copy per step")
    return _dense(q, k, v, lengths)


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths,
                           k_scale=None, v_scale=None):
    """One-token paged decode (kernels/paged_attention.py)."""
    return _paged_decode(q, k_pool, v_pool, block_tables, lengths, k_scale,
                         v_scale)


def paged_verify_attention(q, k_pool, v_pool, pool_seg, pool_pos, q_seg,
                           q_pos, block_ids, block_owner, k_scale=None,
                           v_scale=None, *, bq: int = 128, q_anc=None,
                           block_node=None, window: int = 0):
    """Unfused paged packed verification, split-KV
    (kernels/paged_attention.py); optional tree topology
    q_anc/block_node; ``window`` > 0 a sliding window."""
    return _paged_verify(q, k_pool, v_pool, pool_seg, pool_pos, q_seg, q_pos,
                         block_ids, block_owner, q_anc, block_node, k_scale,
                         v_scale, window)


def fused_paged_verify(q, k_pool, v_pool, pool_seg, pool_pos, q_seg, q_pos,
                       block_ids, block_owner, q_anc=None, block_node=None,
                       k_scale=None, v_scale=None, *, config=None,
                       window: int = 0):
    """Single-launch packed verification (kernels/fused_verify.py);
    ``window`` > 0 a sliding window."""
    return _verify(q, k_pool, v_pool, pool_seg, pool_pos, q_seg, q_pos,
                   block_ids, block_owner, q_anc, block_node, k_scale,
                   v_scale, config, window)


def fused_paged_decode(q, k_pool, v_pool, pool_seg, pool_pos, q_seg, q_pos,
                       block_tables, k_scale=None, v_scale=None, *,
                       config=None, window: int = 0):
    """Single-launch multi-token paged decode (kernels/fused_decode.py);
    ``window`` > 0 a sliding window."""
    return _decode(q, k_pool, v_pool, pool_seg, pool_pos, q_seg, q_pos,
                   block_tables, k_scale, v_scale, config, window)


def moe_experts(x, ids, weights, w_gate, w_up, w_down):
    """Dropless routed experts: each token's weighted sum of its experts'
    SwiGLU (kernels/moe_experts.py)."""
    return _experts(x, ids, weights, w_gate, w_up, w_down)
