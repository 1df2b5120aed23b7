"""Decoder-only LM assembly for every architecture family of the registry.

Parameters are a dict: ``embed`` (token inputs), ``lm_head`` (unless tied),
``final_norm``, ``layers`` — one block dict per application, in the order
of :func:`block_kinds` (the reference stacks each unit position for
``lax.scan``; here the stack is a Python loop) — and ``shared_attn``, the
weights every ``SHARED_ATTN`` application reuses (its ``ln1`` is private).

Caches are one dict of layer-stacked tensors.  The attention-bearing
blocks (``ATTN``, ``MOE``, ``SHARED_ATTN``, in application order) share
``k``/``v`` ``(L_attn, B, S, Kh, hd)`` plus per-slot absolute positions
and segment ids ``pos``/``seg`` ``(L_attn, B, S)`` (-1 = empty slot).
Paged pools use the same leaves with ``(L_attn, num_blocks, block_size,
...)`` axes and, for quantized storage, ``k_scale``/``v_scale``.
Recurrent blocks keep their state in entries of their own, stacked over
the blocks of that kind: ``ssd``/``conv`` (Mamba2), ``mlstm_C``/
``mlstm_n`` (mLSTM), ``slstm_c``/``_n``/``_h``/``_m`` (sLSTM).  Every
cache write updates the stacked tensors **in place** (the reference is
functional) and the entry points return the same dict for symmetry with
the reference.

Entry points
  apply(...)               full-sequence forward, no cache
  prefill(...)             forward + cache construction
  decode_step(...)         T new tokens per row against a cache
  verify_step_packed(...)  SPIN packed verification through an override
  loss_fn / make_train_step  training (plain autograd), ``Opts.remat``
                             checkpointing each unit of the block stack
"""

from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Any, Dict

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.distributed.sharding import (constrain, is_dtensor,
                                              on_shards, shard_write)
from repro_torch.kernels import quant
from repro_torch.models import config as C
from repro_torch.models import mamba2, moe, xlstm
from repro_torch.models import params as pp
from repro_torch.models.layers import (attention, embed, rms_norm, rope,
                                       softmax_cross_entropy, swiglu)
from repro_torch.models.params import P
from repro_torch.serving import trace

ATTN_KINDS = (C.ATTN, C.MOE, C.SHARED_ATTN)
ATTN_LEAVES = ("k", "v", "pos", "seg", "k_scale", "v_scale")


REMAT = ("full", "dots", "none")


@dataclasses.dataclass(frozen=True)
class Opts:
    q_block: int = 512  # query-block size of chunked attention
    ssd_chunk: int = 128  # mamba2 / mlstm chunk length
    # activation checkpointing of each unit of the block stack, training
    # only (a forward without a cache, under autograd):
    # "full" recomputes the unit in the backward, "dots" keeps its matmul
    # outputs (aten.mm, the analogue of the reference's
    # dots_with_no_batch_dims_saveable) and recomputes the rest
    remat: str = "full"
    # every cache write of a step lands in range (the caller's promise, as
    # the dry-run's cells make: a prompt, or a decode step within the
    # cache): :func:`write_index` keeps the whole (B, T) grid without
    # reading the positions, the one form a run on shapes alone can take;
    # an index out of range then raises at the write
    writes_in_range: bool = False

    def __post_init__(self):
        if self.remat not in REMAT:
            raise ValueError(f"unknown remat {self.remat!r} "
                             f"(choose from {', '.join(REMAT)})")


def _remat_context(remat: str):
    if remat == "dots":
        return functools.partial(
            ckpt.create_selective_checkpoint_contexts,
            [torch.ops.aten.mm.default, torch.ops.aten.addmm.default])
    return ckpt.noop_context_fn


def block_kinds(cfg: C.ModelConfig):
    """The kind of every block application, in order."""
    return list(cfg.unit) * cfg.n_units + list(cfg.tail)


def _group(kind: str) -> str:
    """Blocks of one group share cache entries: the attention kinds share
    one stack, each recurrent kind has its own."""
    return "attn" if kind in ATTN_KINDS else kind


def cache_slots(cfg: C.ModelConfig):
    """Per block application, its index among its group's blocks."""
    seen: Dict[str, int] = collections.Counter()
    out = []
    for kind in block_kinds(cfg):
        out.append(seen[_group(kind)])
        seen[_group(kind)] += 1
    return out


# ------------------------------------------------------------- param spec --

def _attn_spec(cfg: C.ModelConfig, is_moe: bool) -> Dict[str, Any]:
    d, hd = cfg.d_model, cfg.hd
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    s: Dict[str, Any] = {
        "ln1": P((d,), ("embed",), init="zeros"),
        "wq": P((d, nq, hd), ("embed", "heads", "head_dim")),
        "wk": P((d, nkv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": P((d, nkv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": P((nq, hd, d), ("heads", "head_dim", "embed")),
        "ln2": P((d,), ("embed",), init="zeros"),
    }
    if cfg.qkv_bias:
        s["bq"] = P((nq, hd), ("heads", "head_dim"), init="zeros")
        s["bk"] = P((nkv, hd), ("kv_heads", "head_dim"), init="zeros")
        s["bv"] = P((nkv, hd), ("kv_heads", "head_dim"), init="zeros")
    if cfg.gated:
        s["q_norm"] = P((hd,), ("head_dim",), init="zeros")
        s["k_norm"] = P((hd,), ("head_dim",), init="zeros")
        s["wg"] = P((d, nq, hd), ("embed", "heads", "head_dim"))
        s["ln1_out"] = P((d,), ("embed",), init="zeros")
        s["ln2_out"] = P((d,), ("embed",), init="zeros")
    if is_moe:
        E = cfg.n_experts
        s["router"] = P((d, E), ("embed", None), scale=0.02)
        if cfg.router == "sigmoid":
            s["expert_bias"] = P((E,), (None,), init="zeros")
        s["w_gate"] = P((E, d, cfg.d_ff), ("experts", "exp_embed", "mlp"))
        s["w_up"] = P((E, d, cfg.d_ff), ("experts", "exp_embed", "mlp"))
        s["w_down"] = P((E, cfg.d_ff, d), ("experts", "mlp", "exp_embed"))
        if cfg.n_shared_experts:
            fs = cfg.n_shared_experts * cfg.d_ff
            s["ws_gate"] = P((d, fs), ("embed", "mlp"))
            s["ws_up"] = P((d, fs), ("embed", "mlp"))
            s["ws_down"] = P((fs, d), ("mlp", "embed"))
    else:
        ff = cfg.dense_ff or cfg.d_ff
        s["w_gate"] = P((d, ff), ("embed", "mlp"))
        s["w_up"] = P((d, ff), ("embed", "mlp"))
        s["w_down"] = P((ff, d), ("mlp", "embed"))
    return s


def _block_spec(cfg: C.ModelConfig, kind: str):
    if kind in (C.ATTN, C.MOE):
        return _attn_spec(cfg, is_moe=kind == C.MOE)
    if kind == C.SHARED_ATTN:
        # the per-application norm is private; the weights are shared
        return {"ln1": P((cfg.d_model,), ("embed",), init="zeros")}
    if kind == C.MAMBA2:
        return mamba2.param_spec(cfg)
    if kind == C.MLSTM:
        return xlstm.mlstm_spec(cfg)
    if kind == C.SLSTM:
        return xlstm.slstm_spec(cfg)
    raise ValueError(kind)


def param_spec(cfg: C.ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    spec: Dict[str, Any] = {}
    if cfg.embed_inputs:
        spec["embed"] = P((cfg.padded_vocab, d), ("vocab", "embed"),
                          scale=0.02)
    if not cfg.tie_embeddings or not cfg.embed_inputs:
        spec["lm_head"] = P((d, cfg.padded_vocab), ("embed", "vocab"))
    spec["final_norm"] = P((d,), ("embed",), init="zeros")
    kinds = block_kinds(cfg)
    spec["layers"] = [_block_spec(cfg, kind) for kind in kinds]
    if C.SHARED_ATTN in kinds:
        spec["shared_attn"] = _attn_spec(cfg, is_moe=False)
    return spec


def abstract_params(cfg, dtype=None):
    """The parameter tree as ``meta`` tensors (shapes and dtypes, no
    memory)."""
    dtype = dtype or cfg.compute_dtype
    return pp.tree_map(lambda p: torch.empty(p.shape, dtype=dtype,
                                             device="meta"), param_spec(cfg))


def logical_axes(cfg):
    """Tree of logical-axis tuples, same structure as the param tree
    (each per-layer leaf's axes are the reference's stacked leaf's without
    the leading ``layers`` axis)."""
    return pp.tree_map(lambda p: p.axes, param_spec(cfg))


def init_params(cfg, seed: int = 0, dtype=None, device="cuda"):
    """Random parameters from ``seed`` (an explicit generator on
    ``device``)."""
    device = resolve_device(device)
    dtype = dtype or cfg.compute_dtype
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return pp.init_params(param_spec(cfg), gen, dtype, device)


def resolve_device(device) -> torch.device:
    """Entry points run on the card unless the caller asks for the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return device


# ------------------------------------------------------------------ cache --

def cache_len(cfg: C.ModelConfig, max_len: int) -> int:
    """Slots of a dense cache row: a sliding-window model keeps a ring
    buffer of the window tail."""
    if cfg.sliding_window:
        return min(max_len, cfg.sliding_window)
    return max_len


def init_cache(cfg, batch, max_len, device="cuda"):
    n = collections.Counter(_group(k) for k in block_kinds(cfg))
    Kh, hd = cfg.n_kv_heads, cfg.hd
    S = cache_len(cfg, max_len)
    dt, f32 = cfg.compute_dtype, torch.float32

    def stack(group, shape, dtype, fill=0):
        return torch.full((n[group],) + shape, fill, dtype=dtype,
                          device=device)

    cache = {}
    if n["attn"]:
        cache["k"] = stack("attn", (batch, S, Kh, hd), dt)
        cache["v"] = stack("attn", (batch, S, Kh, hd), dt)
        cache["pos"] = stack("attn", (batch, S), torch.int32, -1)
        cache["seg"] = stack("attn", (batch, S), torch.int32, -1)
    if n[C.MAMBA2]:
        nh, shd, ds = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        cache["ssd"] = stack(C.MAMBA2, (batch, nh, shd, ds), f32)
        cache["conv"] = stack(C.MAMBA2, (batch, cfg.conv_kernel - 1,
                                         cfg.d_inner + 2 * ds), dt)
    if n[C.MLSTM]:
        nh = cfg.n_heads
        dk = xlstm.PF_M * cfg.d_model // nh
        cache["mlstm_C"] = stack(C.MLSTM, (batch, nh, dk, dk), f32)
        cache["mlstm_n"] = stack(C.MLSTM, (batch, nh, dk), f32)
    if n[C.SLSTM]:
        nh = cfg.n_heads
        for leaf in "cnhm":
            cache["slstm_" + leaf] = stack(
                C.SLSTM, (batch, nh, cfg.d_model // nh), f32)
    return cache


def abstract_cache(cfg, batch, max_len):
    """:func:`init_cache`'s tree as ``meta`` tensors."""
    return init_cache(cfg, batch, max_len, device="meta")


# each cache leaf's logical axes after its leading group-stack axis
# ("layers", never named by a rule table): the reference's per-block axes
# (repro.models.transformer.cache_logical_axes)
_CACHE_AXES = {
    "k": ("cache_batch", "cache_seq", "kv_heads", "head_dim"),
    "v": ("cache_batch", "cache_seq", "kv_heads", "head_dim"),
    "pos": ("cache_batch", "cache_seq"),
    "seg": ("cache_batch", "cache_seq"),
    "ssd": ("cache_batch", "ssm_heads", None, None),
    "conv": ("cache_batch", None, "ssm_conv"),
}


def cache_leaf_axes(name: str, ndim: int):
    """Logical axes of the cache leaf ``name`` of rank ``ndim``: stacked
    over its group's blocks, so it starts with ``"layers"``; the recurrent
    states of mLSTM/sLSTM are (B, heads, ...)."""
    return ("layers",) + (_CACHE_AXES.get(name) or (
        ("cache_batch", "heads") + (None,) * (ndim - 3)))


def cache_logical_axes(cfg, batch, max_len):
    """Logical-axis tree matching :func:`abstract_cache` (consumed by
    ``distributed/sharding.sharding_tree``)."""
    return {name: cache_leaf_axes(name, leaf.dim())
            for name, leaf in abstract_cache(cfg, batch, max_len).items()}


def init_paged_cache(cfg, num_blocks, block_size, kv_dtype: str = "bf16",
                     device="cuda"):
    """Paged KV block pool: the ``init_cache`` dict with (physical block,
    slot-in-block) leading axes.  ``kv_dtype`` selects the block storage
    (kernels/quant.py): ``"bf16"`` keeps the compute dtype; ``"int8"`` /
    ``"fp8"`` store K/V quantized and add float32 ``k_scale``/``v_scale``
    sidecars ``(L_attn, num_blocks, block_size, Kh)``.  Attention-family
    models without the model-wide ring buffer only, as in the reference;
    per-layer windows (``cfg.layer_windows``) mask by position and keep
    every slot."""
    bad = set(block_kinds(cfg)) - set(ATTN_KINDS)
    if bad:
        raise ValueError(f"paged KV needs attention-only models; {cfg.name} "
                         f"has recurrent-state blocks {sorted(bad)}")
    if cfg.sliding_window:
        raise ValueError("paged KV does not support sliding-window ring "
                         "buffers (the window tail lives in the dense "
                         "layout)")
    cache = init_cache(cfg, num_blocks, block_size, device)
    qdt = quant.storage_dtype(kv_dtype)
    if qdt is None:
        return cache
    for leaf in ("k", "v"):
        shape = cache[leaf].shape
        cache[leaf] = torch.zeros(shape, dtype=qdt, device=device)
        cache[leaf + "_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                             device=device)
    return cache


def layer_view(cache, layer: int):
    """Views of attention block ``layer``'s cache leaves (writes land in
    place)."""
    return {name: t[layer] for name, t in cache.items()
            if name in ATTN_LEAVES}


def masked_write(dst, dst_idx, src):
    """``dst[dst_idx] = src`` along the leading axes.  The reference's
    scatters drop out-of-range indices; here the caller has already
    filtered them (see ``write_index``).  A cache laid out over a mesh (a
    DTensor) is written shard by shard (``sharding.shard_write``)."""
    if is_dtensor(dst):
        shard_write(dst, dst_idx, src)
    else:
        dst[dst_idx] = src.to(dst.dtype)


def write_index(write_idx, S: int, in_range: bool = False):
    """(batch rows, slots, source flat index) of the in-range writes of a
    (B, T) slot-index grid — computed once per forward and shared by every
    layer (the reference drops out-of-range scatter updates).
    ``in_range`` (``Opts.writes_in_range``): every write is in range, so
    all B x T are kept without a data-dependent filter."""
    B, T = write_idx.shape
    if in_range:
        src = torch.arange(B * T, device=write_idx.device)
        return (torch.div(src, T, rounding_mode="floor"),
                write_idx.reshape(-1).long(), src)
    ok = (write_idx >= 0) & (write_idx < S)
    with trace.sync():
        src = torch.nonzero(ok.reshape(-1)).squeeze(1)
    rows = torch.div(src, T, rounding_mode="floor")
    return rows, write_idx.reshape(-1)[src].long(), src


# ----------------------------------------------------------------- blocks --

def project_qkv(p, h, cfg, positions, rotary: bool = True):
    """An attention block's q (B, S, H, hd) and k, v (B, S, Kh, hd) from
    its normed input h (B, S, d): projections, QKV bias, the per-head q/k
    norms (``cfg.gated``), RoPE (unless ``rotary`` is False)."""
    B, S, d = h.shape

    def heads(w, n, name):
        # under a rule table the merged (heads x head_dim) dims of the
        # weight (gathered over its embed shards) and of the output are
        # laid out as the head count allows, so that the splits (the
        # output's here, the weight gradient's in the backward) are even
        w = constrain(w.reshape(d, -1), None, name, shape=(d, n))
        y = constrain(h @ w, "batch", "seq", name, shape=(B, S, n))
        return y.reshape(B, S, n, cfg.hd)

    q = heads(p["wq"], cfg.n_heads, "heads")
    k = heads(p["wk"], cfg.n_kv_heads, "kv_heads")
    v = heads(p["wv"], cfg.n_kv_heads, "kv_heads")
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.gated:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if rotary:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attn_block(p, x, cfg, opts, *, layer, positions, segments, kv_cache,
                widx, is_moe, attend_cache=True, attn_override=None):
    """One pre-norm attention + SwiGLU (or MoE) block, block application
    ``layer`` (its window and rotary choice).  Returns (x_out, (moe_aux,
    moe_z)).  A serving forward (a cache or an override) runs an MoE
    dropless (``moe.dropless``); a training forward runs the
    capacity-bounded ``moe.moe_ffn`` (softmax routers; a sigmoid router
    runs dropless there too).

    kv_cache None              -> attend in-sequence, no cache
    kv_cache, attend_cache=F   -> prefill: write K/V into the cache grid but
                                  attend over the in-sequence K/V
    kv_cache, attend_cache=T   -> decode: write at ``widx`` slots (from
                                  :func:`write_index`), attend the grid
    attn_override              -> handles attention + cache write-back
                                  (paged and packed-verify paths)
    """
    B, S, d = x.shape
    h = rms_norm(x, p["ln1"], cfg.norm_eps).to(cfg.compute_dtype)
    q, k, v = project_qkv(p, h, cfg, positions, cfg.rotary(layer))
    window = cfg.window(layer)
    segs = (segments if segments is not None
            else torch.zeros((B, S), dtype=torch.int32, device=x.device))
    if attn_override is not None:
        o, _ = attn_override(q, k, v, positions, segs, kv_cache, cfg, opts,
                             window=window)
    elif kv_cache is not None:
        rows, slots, src = widx
        idx = (rows, slots)
        masked_write(kv_cache["k"], idx, k.reshape(B * S, *k.shape[2:])[src])
        masked_write(kv_cache["v"], idx, v.reshape(B * S, *v.shape[2:])[src])
        masked_write(kv_cache["pos"], idx, positions.reshape(-1)[src])
        masked_write(kv_cache["seg"], idx, segs.reshape(-1)[src])
        if attend_cache:
            o = attention(q, kv_cache["k"], kv_cache["v"],
                          q_positions=positions, kv_positions=kv_cache["pos"],
                          q_segments=segs, kv_segments=kv_cache["seg"],
                          window=window, q_block=opts.q_block)
        else:
            o = attention(q, k, v, q_positions=positions,
                          kv_positions=positions, q_segments=segments,
                          kv_segments=segments, window=window,
                          q_block=opts.q_block)
    else:
        o = attention(q, k, v, q_positions=positions, kv_positions=positions,
                      q_segments=segments, kv_segments=segments,
                      window=window, q_block=opts.q_block)
    nq, hd = cfg.n_heads, cfg.hd
    # under a rule table the merged heads are laid out as the head count
    # allows (and so is their gradient, split back into heads)
    o = constrain(o.reshape(B, S, nq * hd), "batch", "seq", "heads",
                  shape=(B, S, nq))
    if cfg.gated:
        o = o * torch.sigmoid(h @ p["wg"].reshape(d, nq * hd))
    o = o @ p["wo"].reshape(nq * hd, d)
    if cfg.gated:
        o = rms_norm(o, p["ln1_out"], cfg.norm_eps)
    x = constrain(x + o, "batch", "seq", "act_embed")
    h = rms_norm(x, p["ln2"], cfg.norm_eps).to(cfg.compute_dtype)
    aux = z = 0.0
    if not is_moe:
        out = swiglu(h, p["w_gate"], p["w_up"], p["w_down"])
    elif (kv_cache is not None or attn_override is not None
          or cfg.router != "softmax") and not is_dtensor(h):
        out = moe.dropless(h.reshape(B * S, d), p, cfg).reshape(B, S, d)
    else:
        if cfg.router != "softmax" or cfg.n_shared_experts:
            raise NotImplementedError(
                f"{cfg.name}: the capacity-bounded MoE (training forwards of "
                f"softmax models, sharded forwards) routes by softmax with "
                f"no shared expert; this model has router {cfg.router!r} "
                f"and {cfg.n_shared_experts} shared")
        out, aux, z = moe.moe_ffn(h.reshape(B * S, d), p["router"],
                                  p["w_gate"], p["w_up"], p["w_down"],
                                  top_k=cfg.top_k, cf=cfg.capacity_factor)
        out = out.reshape(B, S, d)
    if cfg.gated:
        out = rms_norm(out, p["ln2_out"], cfg.norm_eps)
    return constrain(x + out, "batch", "seq", "act_embed"), (aux, z)


def _recurrent_block(kind, p, x, cfg, opts, cache, slot):
    """A Mamba2 / mLSTM / sLSTM block.  ``cache`` None runs from a zero
    state; otherwise block ``slot``'s state is read and updated in
    place."""
    h = rms_norm(x, p["ln"], cfg.norm_eps).to(cfg.compute_dtype)
    if kind == C.MAMBA2:
        leaves = ("ssd", "conv")
        st = None if cache is None else mamba2.Mamba2State(
            *(cache[n][slot] for n in leaves))
        out, st = mamba2.forward(p, h, cfg, state=st, chunk=opts.ssd_chunk)
    elif kind == C.MLSTM:
        leaves = ("mlstm_C", "mlstm_n")
        st = None if cache is None else xlstm.MLstmState(
            *(cache[n][slot] for n in leaves))
        out, st = xlstm.mlstm_forward(p, h, cfg, state=st,
                                      chunk=opts.ssd_chunk)
    elif kind == C.SLSTM:
        leaves = tuple("slstm_" + n for n in "cnhm")
        st = None if cache is None else xlstm.SLstmState(
            *(cache[n][slot] for n in leaves))
        out, st = xlstm.slstm_forward(p, h, cfg, state=st)
    else:
        raise ValueError(kind)
    if cache is not None:
        for n, t in zip(leaves, st):
            cache[n][slot].copy_(t)
    return constrain(x + out, "batch", "seq", "act_embed")


def _run_stack(params, x, cfg, opts, *, positions, segments, cache, widx,
               attend_cache=True, attn_override=None):
    """Every block in order.  Returns (x, (moe_aux, moe_z)) summed over the
    MoE blocks.  A forward with no cache under autograd checkpoints each
    unit as ``opts.remat`` says; the tail runs plain, as in the
    reference."""
    shared = params.get("shared_attn")
    kinds, slots = block_kinds(cfg), cache_slots(cfg)

    def blocks(x, lo, hi):
        am = az = 0.0
        for layer, kind, slot, p in zip(range(lo, hi), kinds[lo:hi],
                                        slots[lo:hi],
                                        params["layers"][lo:hi]):
            if kind not in ATTN_KINDS:
                x = _recurrent_block(kind, p, x, cfg, opts, cache, slot)
                continue
            if kind == C.SHARED_ATTN:
                p = dict(shared, ln1=p["ln1"])  # private per-application norm
            kv = None if cache is None else layer_view(cache, slot)
            x, (a, z) = _attn_block(p, x, cfg, opts, layer=layer,
                                    positions=positions,
                                    segments=segments, kv_cache=kv,
                                    widx=widx, is_moe=kind == C.MOE,
                                    attend_cache=attend_cache,
                                    attn_override=attn_override)
            am, az = am + a, az + z
        return x, am, az

    if not (cache is None and opts.remat != "none"
            and torch.is_grad_enabled()):
        x, am, az = blocks(x, 0, len(kinds))
        return x, (am, az)
    width = len(cfg.unit)
    am = az = 0.0
    for u in range(cfg.n_units):
        x, a, z = ckpt.checkpoint(blocks, x, u * width, (u + 1) * width,
                                  use_reentrant=False,
                                  context_fn=_remat_context(opts.remat))
        am, az = am + a, az + z
    x, a, z = blocks(x, cfg.n_units * width, len(kinds))
    return x, (am + a, az + z)


# ------------------------------------------------------------ entrypoints --

def _stream_dtype(cfg):
    return torch.float32 if cfg.float32_stream else cfg.compute_dtype


def _inputs_to_x(cfg, params, tokens, inputs_embeds=None,
                 prefix_embeds=None):
    dt = _stream_dtype(cfg)
    if cfg.embed_inputs:
        x = embed(tokens, params["embed"]).to(dt)
        if cfg.embed_scale != 1.0:
            x = x * cfg.embed_scale
    else:
        x = inputs_embeds.to(dt)
    if prefix_embeds is not None:
        # under a rule table both parts are laid out alike first, so that
        # the concatenation needs no layout check on their values
        pre = constrain(prefix_embeds.to(dt), "batch", "seq",
                        "act_embed")
        x = torch.cat([pre, constrain(x, "batch", "seq", "act_embed")],
                      dim=1)
    return x


def _logits(cfg, params, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps).to(cfg.compute_dtype)
    w = (params["embed"].T if cfg.tie_embeddings and cfg.embed_inputs
         else params["lm_head"])
    if not cfg.float32_stream:
        return x @ w
    # the head's products accumulated and returned in float32
    if not x.is_cuda:
        return x.float() @ w.float()
    out = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def apply(params, cfg, *, tokens=None, inputs_embeds=None, prefix_embeds=None,
          positions=None, segments=None, opts: Opts = Opts()):
    """Full-sequence forward.  Returns (logits, (moe_aux, moe_z))."""
    x = _inputs_to_x(cfg, params, tokens, inputs_embeds, prefix_embeds)
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
    x = constrain(x, "batch", "seq", "act_embed")
    x, (am, az) = _run_stack(params, x, cfg, opts, positions=positions,
                             segments=segments, cache=None, widx=None)
    aux = tuple(torch.as_tensor(a, dtype=torch.float32, device=x.device)
                for a in (am, az))
    logits = constrain(_logits(cfg, params, x), "batch", "seq", "vocab")
    return logits, aux


def prefill(params, cfg, *, tokens=None, inputs_embeds=None,
            prefix_embeds=None, lengths=None, max_len=None, segments=None,
            positions=None, last_logits_only=False, cache=None,
            opts: Opts = Opts()):
    """Process prompts, build a dense cache.  Returns (logits, cache).

    lengths: (B,) valid prompt lengths (tokens beyond are padding).
    max_len: cache capacity (defaults to the prompt length).
    last_logits_only: logits of each row's last valid position only,
    (B, 1, V).
    cache: the cache to fill, as ``init_cache(cfg, B, max_len)`` makes it
    (a caller may lay it out over a mesh, as the reference's jit does by
    its out_shardings); made here when None.
    """
    x = _inputs_to_x(cfg, params, tokens, inputs_embeds, prefix_embeds)
    B, S, _ = x.shape
    dev = x.device
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=dev).expand(B, S)
    if segments is None:
        segments = torch.where(positions < lengths[:, None], 0, -1).to(
            torch.int32)
    max_len = max_len or S
    if cache is None:
        cache = init_cache(cfg, B, max_len, dev)
    Sc = cache_len(cfg, max_len)
    if cfg.sliding_window and Sc < S:
        # ring buffer: only the last Sc positions land in the cache; the
        # earlier ones point out of range and are dropped
        slots = torch.where(positions >= S - Sc, positions % Sc, Sc)
    else:
        slots = torch.clamp(positions, max=Sc - 1)
    widx = (write_index(slots, Sc, opts.writes_in_range) if "k" in cache
            else None)
    x = constrain(x, "batch", "seq", "act_embed")
    x, _ = _run_stack(params, x, cfg, opts, positions=positions,
                      segments=segments, cache=cache, widx=widx,
                      attend_cache=False)
    if last_logits_only:
        idx = torch.clamp(lengths.long() - 1, min=0)
        x = last_rows(x, idx)
    return _logits(cfg, params, x), cache


def last_rows(x, idx):
    """``x[b, idx[b]]`` of x (B, S, d) as (B, 1, d).  Laid out over a mesh,
    each device gathers its own rows (x and idx split alike over the
    batch)."""
    if not is_dtensor(x):
        return x[torch.arange(x.shape[0], device=x.device), idx][:, None]
    from torch.distributed.tensor import Replicate, Shard
    xp = tuple(p if p in (Shard(0), Shard(2)) else Replicate()
               for p in x.placements)
    rows = tuple(p if p == Shard(0) else Replicate() for p in xp)
    return on_shards(lambda x, idx: x.gather(1, idx[:, None, None].expand(
        -1, 1, x.shape[-1])), x.device_mesh, (x, idx), (xp, rows), xp)


def decode_step(params, cfg, cache, *, tokens=None, inputs_embeds=None,
                lengths=None, segments=None, attn_override=None,
                opts: Opts = Opts()):
    """One generation step: tokens (B, T), T new tokens per row at
    positions ``lengths[b] + t``.  Returns (logits, cache).
    ``attn_override`` replaces attention + KV write-back per layer — the
    paged-KV path (serving/paged.py) routes block tables through it."""
    x = _inputs_to_x(cfg, params, tokens, inputs_embeds)
    B, T, _ = x.shape
    positions = (lengths[:, None].to(torch.int32)
                 + torch.arange(T, dtype=torch.int32, device=x.device)[None])
    if segments is None:
        segments = torch.zeros((B, T), dtype=torch.int32, device=x.device)
    widx = None
    if attn_override is None and "k" in cache:
        Sc = cache["k"].shape[2]
        widx = write_index(positions % Sc if cfg.sliding_window else positions,
                           Sc, opts.writes_in_range)
    x = constrain(x, "batch", "seq", "act_embed")
    x, _ = _run_stack(params, x, cfg, opts, positions=positions,
                      segments=segments, cache=cache, widx=widx,
                      attn_override=attn_override)
    return _logits(cfg, params, x), cache


def verify_step_packed(params, cfg, cache, *, tokens, positions, segments,
                       attn_override, opts: Opts = Opts()):
    """SPIN packed verification: all requests' query tokens flattened into
    one (1, Tq) row; attention and cache write-back are handled by
    ``attn_override``.  Returns (logits, cache)."""
    x = constrain(_inputs_to_x(cfg, params, tokens), "batch", "seq",
                  "act_embed")
    x, _ = _run_stack(params, x, cfg, opts, positions=positions,
                      segments=segments, cache=cache, widx=None,
                      attn_override=attn_override)
    return _logits(cfg, params, x), cache


# ------------------------------------------------------------- training --

def loss_fn(params, cfg, batch, opts: Opts = Opts()):
    """Next-token loss of one batch (``tokens`` or ``inputs_embeds``,
    ``labels``, optional ``mask`` and ``prefix_embeds``): logits[t] predicts
    labels[t], the prefix positions dropped.  Returns (total, metrics),
    total = loss + 0.01 * moe_aux + 1e-3 * moe_z."""
    logits, (aux, z) = apply(
        params, cfg, tokens=batch.get("tokens"),
        inputs_embeds=batch.get("inputs_embeds"),
        prefix_embeds=batch.get("prefix_embeds"), opts=opts)
    if batch.get("prefix_embeds") is not None:
        logits = logits[:, batch["prefix_embeds"].shape[1]:]
    loss = softmax_cross_entropy(logits, batch["labels"], batch.get("mask"),
                                 cfg.vocab_size)
    total = loss + 0.01 * aux + 1e-3 * z
    return total, {"loss": loss, "moe_aux": aux, "moe_z": z}


def decay_mask(params, cfg):
    """Per leaf, whether AdamW decays it: the reference decays a leaf of
    rank >= 2 of its own tree, where every leaf of a unit of the block
    stack carries a leading unit axis.  So each leaf of the body's layers
    is decayed (norm weights and QKV biases included); the tail's layers,
    ``final_norm`` and ``shared_attn`` keep the rule on their own rank."""
    body = cfg.n_units * len(cfg.unit)
    out = pp.map_tensors(lambda p: p.dim() >= 2, params)
    out["layers"] = [pp.map_tensors(lambda p: True, layer) if i < body
                     else out["layers"][i]
                     for i, layer in enumerate(params["layers"])]
    return out


def make_train_step(cfg, optimizer, opts: Opts = Opts()):
    """A function ``(params, opt_state, batch) -> (params, opt_state,
    metrics)``: forward, backward (autograd over every leaf), the
    optimizer's update with the reference's decay rule (:func:`decay_mask`)
    and the loss metrics plus ``total``.  Params are updated in place; they
    take gradients only inside the step."""
    def train_step(params, opt_state, batch):
        flat = pp.tensor_leaves(params)
        for p in flat:
            p.requires_grad_(True)
        try:
            total, metrics = loss_fn(params, cfg, batch, opts)
            grads = torch.autograd.grad(total, flat, allow_unused=True)
        finally:
            for p in flat:
                p.requires_grad_(False)
        # a leaf no forward reads (shared_attn's own ln1) takes a zero grad;
        # a gradient laid out over a mesh is laid out as its parameter
        grads = iter([torch.zeros_like(p) if g is None else
                      g.redistribute(p.device_mesh, p.placements)
                      if is_dtensor(g) else g
                      for p, g in zip(flat, grads)])
        grads = pp.map_tensors(lambda _: next(grads), params)
        params, opt_state = optimizer.update(params, grads, opt_state,
                                             decay=decay_mask(params, cfg))
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["total"] = total.detach()
        return params, opt_state, metrics
    return train_step
