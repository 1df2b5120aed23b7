"""Decoder-only LM for the dense attention-only family (``unit == (ATTN,)``).

Parameters are a dict: ``embed``, ``lm_head``, ``final_norm`` and
``layers``, a per-layer list of block dicts (the reference stacks them for
``lax.scan``; here the stack is a Python loop).

Caches are one dict of layer-stacked tensors — ``k``/``v``
``(L, B, S, Kh, hd)`` plus per-slot absolute positions and segment ids
``pos``/``seg`` ``(L, B, S)`` (-1 = empty slot).  Paged pools use the same
dict with ``(L, num_blocks, block_size, ...)`` leaves and, for quantized
storage, ``k_scale``/``v_scale`` ``(L, num_blocks, block_size, Kh)``.
Layer ``l`` works on the views ``t[l]``; every cache write updates the
stacked tensors **in place** (the reference is functional) and the entry
points return the same dict for symmetry with the reference.

Entry points
  prefill(...)             forward + cache construction
  decode_step(...)         T new tokens per row against a cache
  verify_step_packed(...)  SPIN packed verification through an override
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.kernels import quant
from repro_torch.models import config as C
from repro_torch.models import params as pp
from repro_torch.models.layers import attention, embed, rms_norm, rope, swiglu
from repro_torch.models.params import P


@dataclasses.dataclass(frozen=True)
class Opts:
    q_block: int = 512  # query-block size of chunked attention


def check_supported(cfg: C.ModelConfig):
    """The port runs the dense attention-only stack; other block kinds
    wait in ROADMAP Queue 1 (models off the main path)."""
    kinds = set(cfg.unit) | set(cfg.tail)
    if kinds != {C.ATTN} or cfg.qkv_bias or not cfg.embed_inputs:
        raise ValueError(
            f"{cfg.name}: the port serves dense attention-only models "
            f"(unit (attn,), no qkv bias, token inputs); blocks "
            f"{sorted(kinds)} wait in ROADMAP Queue 1")


# ------------------------------------------------------------- param spec --

def _attn_spec(cfg: C.ModelConfig) -> Dict[str, Any]:
    d, hd = cfg.d_model, cfg.hd
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    return {
        "ln1": P((d,), ("embed",), init="zeros"),
        "wq": P((d, nq, hd), ("embed", "heads", "head_dim")),
        "wk": P((d, nkv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": P((d, nkv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": P((nq, hd, d), ("heads", "head_dim", "embed")),
        "ln2": P((d,), ("embed",), init="zeros"),
        "w_gate": P((d, cfg.d_ff), ("embed", "mlp")),
        "w_up": P((d, cfg.d_ff), ("embed", "mlp")),
        "w_down": P((cfg.d_ff, d), ("mlp", "embed")),
    }


def param_spec(cfg: C.ModelConfig) -> Dict[str, Any]:
    check_supported(cfg)
    d = cfg.d_model
    spec: Dict[str, Any] = {
        "embed": P((cfg.padded_vocab, d), ("vocab", "embed"), scale=0.02)
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = P((d, cfg.padded_vocab), ("embed", "vocab"))
    spec["final_norm"] = P((d,), ("embed",), init="zeros")
    spec["layers"] = [_attn_spec(cfg) for _ in range(cfg.n_layers)]
    return spec


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
    L, Kh, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    S = cache_len(cfg, max_len)
    dt = cfg.compute_dtype
    return {
        "k": torch.zeros((L, batch, S, Kh, hd), dtype=dt, device=device),
        "v": torch.zeros((L, batch, S, Kh, hd), dtype=dt, device=device),
        "pos": torch.full((L, batch, S), -1, dtype=torch.int32,
                          device=device),
        "seg": torch.full((L, batch, S), -1, dtype=torch.int32,
                          device=device),
    }


def init_paged_cache(cfg, num_blocks, block_size, kv_dtype: str = "bf16",
                     device="cuda"):
    """Paged KV block pool: the ``init_cache`` dict with (physical block,
    slot-in-block) leading axes.  ``kv_dtype`` selects the block storage
    (kernels/quant.py): ``"bf16"`` keeps the compute dtype; ``"int8"`` /
    ``"fp8"`` store K/V quantized and add float32 ``k_scale``/``v_scale``
    sidecars ``(L, num_blocks, block_size, Kh)``."""
    check_supported(cfg)
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
    """Per-layer views of a stacked cache dict (writes land in place)."""
    return {name: t[layer] for name, t in cache.items()}


def masked_write(dst, dst_idx, src):
    """``dst[dst_idx] = src`` along the leading axes.  The reference's
    scatters drop out-of-range indices; here the caller has already
    filtered them (see ``write_index``)."""
    dst[dst_idx] = src.to(dst.dtype)


def write_index(write_idx, S: int):
    """(batch rows, slots, source flat index) of the in-range writes of a
    (B, T) slot-index grid — computed once per forward and shared by every
    layer (the reference drops out-of-range scatter updates)."""
    B, T = write_idx.shape
    ok = (write_idx >= 0) & (write_idx < S)
    src = torch.nonzero(ok.reshape(-1)).squeeze(1)
    rows = torch.div(src, T, rounding_mode="floor")
    return rows, write_idx.reshape(-1)[src].long(), src


# ----------------------------------------------------------------- blocks --

def _project_qkv(p, h, cfg, positions):
    B, S, d = h.shape
    q = (h @ p["wq"].reshape(d, -1)).reshape(B, S, cfg.n_heads, cfg.hd)
    k = (h @ p["wk"].reshape(d, -1)).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    v = (h @ p["wv"].reshape(d, -1)).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attn_block(p, x, cfg, opts, *, positions, segments, kv_cache, widx,
                attend_cache=True, attn_override=None):
    """One pre-norm attention + SwiGLU block.  Returns x_out.

    kv_cache None              -> attend in-sequence, no cache
    kv_cache, attend_cache=F   -> prefill: write K/V into the cache grid but
                                  attend over the in-sequence K/V
    kv_cache, attend_cache=T   -> decode: write at ``widx`` slots (from
                                  :func:`write_index`), attend the grid
    attn_override              -> handles attention + cache write-back
                                  (paged and packed-verify paths)
    """
    B, S, d = x.shape
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _project_qkv(p, h, cfg, positions)
    segs = (segments if segments is not None
            else torch.zeros((B, S), dtype=torch.int32, device=x.device))
    if attn_override is not None:
        o, _ = attn_override(q, k, v, positions, segs, kv_cache, cfg, opts)
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
                          window=cfg.sliding_window, q_block=opts.q_block)
        else:
            o = attention(q, k, v, q_positions=positions,
                          kv_positions=positions, q_segments=segments,
                          kv_segments=segments, window=cfg.sliding_window,
                          q_block=opts.q_block)
    else:
        o = attention(q, k, v, q_positions=positions, kv_positions=positions,
                      q_segments=segments, kv_segments=segments,
                      window=cfg.sliding_window, q_block=opts.q_block)
    nq, hd = cfg.n_heads, cfg.hd
    o = o.reshape(B, S, nq * hd) @ p["wo"].reshape(nq * hd, d)
    x = x + o
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + swiglu(h, p["w_gate"], p["w_up"], p["w_down"])


def _run_stack(params, x, cfg, opts, *, positions, segments, cache, widx,
               attend_cache=True, attn_override=None):
    for layer, p in enumerate(params["layers"]):
        kv = None if cache is None else layer_view(cache, layer)
        x = _attn_block(p, x, cfg, opts, positions=positions,
                        segments=segments, kv_cache=kv, widx=widx,
                        attend_cache=attend_cache,
                        attn_override=attn_override)
    return x


# ------------------------------------------------------------ entrypoints --

def _inputs_to_x(cfg, params, tokens):
    return embed(tokens, params["embed"]).to(cfg.compute_dtype)


def _logits(cfg, params, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["lm_head"]


def prefill(params, cfg, *, tokens, lengths=None, max_len=None,
            segments=None, positions=None, opts: Opts = Opts()):
    """Process prompts, build a dense cache.  Returns (logits, cache).

    lengths: (B,) valid prompt lengths (tokens beyond are padding).
    max_len: cache capacity (defaults to the prompt length).
    """
    x = _inputs_to_x(cfg, params, tokens)
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
    cache = init_cache(cfg, B, max_len, dev)
    Sc = cache_len(cfg, max_len)
    if cfg.sliding_window and Sc < S:
        # ring buffer: only the last Sc positions land in the cache; the
        # earlier ones point out of range and are dropped
        slots = torch.where(positions >= S - Sc, positions % Sc, Sc)
    else:
        slots = torch.clamp(positions, max=Sc - 1)
    widx = write_index(slots, Sc)
    x = _run_stack(params, x, cfg, opts, positions=positions,
                   segments=segments, cache=cache, widx=widx,
                   attend_cache=False)
    return _logits(cfg, params, x), cache


def decode_step(params, cfg, cache, *, tokens, lengths, segments=None,
                attn_override=None, opts: Opts = Opts()):
    """One generation step: tokens (B, T), T new tokens per row at
    positions ``lengths[b] + t``.  Returns (logits, cache).
    ``attn_override`` replaces attention + KV write-back per layer — the
    paged-KV path (serving/paged.py) routes block tables through it."""
    x = _inputs_to_x(cfg, params, tokens)
    B, T, _ = x.shape
    positions = (lengths[:, None].to(torch.int32)
                 + torch.arange(T, dtype=torch.int32, device=x.device)[None])
    if segments is None:
        segments = torch.zeros((B, T), dtype=torch.int32, device=x.device)
    widx = None
    if attn_override is None:
        Sc = cache["k"].shape[2]
        widx = write_index(positions % Sc if cfg.sliding_window else positions,
                           Sc)
    x = _run_stack(params, x, cfg, opts, positions=positions,
                   segments=segments, cache=cache, widx=widx,
                   attn_override=attn_override)
    return _logits(cfg, params, x), cache


def verify_step_packed(params, cfg, cache, *, tokens, positions, segments,
                       attn_override, opts: Opts = Opts()):
    """SPIN packed verification: all requests' query tokens flattened into
    one (1, Tq) row; attention and cache write-back are handled by
    ``attn_override``.  Returns (logits, cache)."""
    x = _inputs_to_x(cfg, params, tokens)
    x = _run_stack(params, x, cfg, opts, positions=positions,
                   segments=segments, cache=cache, widx=None,
                   attn_override=attn_override)
    return _logits(cfg, params, x), cache
