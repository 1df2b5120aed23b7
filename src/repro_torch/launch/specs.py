"""Input stand-ins for every (arch x input-shape) dry-run cell.

No memory is ever allocated here: every leaf is a ``meta`` tensor (shape
and dtype only), which ``launch/dryrun.py`` materialises as fake tensors
under ``FakeTensorMode`` and lays out over the mesh.  The shape set and
the trees are the reference's (``repro.launch.specs``):

  train_4k     seq 4096,  global_batch 256   -> train step
  prefill_32k  seq 32768, global_batch 32    -> prefill
  decode_32k   ctx 32768, global_batch 128   -> decode step (1 new token)
  long_500k    ctx 524288, global_batch 1    -> decode step; ONLY for
               sub-quadratic archs (cfg.subquadratic) per the skip rule.

[audio]/[vlm] cells: the frontend is a stub; inputs are precomputed frame
(B, S, d) / patch (B, P, d) embeddings, exactly as input_specs() returns.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


def cell_applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and not cfg.subquadratic:
        return False, ("skip: pure full-attention arch — 500k decode needs "
                       "sub-quadratic attention (DESIGN.md §5)")
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: str) -> Dict[str, Any]:
    """The kwargs tree of meta tensors for the step function."""
    info = SHAPES[shape]
    return specs_for(cfg, info["kind"], info["batch"], info["seq"])


def specs_for(cfg: ModelConfig, kind: str, B: int, S: int) -> Dict[str, Any]:
    """:func:`input_specs` of a step of ``kind`` at batch ``B`` and
    sequence ``S`` (the dry-run's sequence fit runs shorter ones)."""
    i32 = torch.int32
    cdt = cfg.compute_dtype

    if kind == "train":
        batch: Dict[str, Any] = {}
        if cfg.embed_inputs:
            batch["tokens"] = _meta((B, S), i32)
        else:
            batch["inputs_embeds"] = _meta((B, S, cfg.d_model), cdt)
        if cfg.num_prefix_embeds:
            batch["prefix_embeds"] = _meta(
                (B, cfg.num_prefix_embeds, cfg.d_model), cdt)
        batch["labels"] = _meta((B, S), i32)
        return {"batch": batch}

    if kind == "prefill":
        kw: Dict[str, Any] = {"lengths": _meta((B,), i32)}
        if cfg.embed_inputs:
            kw["tokens"] = _meta((B, S), i32)
        else:
            kw["inputs_embeds"] = _meta((B, S, cfg.d_model), cdt)
        if cfg.num_prefix_embeds:
            kw["prefix_embeds"] = _meta(
                (B, cfg.num_prefix_embeds, cfg.d_model), cdt)
        return kw

    # decode: one new token with a KV cache of seq_len
    kw = {
        "cache": T.abstract_cache(cfg, B, S),
        "lengths": _meta((B,), i32),
    }
    if cfg.embed_inputs:
        kw["tokens"] = _meta((B, 1), i32)
    else:
        kw["inputs_embeds"] = _meta((B, 1, cfg.d_model), cdt)
    return kw


def batch_logical_axes(batch_tree) -> Any:
    """Logical axes for the train/prefill/decode input trees."""
    def axes(name, leaf):
        if name in ("tokens", "labels"):
            return ("batch", "seq")[:len(leaf.shape)]
        if name in ("inputs_embeds", "prefix_embeds"):
            return ("batch", "seq", "act_embed")
        if name == "lengths":
            return ("batch",)
        return tuple(None for _ in leaf.shape)

    return {k: (axes(k, v) if not isinstance(v, dict)
                else {k2: axes(k2, v2) for k2, v2 in v.items()})
            for k, v in batch_tree.items()}
