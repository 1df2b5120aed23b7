"""Model configuration.

One frozen dataclass covers every assigned architecture family:
dense / moe / ssm (mamba2, xlstm) / hybrid / audio-backbone / vlm-backbone.

Per-layer structure is expressed with ``unit``: a tuple of block kind
strings repeated ``n_units`` times, plus an optional ``tail``; the fields
and derived properties are the reference's (``repro.models.config``), so
every configuration of ``configs/registry.py`` loads and runs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

# Block kinds
ATTN = "attn"          # self-attention + SwiGLU MLP (pre-norm)
MOE = "moe"            # self-attention + MoE FFN
MAMBA2 = "mamba2"      # Mamba2 (SSD) block
MLSTM = "mlstm"        # xLSTM matrix-memory block
SLSTM = "slstm"        # xLSTM scalar-memory block
SHARED_ATTN = "shared_attn"  # zamba2-style shared-weight attention block


# dtype names used by configs -> torch dtypes
TORCH_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return TORCH_DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}") from None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0                # 0 -> d_model // n_heads
    qkv_bias: bool = False
    sliding_window: int = 0          # 0 -> full attention
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # "softmax": top-k of the softmax, renormalised; "sigmoid" (AFMoE):
    # top-k of sigmoid scores plus a learnt ``expert_bias``, weighted by
    # the scores alone, renormalised, x route_scale
    router: str = "softmax"
    route_scale: float = 1.0
    n_shared_experts: int = 0        # always-on experts of width d_ff
    dense_ff: int = 0                # ATTN blocks' MLP width (0 -> d_ff)
    # SSM
    ssm_state: int = 0               # mamba2 d_state
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_kernel: int = 4
    # Hybrid / heterogeneous stacks: the repeating unit of block kinds.
    # n_layers counts *all* block applications (len(unit) * n_units + tail).
    unit: Tuple[str, ...] = (ATTN,)
    tail: Tuple[str, ...] = ()       # trailing blocks not part of the scan
    # Frontend stubs for audio/vlm: inputs are precomputed embeddings.
    embed_inputs: bool = True        # False -> forward takes (B, S, d_model) embeds
    num_prefix_embeds: int = 0       # vlm: patch embeddings prepended to text
    # Per block application (empty = the same for every block): the
    # attention window (0 = full) and whether q/k take rotary embeddings.
    # Two window mechanisms, kept apart on purpose: ``layer_windows`` is a
    # mask term on every path (the paged pool keeps the whole context, the
    # kernels skip what the window masks); ``sliding_window`` is the JAX
    # package's model-wide ring buffer (``cache_len``: a dense cache of
    # min(max_len, window) slots), whose memory stays bounded at any
    # context and which the port's parity tests hold to the reference
    # (tests/test_torch_models.py, test_torch_dense.py).  One window path
    # would need the paged pool to free blocks that fall out of the window.
    layer_windows: Tuple[int, ...] = ()
    layer_rope: Tuple[bool, ...] = ()
    # Gated blocks (AFMoE): per-head RMSNorm of q and k, a sigmoid gate on
    # the attention output, RMSNorm of each sublayer's output before the
    # residual add ("sandwich")
    gated: bool = False
    embed_scale: float = 1.0
    # The residual stream and the logits in float32 (every matmul's inputs
    # stay in ``dtype``).  Where the embeddings enter far above each normed
    # update (AFMoE's sqrt(d) scale), a bf16 stream rounds each update to
    # the stream's last bit, and the head's bf16 output rounds near-tied
    # top logits together.
    float32_stream: bool = False
    # misc
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"          # compute dtype
    # Sub-quadratic flag used by launch/dryrun to honour long_500k skip rules.
    subquadratic: bool = False

    def __post_init__(self):
        if self.router not in ("softmax", "sigmoid"):
            raise ValueError(f"unknown router {self.router!r}")
        for name in ("layer_windows", "layer_rope"):
            n = len(getattr(self, name))
            if n and n != self.n_layers:
                raise ValueError(f"{self.name}: {name} has {n} entries for "
                                 f"{self.n_layers} layers")
        if self.layer_windows and self.sliding_window:
            raise ValueError(f"{self.name}: layer_windows and sliding_window "
                             f"exclude each other")

    def window(self, layer: int) -> int:
        """The attention window of block application ``layer`` (0 =
        full)."""
        return (self.layer_windows[layer] if self.layer_windows
                else self.sliding_window)

    def rotary(self, layer: int) -> bool:
        return bool(self.layer_rope[layer]) if self.layer_rope else True

    # ---- derived ----
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so it shards over the model axis."""
        return int(math.ceil(self.vocab_size / 256) * 256)

    @property
    def n_units(self) -> int:
        body = self.n_layers - len(self.tail)
        assert body % len(self.unit) == 0, (
            f"{self.name}: n_layers-{len(self.tail)} not divisible by unit "
            f"{self.unit}")
        return body // len(self.unit)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attn_positions(self) -> Tuple[int, ...]:
        """Indices (application order) of attention-bearing blocks."""
        kinds = list(self.unit) * self.n_units + list(self.tail)
        return tuple(i for i, k in enumerate(kinds)
                     if k in (ATTN, MOE, SHARED_ATTN))

    @property
    def is_attention_free(self) -> bool:
        return not self.attn_positions

    def params_count(self) -> int:
        """Analytic parameter count (for roofline MODEL_FLOPS)."""
        d, hd = self.d_model, self.hd
        n_q, n_kv = self.n_heads, self.n_kv_heads
        per = {}
        # gated attention blocks: the gate, two norms of hd and two more
        # of d
        extra = n_q * hd * d + 2 * hd + 2 * d if self.gated else 0
        per[ATTN] = (d * (n_q + 2 * n_kv) * hd + n_q * hd * d
                     + 3 * d * (self.dense_ff or self.d_ff) + 2 * d + extra)
        per[MOE] = (d * (n_q + 2 * n_kv) * hd + n_q * hd * d
                    + (self.n_experts + self.n_shared_experts) * 3 * d
                    * self.d_ff + d * self.n_experts + 2 * d + extra
                    + (self.n_experts if self.router == "sigmoid" else 0))
        di, ds, nh = self.d_inner, self.ssm_state, self.ssm_heads
        per[MAMBA2] = (d * (2 * di + 2 * ds + nh) + di * d
                       + self.conv_kernel * (di + 2 * ds) + 3 * nh + di + d)
        pf = 2
        per[MLSTM] = (d * pf * d * 2 + pf * d * d          # up/down proj
                      + 3 * (pf * d) * (pf * d) // 1       # q,k,v proj (inner)
                      + 4 * pf * d + d)
        per[SLSTM] = (4 * d * d + 4 * d * (d // max(self.n_heads, 1))
                      + 2 * d * int(4 * d / 3) + d)
        per[SHARED_ATTN] = 0  # counted once below
        kinds = list(self.unit) * self.n_units + list(self.tail)
        n = sum(per[k] for k in kinds)
        if SHARED_ATTN in kinds:
            n += (d * (n_q + 2 * n_kv) * hd + n_q * hd * d
                  + 3 * d * self.d_ff + 2 * d)  # one shared copy
        n += self.padded_vocab * d  # embeddings
        if not self.tie_embeddings:
            n += self.padded_vocab * d  # lm head
        n += d  # final norm
        return int(n)

    def active_params_count(self) -> int:
        """Params touched per token (MoE: only top_k experts, no router)
        for 6*N*D."""
        if self.n_experts and self.top_k:
            kinds = list(self.unit) * self.n_units + list(self.tail)
            n_moe_layers = sum(1 for k in kinds if k == MOE)
            idle = ((self.n_experts - self.top_k) * 3 * self.d_model
                    * self.d_ff + self.d_model * self.n_experts
                    + (self.n_experts if self.router == "sigmoid" else 0))
            return int(self.params_count() - n_moe_layers * idle)
        return self.params_count()


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    # keep one unit + tail so every block kind is exercised
    small_unit = cfg.unit
    n_layers = 2 * len(small_unit) + len(cfg.tail)
    base = dict(
        name=cfg.name + "-reduced",
        family=cfg.family,
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=512,
        head_dim=16,
        qkv_bias=cfg.qkv_bias,
        sliding_window=min(cfg.sliding_window, 32) if cfg.sliding_window else 0,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16,
        ssm_expand=cfg.ssm_expand,
        conv_kernel=cfg.conv_kernel,
        unit=cfg.unit,
        tail=cfg.tail,
        embed_inputs=cfg.embed_inputs,
        num_prefix_embeds=min(cfg.num_prefix_embeds, 4),
        tie_embeddings=cfg.tie_embeddings,
        dtype="float32",
        subquadratic=cfg.subquadratic,
    )
    base.update(overrides)
    return ModelConfig(**base)
