"""Tile configs of the fused speculative-step kernels.

The serving engine resolves one :class:`FusedConfig` per attention site at
construction and passes it down; ``None`` selects the unfused gather path.
The CUDA kernels of this package take their tile shape from the CTA layout
in ``csrc/paged_common.cuh``, so every lookup returns :data:`DEFAULT_CONFIG`
for now; a tile cache keyed by the Hopper shape is queued in ROADMAP
Queue 1 (tile configs).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FusedConfig:
    """Tile config of one fused kernel launch (hashable, so it can key the
    bundles' per-config entry points).  ``bk = 0`` means one tile per
    physical block."""
    bq: int = 128
    bk: int = 0
    depth: int = 1


DEFAULT_CONFIG = FusedConfig()


def get_config(kind: str, *, H: int, Kh: int, D: int, gamma_max: int = 0,
               block_size: int = 0, shape: str = "linear",
               kv_dtype: str = "bf16") -> FusedConfig:
    """Lookup with the reference's signature; always the default here."""
    if kind not in ("verify", "decode"):
        raise ValueError(f"unknown fused kernel kind {kind!r}")
    return DEFAULT_CONFIG
