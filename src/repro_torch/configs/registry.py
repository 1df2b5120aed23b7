"""Architecture registry: --arch <id> resolves here."""

from __future__ import annotations

from repro_torch.models import config as C
from repro_torch.configs import (dbrx_132b, internlm2_20b, internvl2_26b,
                           minitron_4b, mixtral_8x22b, musicgen_large,
                           qwen1_5_32b, qwen2_0_5b, spin_llama, xlstm_350m,
                           zamba2_1_2b)

ARCHS = {
    "mixtral-8x22b": mixtral_8x22b.CONFIG,
    "dbrx-132b": dbrx_132b.CONFIG,
    "musicgen-large": musicgen_large.CONFIG,
    "qwen2-0.5b": qwen2_0_5b.CONFIG,
    "minitron-4b": minitron_4b.CONFIG,
    "internlm2-20b": internlm2_20b.CONFIG,
    "qwen1.5-32b": qwen1_5_32b.CONFIG,
    "xlstm-350m": xlstm_350m.CONFIG,
    "zamba2-1.2b": zamba2_1_2b.CONFIG,
    "internvl2-26b": internvl2_26b.CONFIG,
    # the paper's own models
    **{m.name: m for m in spin_llama.LLMS + spin_llama.SSM_ZOO},
}

ASSIGNED = [
    "mixtral-8x22b", "dbrx-132b", "musicgen-large", "qwen2-0.5b",
    "minitron-4b", "internlm2-20b", "qwen1.5-32b", "xlstm-350m",
    "zamba2-1.2b", "internvl2-26b",
]


def get(name: str) -> C.ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def reduced_for(name: str, **overrides) -> C.ModelConfig:
    return C.reduced(get(name), **overrides)
