"""The paper's own model zoo (SPIN §VI-A): LLaMA LLMs (7B/13B/30B) and the
five heterogeneous SSMs (68M .. 1.4B), shape-faithful to the public configs.
These are selectable like any assigned arch and are what the SPIN benchmarks
instantiate (at reduced scale for CPU execution)."""

from repro_torch.models.config import ATTN, ModelConfig


def _llama(name, n_layers, d_model, n_heads, d_ff, n_kv_heads=None):
    return ModelConfig(
        name=name, family="dense", n_layers=n_layers, d_model=d_model,
        n_heads=n_heads, n_kv_heads=n_kv_heads or n_heads, d_ff=d_ff,
        vocab_size=32000, unit=(ATTN,))


LLAMA_7B = _llama("llama-7b", 32, 4096, 32, 11008)
LLAMA_13B = _llama("llama-13b", 40, 5120, 40, 13824)
LLAMA_30B = _llama("llama-30b", 60, 6656, 52, 17920)

# SSM zoo (speculative models), smallest to largest.
LLAMA_68M = _llama("llama-68m", 2, 768, 12, 3072)
LLAMA_265M = _llama("llama-265m", 12, 1024, 16, 2816)
LLAMA_616M = _llama("llama-616m", 16, 1536, 16, 4096)
LLAMA_1_1B = _llama("llama-1.1b", 22, 2048, 16, 5632)
LLAMA_1_4B = _llama("llama-1.4b", 24, 2048, 32, 5504)

SSM_ZOO = [LLAMA_68M, LLAMA_265M, LLAMA_616M, LLAMA_1_1B, LLAMA_1_4B]
LLMS = [LLAMA_7B, LLAMA_13B, LLAMA_30B]
