"""zamba2-1.2b [hybrid]: 38L d=2048 32H (kv=32) d_ff=8192 vocab=32000,
ssm_state=64 — Mamba2 backbone + shared-weight attention block applied every
6th position (6 units of 5xMamba2 + shared-attn, 2 trailing Mamba2).
[arXiv:2411.15242; hf]"""

from repro_torch.models.config import MAMBA2, SHARED_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    head_dim=64,
    ssm_state=64,
    unit=(MAMBA2, MAMBA2, MAMBA2, MAMBA2, MAMBA2, SHARED_ATTN),
    tail=(MAMBA2, MAMBA2),
    subquadratic=True,   # mostly linear-time; attention is 6/38 blocks
)
