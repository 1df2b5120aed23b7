"""internvl2-26b [vlm]: 48L d=6144 48H (GQA kv=8) d_ff=16384 vocab=92553 —
InternViT (stubbed frontend: 256 precomputed patch embeddings prepended) +
InternLM2-20B language backbone. [arXiv:2404.16821; hf]"""

from repro_torch.models.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    head_dim=128,
    unit=(ATTN,),
    num_prefix_embeds=256,   # InternViT patch tokens per image (stub)
    rope_theta=1e6,
)
