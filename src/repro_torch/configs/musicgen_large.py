"""musicgen-large [audio]: 48L d=2048 32H (kv=32) d_ff=8192 vocab=2048 —
decoder-only over EnCodec tokens. Backbone only: the EnCodec frontend is a
stub; input_specs() provides precomputed frame embeddings (B, S, d_model).
[arXiv:2306.05284; hf]"""

from repro_torch.models.config import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    head_dim=64,
    unit=(ATTN,),
    embed_inputs=False,   # frame embeddings come from the (stubbed) frontend
)
