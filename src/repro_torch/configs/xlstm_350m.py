"""xlstm-350m [ssm]: 24L d=1024 4H d_ff=0 vocab=50304 — alternating sLSTM +
mLSTM blocks (unit = mLSTM, sLSTM). Attention-free: recurrent state replaces
the KV cache; long_500k runs (linear time). [arXiv:2405.04517; unverified]"""

from repro_torch.models.config import MLSTM, SLSTM, ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    unit=(MLSTM, SLSTM),
    subquadratic=True,
)
