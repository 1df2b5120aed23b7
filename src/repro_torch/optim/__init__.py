"""repro_torch.optim (PyTorch port of repro.optim)."""

from repro_torch.optim.adamw import (AdamW, AdamWState, cosine_schedule,
                                     linear_warmup)

__all__ = ["AdamW", "AdamWState", "cosine_schedule", "linear_warmup"]
