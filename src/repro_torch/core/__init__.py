"""repro_torch.core (PyTorch port of repro.core)."""
