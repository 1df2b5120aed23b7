"""repro_torch.models (PyTorch port of repro.models)."""
