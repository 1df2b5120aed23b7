"""repro_torch.data (PyTorch port of repro.data)."""
