"""repro_torch.configs (PyTorch port of repro.configs)."""
