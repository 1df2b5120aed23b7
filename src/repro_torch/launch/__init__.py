"""repro_torch.launch (PyTorch port of repro.launch)."""
