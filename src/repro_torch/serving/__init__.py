"""repro_torch.serving (PyTorch port of repro.serving)."""
