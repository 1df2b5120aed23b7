"""repro_torch.kernels (PyTorch port of repro.kernels)."""
