"""repro_torch.distributed (PyTorch port of repro.distributed): logical-axis
sharding rules over a torch ``DeviceMesh``, compressed collectives."""
