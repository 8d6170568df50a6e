"""The cache_sim kernel: see :mod:`repro_torch.kernels.cache_sim.ops`."""
