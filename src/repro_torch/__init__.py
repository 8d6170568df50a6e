"""PyTorch and CUDA port of the paper-reproduction package ``repro``.

It runs on an NVIDIA Hopper card (H100) and imports nothing of ``repro``,
which stays the reference it is tested against. Module names mirror
``repro``'s, so ``repro_torch.core.torch_cache`` is the counterpart of
``repro.core.jax_cache`` and ``repro_torch.kernels.cache_sim`` of the Pallas
kernel of the same name. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
