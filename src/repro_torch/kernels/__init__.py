"""Hand-written CUDA kernels for Hopper (``sm_90a``), built at first use by
:mod:`repro_torch.kernels._build`.

  * cache_sim       — the paper's policy simulation, one thread block per sample
  * flash_attention — blocked online-softmax attention with GQA (the serving
                      path's prefill and decode attention)

Each kernel ships ``csrc/`` (the CUDA source), ``<name>.py`` (the wrapper that
launches it, with its launch count, and the plain PyTorch version) and
``ops.py`` (the public entry point); flash_attention's plain version is its
``ref.py`` oracle.
"""
