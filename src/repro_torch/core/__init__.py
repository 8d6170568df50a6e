"""The paper's policies and experiment: registry, Zipf traces, the PyTorch
step (``torch_cache``), the grid harness (``simulate``) and energy."""
