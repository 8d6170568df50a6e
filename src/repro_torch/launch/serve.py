"""Serving launcher: reduced-config engine with the paper's content cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m --policy plfua --requests 40

The reference launcher's flags and output line, plus ``--device`` (``cuda``
by default; ``cpu`` runs the plain PyTorch path). Weights are drawn from seed
0 with ``Model.init``.
"""
from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--policy", default="plfua")
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--objects", type=int, default=20)
    ap.add_argument("--cache-objects", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch._device import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.core import zipf
    from repro_torch.models import build
    from repro_torch.serving import ContentCache, Request, ServeEngine

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    model = build(cfg, device=device)
    model.init(torch.Generator(device=device).manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = {i: rng.integers(0, cfg.vocab_size, 8).astype(np.int32) for i in range(args.objects)}
    cache = ContentCache(args.cache_objects, policy=args.policy, n_objects=args.objects)
    engine = ServeEngine(model, cache_len=16, content_cache=cache)
    for x in zipf.sample_trace(args.objects, args.requests, seed=1):
        engine.generate(Request(obj_id=int(x), tokens=prompts[int(x)], max_new=4))
    print(
        f"[serve] {args.policy}: CHR={cache.stats.chr:.3f} "
        f"prefill saved={engine.stats.prefill_tokens_saved} "
        f"computed={engine.stats.prefill_tokens_computed} mgmt={cache.stats.mgmt_time_s*1e3:.2f}ms"
    )


if __name__ == "__main__":
    main()
