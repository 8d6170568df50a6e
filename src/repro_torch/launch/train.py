"""Training launcher: the port of the reference's ``launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --steps 100 --reduced --device cpu

The reference launcher's flags and output lines, plus ``--device`` (``cuda``
by default; ``cpu`` runs the plain PyTorch path), as ``launch/serve.py`` has
it. It drives the ``Trainer`` on one device: resume from the newest
checkpoint in ``--ckpt-dir``, checkpoints every quarter of the run, a save on
SIGTERM.
"""
from __future__ import annotations

import argparse
import signal


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default="checkpoints/run")
    ap.add_argument("--reduced", action="store_true", help="smoke-scale config")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch._device import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.train.data import DataConfig, ZipfBigramStream
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import TrainConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build(cfg, device=device)
    print(f"[launch] {cfg.name}: {model.n_params/1e9:.3f}B params on {device}")
    stream = ZipfBigramStream(DataConfig(cfg.vocab_size, args.seq, args.global_batch))
    tcfg = TrainConfig(
        opt=OptConfig(lr=1e-3, total_steps=args.steps), compress_grads=args.compress_grads
    )
    trainer = Trainer(
        model, tcfg,
        TrainerConfig(total_steps=args.steps, ckpt_every=max(10, args.steps // 4), ckpt_dir=args.ckpt_dir),
        stream,
    )
    previous = trainer.install_preemption_handler()
    try:
        out = trainer.run()
    finally:
        signal.signal(signal.SIGTERM, previous)
    print(f"[launch] done: step {out['final_step']} loss {out['final_loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
