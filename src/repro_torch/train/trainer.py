"""Training orchestration: resume-from-latest, periodic async checkpoints,
preemption-signal save, per-step timing stats (straggler detection) and a
watchdog budget around train_step. The port of the reference's
``train/trainer.py``; the step is eager PyTorch (no ``jax.jit``, no
``torch.compile``) on the model's device.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.models.model import Model
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train.data import ZipfBigramStream
from repro_torch.train.train_step import TrainConfig, init_train_state, make_train_step


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 200
    ckpt_every: int = 50
    ckpt_dir: str = "checkpoints"
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0  # step time > factor*median -> flagged
    watchdog_budget_s: float = 600.0  # no progress for this long -> abort


@dataclasses.dataclass
class StepStats:
    times: list = dataclasses.field(default_factory=list)
    stragglers: int = 0

    def record(self, dt: float, factor: float) -> bool:
        med = float(np.median(self.times)) if self.times else dt
        self.times.append(dt)
        if len(self.times) > 200:
            self.times.pop(0)
        slow = len(self.times) > 10 and dt > factor * med
        self.stragglers += int(slow)
        return slow


class Trainer:
    def __init__(
        self,
        model: Model,
        tcfg: TrainConfig,
        run_cfg: TrainerConfig,
        stream: ZipfBigramStream,
        train_step: Callable | None = None,
    ):
        self.model = model
        self.tcfg = tcfg
        self.cfg = run_cfg
        self.stream = stream
        self.step_fn = train_step or make_train_step(model, tcfg)
        self.saver = ckpt_mod.AsyncSaver()
        self.stats = StepStats()
        self._preempted = False
        self.history: list[dict] = []

    # -- fault tolerance -----------------------------------------------------
    def install_preemption_handler(self):
        """Save and stop at the next step boundary on SIGTERM. Returns the
        handler it replaced (to put back with ``signal.signal``)."""
        def handler(signum, frame):  # pragma: no cover - signal timing
            self._preempted = True

        return signal.signal(signal.SIGTERM, handler)

    def _init_or_resume(self, seed: int = 0):
        gen = torch.Generator(device=self.model.device).manual_seed(seed)
        params, opt_state = init_train_state(self.model, self.tcfg, gen)
        state = {"params": params, "opt": opt_state}
        try:
            step, state = ckpt_mod.restore(self.cfg.ckpt_dir, state, device=self.model.device)
            print(f"[trainer] resumed from step {step}")
            return step, state["params"], state["opt"]
        except FileNotFoundError:
            return 0, params, opt_state

    # -- main loop -------------------------------------------------------------
    def run(self, seed: int = 0) -> dict:
        """Train from the newest valid checkpoint in ``cfg.ckpt_dir`` (else
        from weights drawn from ``seed``) to ``cfg.total_steps``; then
        ``self.state`` holds the last params and optimizer state."""
        start_step, params, opt_state = self._init_or_resume(seed)
        last_progress = time.time()
        step = start_step
        while step < self.cfg.total_steps:
            batch = self.stream.batch(step)
            t0 = time.time()
            params, opt_state, metrics = self.step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])  # blocks; acts as the step barrier
            dt = time.time() - t0
            slow = self.stats.record(dt, self.cfg.straggler_factor)
            step += 1
            last_progress = time.time()
            self.history.append({"step": step, "loss": loss, "dt": dt})
            if step % self.cfg.log_every == 0 or step == 1:
                print(
                    f"[trainer] step {step} loss {loss:.4f} "
                    f"({dt*1e3:.0f} ms{' STRAGGLER' if slow else ''})"
                )
            if step % self.cfg.ckpt_every == 0 or step == self.cfg.total_steps:
                self.saver.save(
                    self.cfg.ckpt_dir, step,
                    {"params": params, "opt": opt_state},
                    meta={"loss": loss}, keep=self.cfg.keep,
                )
            if self._preempted:
                self.saver.wait()
                ckpt_mod.save(
                    self.cfg.ckpt_dir, step, {"params": params, "opt": opt_state},
                    meta={"preempted": True}, keep=self.cfg.keep,
                )
                print(f"[trainer] preempted at step {step}; state saved")
                break
            if time.time() - last_progress > self.cfg.watchdog_budget_s:  # pragma: no cover
                raise RuntimeError("watchdog: no progress within budget")
        self.saver.wait()
        self.state = {"params": params, "opt": opt_state}
        return {
            "final_step": step,
            "final_loss": self.history[-1]["loss"] if self.history else None,
            "stragglers": self.stats.stragglers,
            "history": self.history,
        }
