"""Request scheduling: batching, deadlines, straggler mitigation.

The fleet-facing layer above the engine: requests arrive with deadlines and
are grouped into decode batches; requests that exceed their deadline mid-
flight are dropped (and counted) rather than stalling the batch — the serving
analogue of straggler mitigation in the training loop.

A copy of the reference package's ``serving/scheduler.py`` over the port's
engine.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from collections import deque
from typing import Callable

from repro_torch.serving.engine import Request, Result, ServeEngine


@dataclasses.dataclass
class SchedulerConfig:
    max_batch: int = 8
    deadline_s: float = 60.0


@dataclasses.dataclass
class SchedulerStats:
    completed: int = 0
    dropped: int = 0
    batches: int = 0


class Scheduler:
    def __init__(self, engine: ServeEngine, cfg: SchedulerConfig = SchedulerConfig()):
        self.engine = engine
        self.cfg = cfg
        self.queue: deque[tuple[float, Request]] = deque()
        self.stats = SchedulerStats()

    def submit(self, req: Request, now: float | None = None):
        self.queue.append((now if now is not None else time.time(), req))

    def drain(self) -> list[Result]:
        """Process the queue in arrival order, in batches of max_batch."""
        results: list[Result] = []
        while self.queue:
            batch: list[Request] = []
            while self.queue and len(batch) < self.cfg.max_batch:
                t_in, req = self.queue.popleft()
                if time.time() - t_in > self.cfg.deadline_s:
                    self.stats.dropped += 1  # straggler mitigation: shed, don't stall
                    continue
                batch.append(req)
            if not batch:
                continue
            self.stats.batches += 1
            for r in self.engine.run(batch):
                results.append(r)
                self.stats.completed += 1
        return results
