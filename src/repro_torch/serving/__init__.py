"""Serving layer: the paper's cache policies drive the content/prefix cache
in front of the engine (the port of the reference's ``serving``; the fleet
front, ``FleetContentCache``, waits for the placed fleet engine's placement
path, ROADMAP module 8)."""
from repro_torch.serving.content_cache import CacheStats, ContentCache
from repro_torch.serving.engine import EngineStats, Request, Result, ServeEngine
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig

__all__ = [
    "CacheStats",
    "ContentCache",
    "EngineStats",
    "Request",
    "Result",
    "ServeEngine",
    "Scheduler",
    "SchedulerConfig",
]
