"""Serving layer: the paper's cache policies drive the content/prefix cache
in front of the engine, a single node (``ContentCache``) or a routed tree of
them with the fleet's placements (``FleetContentCache``); the port of the
reference's ``serving``."""
from repro_torch.serving.content_cache import CacheStats, ContentCache
from repro_torch.serving.engine import EngineStats, Request, Result, ServeEngine
from repro_torch.serving.fleet_cache import FleetContentCache
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig

__all__ = [
    "CacheStats",
    "ContentCache",
    "EngineStats",
    "FleetContentCache",
    "Request",
    "Result",
    "ServeEngine",
    "Scheduler",
    "SchedulerConfig",
]
