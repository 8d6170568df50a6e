"""CDN front: request routing over a tier's nodes.

Only :mod:`repro_torch.cdn.router` is ported so far: the fleet's topologies
and level routers need it (ROADMAP.md module 10 holds the rest of ``cdn``:
the two-tier hierarchy, its reference and its report).
"""
from repro_torch.cdn import router

__all__ = ["router"]
