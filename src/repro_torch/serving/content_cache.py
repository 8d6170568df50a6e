"""The paper's technique as a serving feature: a content/prefix cache whose
admission + eviction policy is pluggable (any name in core.registry: LRU /
LFU / PLFU / PLFUA / WLFU / TinyLFU / dynamic-PLFUA / GDSF — the reference
implementations from repro_torch.core.policies drive the decisions; this layer
adds payload storage and energy accounting).

A "content object" is whatever the engine wants to reuse per object id:
a prefill KV/latent/SSM-state cache, an encoder output, or generated text.
A hit skips prefill entirely — the CHR-vs-management-cost trade-off from the
paper, now priced in model FLOPs (core.energy.serving_energy).

A copy of the reference package's ``serving/content_cache.py`` on the port's
policies (it holds payloads of any kind, here the port's KV caches on the
card); the serving-energy model it names is not ported yet."""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

from repro_torch.core import policies as pol_mod


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    inserts: int = 0
    evictions: int = 0
    mgmt_time_s: float = 0.0  # the paper's metric: policy-management CPU time
    bytes_stored: int = 0

    @property
    def chr(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class ContentCache:
    """Fixed-capacity object cache with a paper-policy brain.

    The policy decides *membership*; this class keeps the payloads in sync
    with the policy's view and meters the management CPU time (the paper's
    §3 isolation: management only, payload moves are the engine's business).
    """

    def __init__(
        self,
        capacity: int,
        policy: str = "plfua",
        *,
        n_objects: int | None = None,
        hot: list[int] | None = None,
        window: int | None = None,
        sizes=None,
        capacity_bytes: int = 0,
        max_victims: int = 0,
        size_of: Callable[[Any], int] = lambda p: 1,
        policy_obj: pol_mod.CachePolicy | None = None,
    ):
        # a prebuilt brain (e.g. fleet.build_policy(PolicySpec) with sketch /
        # doorkeeper parameters the name+kwargs surface doesn't carry) wins.
        # ``sizes``/``capacity_bytes``/``max_victims`` switch the brain to
        # byte-capacity semantics (core.policies byte mode); ``size_of`` keeps
        # metering *payload* bytes independently — policy bytes are the
        # catalogue's declared sizes, stored bytes are whatever the engine
        # actually materialised.
        if policy_obj is None:
            policy_obj = pol_mod.make_policy(
                policy,
                capacity,
                n_objects=n_objects,
                hot=hot,
                window=window,
                sizes=sizes,
                capacity_bytes=capacity_bytes,
                max_victims=max_victims,
            )
        self.policy = policy_obj
        self._payloads: dict[int, Any] = {}
        self._size_of = size_of
        self.stats = CacheStats()

    def lookup(self, obj_id: int, fill: bool = True) -> Any | None:
        """One request against the cache. Returns the payload on a hit.

        On a miss the policy has already decided whether the object is
        *admitted* — call ``offer`` with the payload afterwards to store it.
        ``fill=False`` (the fleet's cross-tier placement gate) still runs the
        policy's demand bookkeeping but withholds admission, so neither the
        brain nor a later ``offer`` stores the object.
        """
        t0 = time.perf_counter()
        hit = self.policy.request(obj_id, fill=fill)
        self.stats.mgmt_time_s += time.perf_counter() - t0
        if hit and obj_id in self._payloads:
            self.stats.hits += 1
            return self._payloads[obj_id]
        self.stats.misses += 1
        return None

    def peek(self, obj_id: int) -> Any | None:
        """The stored payload iff the brain still owns the object — a pure
        probe: no policy request, no stats (the fleet front's serve-level
        discovery before it applies placement-gated lookups)."""
        if self.policy.contains(obj_id):
            return self._payloads.get(obj_id)
        return None

    def offer(self, obj_id: int, payload: Any) -> bool:
        """Store the payload iff the policy admitted the object on lookup."""
        t0 = time.perf_counter()
        admitted = self.policy.contains(obj_id)
        self.stats.mgmt_time_s += time.perf_counter() - t0
        if not admitted:
            return False
        old = self._payloads.get(obj_id)
        if old is not None:
            # replacing a stored payload must not double-count its bytes
            self.stats.bytes_stored -= self._size_of(old)
        self._payloads[obj_id] = payload
        self.stats.inserts += 1
        self.stats.bytes_stored += self._size_of(payload)
        self._sync_evictions()
        return True

    def _sync_evictions(self):
        """Drop payloads the policy has evicted since the last sync."""
        dead = [k for k in self._payloads if not self.policy.contains(k)]
        for k in dead:
            self.stats.bytes_stored -= self._size_of(self._payloads[k])
            del self._payloads[k]
            self.stats.evictions += 1

    @property
    def metadata_entries(self) -> int:
        return self.policy.metadata_entries

    def __len__(self) -> int:
        return len(self._payloads)
