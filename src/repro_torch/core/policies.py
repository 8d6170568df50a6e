"""Paper-faithful reference implementations of the cache policies.

A copy of the reference package's ``core/policies.py`` on the port's
``registry`` and ``sketch``, so the port imports nothing of it; it drives the
serving layer's content cache (:mod:`repro_torch.serving.content_cache`).
``tests/test_torch_serving.py`` holds every kind's decisions to the
reference's. The text below is the reference's own: "the JAX tier" is the
reference's simulator, whose port is :mod:`repro_torch.core.torch_cache`.

These are the *baseline* implementations whose total CPU time is the paper's
headline metric (§3): they manage metadata only — no content bytes are stored
or moved — so timing the request loop times the policy itself.

Implemented policies:
  * LRU      — recency eviction (paper §1.1 baseline).
  * LFU      — in-memory LFU: frequency metadata exists only while an object is
               cached; eviction resets it, so a re-admitted object restarts at 1
               (the paper's Fig. 2(a) "red column" pathology).
  * PLFU     — Perfect LFU: evicted objects keep their frequency in a
               *parked-list*; re-admission resumes from the parked value.
  * PLFUA    — the paper's contribution: PLFU eviction + an admission policy
               that only admits a known hot set (2x cache size by prior
               popularity). Metadata exists only for hot objects.
  * WLFU     — Window-LFU [Karakostas & Serpanos 2000]: frequency over the last
               W requests.
  * TinyLFU  — [Einziger et al. 2017]: count-min-sketch admission filter over
               LFU eviction (frequency comparison incoming vs victim).
  * PLFUA-dyn — beyond-paper: PLFUA whose hot set is *recomputed* every
               ``refresh`` requests from count-min-sketch top-k estimates,
               fixing the static hot set's collapse under popularity churn.

  * GDSF     — GreedyDual-Size-Frequency [Cherkasova 1998]: priority
               H(x) = L + freq(x)/size(x) with a global aging credit L that
               ratchets to each evicted victim's priority; evicted objects
               park their frequency (ghost entries), like PLFU.

  * ARC      — Adaptive Replacement Cache [Megiddo & Modha 2003]: two
               resident lists (T1 recency, T2 frequency) plus two ghost
               lists (B1/B2) remembering recent evictions; an integer target
               ``p`` adapts the T1/T2 split towards whichever ghost list is
               being re-requested. Scan-resistant: one-touch sweeps churn
               only T1 while the re-referenced working set survives in T2.

All frequency policies break eviction ties by lowest object id, and all are
"implemented in the same manner" (paper §1.1): dict metadata + a lazy min-heap
for eviction, so CPU-time comparisons between them are apples-to-apples.
The vectorised JAX/Pallas implementations are validated against these
references decision-for-decision (same hits, same evictions).

Byte-capacity mode: every policy accepts ``sizes`` (per-object int
sizes, unit when omitted) plus ``capacity_bytes``; when ``capacity_bytes > 0``
the object-count limit is replaced by a byte budget and an insertion evicts
up to ``max_victims`` victims (bounded, mirrored exactly by the jitted
step's ``lax.fori_loop``) until the incoming object fits — if it still does
not fit (or is larger than the whole budget, in which case nothing is
evicted) the object is not stored, though demand metadata still updates.
With unit sizes and ``capacity_bytes == capacity`` this reproduces the
object-capacity decisions bit for bit (tests/test_bytes.py).
"""
from __future__ import annotations

import heapq
from collections import OrderedDict
from typing import Iterable

import numpy as np

from repro_torch.core import registry, sketch

__all__ = [
    "CachePolicy",
    "LRUCache",
    "LFUCache",
    "PLFUCache",
    "PLFUACache",
    "WLFUCache",
    "TinyLFUCache",
    "DynamicPLFUACache",
    "GDSFCache",
    "ARCCache",
    "make_policy",
    "POLICY_NAMES",
    "GDSF_SHIFT",
    "DEFAULT_MAX_VICTIMS",
]

# Shared fixed-point / eviction-bound constants live in the registry (the one
# import-cycle-free module) so the JAX scan and Pallas kernel use the same
# values; re-exported here because this module is the reference semantics.
GDSF_SHIFT = registry.GDSF_SHIFT
DEFAULT_MAX_VICTIMS = registry.DEFAULT_MAX_VICTIMS


class CachePolicy:
    """Base: fixed-capacity cache over integer object ids.

    ``capacity`` counts objects. ``capacity_bytes > 0`` switches the limit to
    a byte budget over per-object ``sizes`` (unit when omitted): insertions
    evict up to ``max_victims`` victims until the object fits — see the
    module docstring for the exact (bounded) semantics shared with
    ``core.jax_cache.step``.
    """

    name = "base"

    def __init__(
        self,
        capacity: int,
        *,
        sizes=None,
        capacity_bytes: int = 0,
        max_victims: int = 0,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.capacity_bytes = int(capacity_bytes)
        if self.capacity_bytes < 0:
            raise ValueError(f"capacity_bytes must be >= 0, got {capacity_bytes}")
        self.max_victims = int(max_victims) or DEFAULT_MAX_VICTIMS
        if self.max_victims < 1:
            raise ValueError(f"max_victims must be >= 1, got {max_victims}")
        self.sizes = None if sizes is None else np.asarray(sizes, np.int64)
        if self.sizes is not None and self.sizes.size and self.sizes.min() < 1:
            raise ValueError("object sizes must be >= 1")
        self.bytes = 0  # resident bytes (byte mode; unit sizes otherwise)
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # -- byte-capacity shared machinery --------------------------------------
    def _size(self, x: int) -> int:
        return 1 if self.sizes is None else int(self.sizes[x])

    def _room_for(self, x: int, count_fn, evict_one) -> bool:
        """Byte mode: evict (bounded) until ``x`` fits; True iff it does.

        Mirrors the jitted step's ``lax.fori_loop`` iteration for iteration:
        an object larger than the whole budget evicts nothing, and once
        ``max_victims`` victims are gone the insertion is abandoned even if
        more eviction would have made room."""
        sx = self._size(x)
        if sx <= self.capacity_bytes:
            for _ in range(self.max_victims):
                if self.bytes + sx <= self.capacity_bytes or count_fn() == 0:
                    break
                evict_one()
        return self.bytes + sx <= self.capacity_bytes

    # -- interface -----------------------------------------------------------
    def request(self, x: int, fill: bool = True) -> bool:
        """Process one request; returns True on hit.

        ``fill`` gates *insertion only* (the fleet's cross-tier placement
        hook, :mod:`repro.fleet.placement`): with ``fill=False`` a miss still
        updates the policy's demand metadata (window slide, sketch feed,
        parked-frequency bump — in-memory LFU parks too; only its
        *eviction* still destroys metadata) but the object is not stored.
        Mirrors the ``fill`` argument of ``core.jax_cache.step``
        decision-for-decision."""
        raise NotImplementedError

    def contains(self, x: int) -> bool:
        raise NotImplementedError

    @property
    def metadata_entries(self) -> int:
        """Number of live metadata entries (the paper's §4 metadata metric)."""
        raise NotImplementedError

    # -- shared --------------------------------------------------------------
    @property
    def chr(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def run(self, trace: Iterable[int]) -> None:
        req = self.request
        for x in trace:
            req(x)


class LRUCache(CachePolicy):
    name = "lru"

    def __init__(self, capacity: int, **kw):
        super().__init__(capacity, **kw)
        self._od: OrderedDict[int, None] = OrderedDict()

    def _evict_lru(self) -> None:
        victim, _ = self._od.popitem(last=False)
        self.bytes -= self._size(victim)
        self.evictions += 1

    def request(self, x: int, fill: bool = True) -> bool:
        od = self._od
        if x in od:
            od.move_to_end(x)
            self.hits += 1
            return True
        self.misses += 1
        if not fill:
            return False
        if self.capacity_bytes:
            if not self._room_for(x, lambda: len(od), self._evict_lru):
                return False
        elif len(od) >= self.capacity:
            self._evict_lru()
        od[x] = None
        self.bytes += self._size(x)
        return False

    def contains(self, x: int) -> bool:
        return x in self._od

    @property
    def metadata_entries(self) -> int:
        return len(self._od)


class _HeapLFUBase(CachePolicy):
    """Shared eviction machinery for the frequency policies.

    Two decision-identical implementations (victim = min by (freq, id)):
      * evict="heap" (default): lazy min-heap of (freq, id) snapshots —
        O(log C) amortised; frequencies only grow while cached, so popping
        until live yields the exact minimum.
      * evict="scan": O(C) linear scan per eviction — the paper's cost
        profile. Fig. 4's CPU ridge at *intermediate* cache sizes only exists
        under this cost model (eviction cost ~ evictions x C); the heap
        implementation moves the CPU optimum to the smallest cache
        (EXPERIMENTS.md §Paper reproduction).
    """

    def __init__(self, capacity: int, evict: str = "heap", **kw):
        super().__init__(capacity, **kw)
        self._freq: dict[int, int] = {}  # cached object -> frequency
        self._heap: list[tuple[int, int]] = []
        self._scan = evict == "scan"

    def contains(self, x: int) -> bool:
        return x in self._freq

    def _bump(self, x: int, f: int) -> None:
        self._freq[x] = f
        if not self._scan:
            heapq.heappush(self._heap, (f, x))

    def _evict_min(self) -> int:
        freq = self._freq
        if self._scan:
            victim = min(freq, key=lambda o: (freq[o], o))
            del freq[victim]
        else:
            heap = self._heap
            while True:
                f, victim = heapq.heappop(heap)
                if freq.get(victim) == f:
                    del freq[victim]
                    break
        self.bytes -= self._size(victim)
        self.evictions += 1
        return victim


class LFUCache(_HeapLFUBase):
    """In-memory LFU: frequency restarts at 1 after every (re-)admission.

    *Eviction* still destroys the cached frequency (the paper's Fig. 2(a)
    red-column pathology is preserved), but *placement-gated* misses park
    demand evidence exactly like PLFU: an unfilled miss bumps a parked
    counter and a later admission resumes from it, so ``lcd`` promotes LFU
    objects with their accumulated counts instead of resetting them
    (``jax_cache.step`` mirrors this with ``touch = hit | admitted`` for
    every frequency kind)."""

    name = "lfu"

    def __init__(self, capacity: int, evict: str = "heap", **kw):
        super().__init__(capacity, evict=evict, **kw)
        self._parked: dict[int, int] = {}  # unfilled-miss demand evidence

    def request(self, x: int, fill: bool = True) -> bool:
        freq = self._freq
        f = freq.get(x)
        if f is not None:
            self.hits += 1
            self._bump(x, f + 1)
            return True
        self.misses += 1
        if not fill:
            self._parked[x] = self._parked.get(x, 0) + 1
            return False
        fnew = self._parked.pop(x, 0) + 1  # resume parked demand
        if self.capacity_bytes:
            if not self._room_for(x, lambda: len(freq), self._evict_min):
                self._parked[x] = fnew  # did not fit: evidence stays parked
                return False
        elif len(freq) >= self.capacity:
            self._evict_min()
        self._bump(x, fnew)  # frequency recommences on (re-)admission (§2.1)
        self.bytes += self._size(x)
        return False

    @property
    def metadata_entries(self) -> int:
        return len(self._freq) + len(self._parked)


class PLFUCache(_HeapLFUBase):
    """Perfect LFU: evicted frequencies persist in the parked-list (paper §2.2)."""

    name = "plfu"

    def __init__(self, capacity: int, evict: str = "heap", **kw):
        super().__init__(capacity, evict=evict, **kw)
        self._parked: dict[int, int] = {}  # evicted object -> last frequency

    def _evict_park(self) -> int:
        victim_f = self._freq_of_min()
        victim = self._evict_min()
        self._parked[victim] = victim_f
        return victim

    def request(self, x: int, fill: bool = True) -> bool:
        freq = self._freq
        f = freq.get(x)
        if f is not None:
            self.hits += 1
            self._bump(x, f + 1)
            return True
        self.misses += 1
        if not fill:
            # demand evidence accumulates in the parked-list even when
            # placement withholds the copy — promotion resumes from it
            self._parked[x] = self._parked.get(x, 0) + 1
            return False
        # resume from the parked frequency rather than restarting at 1
        fnew = self._parked.pop(x, 0) + 1
        if self.capacity_bytes:
            if not self._room_for(x, lambda: len(freq), self._evict_park):
                self._parked[x] = fnew  # did not fit: demand stays parked
                return False
        elif len(freq) >= self.capacity:
            self._evict_park()
        self._bump(x, fnew)
        self.bytes += self._size(x)
        return False

    def _freq_of_min(self) -> int:
        freq = self._freq
        if self._scan:
            return min(freq.values())
        heap = self._heap
        while True:
            f, victim = heap[0]
            if freq.get(victim) == f:
                return f
            heapq.heappop(heap)

    @property
    def metadata_entries(self) -> int:
        return len(self._freq) + len(self._parked)


class PLFUACache(CachePolicy):
    """PLFU eviction + hot-set admission (the paper's PLFUA, §4).

    ``hot`` is the prior-popularity hot set (ids). The paper labels twice as
    many objects as the cache size as hot. Non-hot objects are never admitted
    and carry no metadata, so metadata is bounded by |hot| (the 4–50 % claim).
    Within the hot set, eviction semantics are exactly PLFU.
    """

    name = "plfua"

    def __init__(self, capacity: int, hot: Iterable[int], **kw):
        super().__init__(capacity, **kw)
        self._hot = frozenset(int(h) for h in hot)
        self._plfu = PLFUCache(capacity, **kw)

    def request(self, x: int, fill: bool = True) -> bool:
        if x in self._hot:
            hit = self._plfu.request(x, fill=fill)
        else:
            hit = False
            self._plfu.misses += 1  # non-admitted request is still a miss
        self.hits = self._plfu.hits
        self.misses = self._plfu.misses
        self.evictions = self._plfu.evictions
        self.bytes = self._plfu.bytes
        return hit

    def contains(self, x: int) -> bool:
        return self._plfu.contains(x)

    @property
    def metadata_entries(self) -> int:
        return self._plfu.metadata_entries

    @property
    def hot_size(self) -> int:
        return len(self._hot)


class WLFUCache(CachePolicy):
    """Window-LFU: frequencies over the last ``window`` requests.

    Window counts can *decrease* (requests age out), so the lazy heap is
    invalid; eviction is a linear scan with (freq, id) tie-breaking.
    """

    name = "wlfu"

    def __init__(self, capacity: int, window: int = 10_000, **kw):
        super().__init__(capacity, **kw)
        self.window = int(window)
        self._wfreq: dict[int, int] = {}  # windowed frequency, all objects seen
        self._ring: list[int] = [-1] * self.window
        self._ptr = 0
        self._cache: set[int] = set()

    def _evict_wlfu(self) -> None:
        wfreq = self._wfreq
        victim = min(self._cache, key=lambda o: (wfreq.get(o, 0), o))
        self._cache.remove(victim)
        self.bytes -= self._size(victim)
        self.evictions += 1

    def request(self, x: int, fill: bool = True) -> bool:
        wfreq = self._wfreq
        # slide the window
        old = self._ring[self._ptr]
        if old >= 0:
            c = wfreq[old] - 1
            if c:
                wfreq[old] = c
            else:
                del wfreq[old]
        self._ring[self._ptr] = x
        self._ptr = (self._ptr + 1) % self.window
        wfreq[x] = wfreq.get(x, 0) + 1

        if x in self._cache:
            self.hits += 1
            return True
        self.misses += 1
        if not fill:
            return False
        if self.capacity_bytes:
            if not self._room_for(x, lambda: len(self._cache), self._evict_wlfu):
                return False
        elif len(self._cache) >= self.capacity:
            self._evict_wlfu()
        self._cache.add(x)
        self.bytes += self._size(x)
        return False

    def contains(self, x: int) -> bool:
        return x in self._cache

    @property
    def metadata_entries(self) -> int:
        return len(self._wfreq) + len(self._cache)


class TinyLFUCache(_HeapLFUBase):
    """TinyLFU admission over LFU eviction [Einziger et al. 2017].

    On a miss with a full cache, the incoming object is admitted only if its
    sketch-estimated frequency exceeds the eviction victim's; the sketch ages
    by halving every ``window`` requests. Sketch hashing/aging lives in
    :mod:`repro_torch.core.sketch`, shared bit-for-bit with the JAX tier.

    ``doorkeeper`` (bloom bits, 0 = off) puts a bloom filter in front of the
    sketch [Einziger et al. §3.4]: an object's *first* touch per aging window
    only marks the bloom — the sketch increments from the second touch on, so
    one-hit wonders (the long Zipf tail) never spend sketch counters. An
    estimate then adds back the bloom'd occurrence, and aging clears the
    bloom together with the halving.
    """

    name = "tinylfu"

    def __init__(
        self,
        capacity: int,
        window: int | None = None,
        sketch_width: int | None = None,
        doorkeeper: int = 0,
        **kw,
    ):
        super().__init__(capacity, **kw)
        self.window = int(window or sketch.default_window(capacity))
        self._sketch = sketch.CountMinSketch(sketch_width or sketch.default_width(capacity))
        self.doorkeeper = int(doorkeeper)
        self._bloom = sketch.BloomFilter(self.doorkeeper) if self.doorkeeper else None
        self._seen = 0

    def _estimate(self, x: int) -> int:
        est = self._sketch.estimate(x)
        if self._bloom is not None and self._bloom.contains(x):
            est += 1
        return est

    def request(self, x: int, fill: bool = True) -> bool:
        if self._bloom is None or self._bloom.contains(x):
            self._sketch.add(x)
        else:
            self._bloom.add(x)
        self._seen += 1
        if self._seen >= self.window:
            self._sketch.halve()
            if self._bloom is not None:
                self._bloom.clear()
            self._seen = 0

        freq = self._freq
        f = freq.get(x)
        if f is not None:
            self.hits += 1
            self._bump(x, f + 1)
            return True
        self.misses += 1
        if not fill:
            return False
        if self.capacity_bytes:
            # byte mode: "full" means the object does not fit as-is; a full
            # duel win frees room via the bounded loop (empty cache = no
            # victim to duel, so an over-budget object is simply rejected)
            full = self.bytes + self._size(x) > self.capacity_bytes
            if full and not (freq and self._estimate(x) > self._estimate(self._peek_min()[1])):
                return False
            if not self._room_for(x, lambda: len(freq), self._evict_min):
                return False
            self._bump(x, 1)
            self.bytes += self._size(x)
            return False
        if len(freq) < self.capacity:
            self._bump(x, 1)
            self.bytes += self._size(x)
            return False
        # admission duel: incoming vs victim, by (bloom-augmented) estimate
        vf, victim = self._peek_min()
        if self._estimate(x) > self._estimate(victim):
            self._evict_min()
            self._bump(x, 1)
            self.bytes += self._size(x)
        return False

    def _peek_min(self) -> tuple[int, int]:
        freq = self._freq
        heap = self._heap
        while True:
            f, victim = heap[0]
            if freq.get(victim) == f:
                return f, victim
            heapq.heappop(heap)

    @property
    def metadata_entries(self) -> int:
        bloom = self._bloom.bits.size if self._bloom is not None else 0
        return len(self._freq) + self._sketch.rows.size + bloom


class DynamicPLFUACache(CachePolicy):
    """PLFUA with a *dynamic* hot set refreshed from a count-min sketch.

    The paper's PLFUA fixes the hot set ahead of time, which collapses when
    popularity drifts (the ``churn`` scenario). Here every request feeds the
    sketch, and every ``refresh`` requests (a periodic wall-clock
    re-optimisation: the refresh fires *after* the request that completes the
    period) the hot set is recomputed as the top ``hot_size`` ids by sketch
    estimate (ties to the lowest id), after which the sketch is halved so
    estimates stay recency-weighted. The hot mask gates *admission only*: an
    object cached while hot keeps hitting until normal PLFU eviction removes
    it, even after it leaves the hot set.

    The initial hot set is the rank prefix ``[0, hot_size)`` — the same prior
    static PLFUA uses — so the two policies are identical until the first
    refresh. In a CDN fleet the refresh cadence is *global* time rather than
    per-instance request count: the hierarchy driver sets
    ``external_refresh = True`` and calls :meth:`refresh_now` on the timer
    (mirroring the jitted simulator's chunked scan).
    """

    name = "plfua_dyn"

    def __init__(
        self,
        capacity: int,
        n_objects: int,
        hot_size: int = 0,
        refresh: int = 0,
        sketch_width: int = 0,
        **kw,
    ):
        super().__init__(capacity, **kw)
        self.n_objects = int(n_objects)
        self.hot_size = min(self.n_objects, int(hot_size) or 2 * capacity)
        self.refresh = int(refresh) or sketch.default_refresh(capacity)
        self.external_refresh = False
        self._sketch = sketch.CountMinSketch(
            int(sketch_width) or sketch.default_width(capacity)
        )
        self._seen = 0
        self._hot = np.zeros(self.n_objects, dtype=bool)
        self._hot[: self.hot_size] = True
        self._plfu = PLFUCache(capacity, **kw)

    def refresh_now(self) -> None:
        """Recompute the hot set from the sketch, then age the sketch."""
        est = self._sketch.estimate_all(self.n_objects)
        top = np.lexsort((np.arange(self.n_objects), -est))[: self.hot_size]
        self._hot = np.zeros(self.n_objects, dtype=bool)
        self._hot[top] = True
        self._sketch.halve()
        self._seen = 0

    def request(self, x: int, fill: bool = True) -> bool:
        self._sketch.add(x)
        if self._plfu.contains(x) or self._hot[x]:
            hit = self._plfu.request(x, fill=fill)
        else:
            hit = False
            self._plfu.misses += 1  # non-admitted request is still a miss
        self.hits = self._plfu.hits
        self.misses = self._plfu.misses
        self.evictions = self._plfu.evictions
        self.bytes = self._plfu.bytes
        if not self.external_refresh:
            self._seen += 1
            if self._seen >= self.refresh:
                self.refresh_now()
        return hit

    def contains(self, x: int) -> bool:
        return self._plfu.contains(x)

    @property
    def hot(self) -> np.ndarray:
        return self._hot

    @property
    def metadata_entries(self) -> int:
        return self._plfu.metadata_entries + self._sketch.rows.size


class GDSFCache(CachePolicy):
    """GreedyDual-Size-Frequency [Cherkasova 1998], integer fixed-point.

    Priority of a cached object: ``H(x) = L + (freq(x) << GDSF_SHIFT) //
    size(x)`` — all int arithmetic so the JAX scan and the Pallas kernel
    reproduce it bit for bit. The global aging credit ``L`` starts at 0 and
    ratchets to each evicted victim's priority, so long-resident objects
    decay relative to fresh insertions without any per-step aging pass.
    Eviction takes the minimum priority, ties to the lowest id.

    Frequencies survive eviction in a parked-list (ghost entries), exactly
    like PLFU — and like PLFU, *every* miss (unfilled, unfit, or admitted)
    bumps the demand evidence, so ``lcd`` promotions resume with their
    accumulated counts. With unit sizes GDSF degenerates to PLFU-with-aging.

    Works in both capacity modes: object-count (``capacity``) or byte budget
    (``capacity_bytes`` + the bounded ``max_victims`` loop from the base
    class). The priority heap is lazy: priorities are non-decreasing per
    object while cached (L and freq only grow), so stale snapshots are
    simply skipped.
    """

    name = "gdsf"

    def __init__(self, capacity: int, *, n_objects: int | None = None, **kw):
        super().__init__(capacity, **kw)
        del n_objects  # accepted for factory uniformity; ids need no universe
        self._freq: dict[int, int] = {}  # cached object -> frequency
        self._score: dict[int, int] = {}  # cached object -> priority H
        self._parked: dict[int, int] = {}  # evicted/unfilled -> frequency
        self._heap: list[tuple[int, int]] = []  # lazy (H, id) snapshots
        self.L = 0  # global aging credit

    def _priority(self, x: int, f: int) -> int:
        return self.L + ((f << GDSF_SHIFT) // self._size(x))

    def _bump(self, x: int, f: int) -> None:
        self._freq[x] = f
        h = self._priority(x, f)
        self._score[x] = h
        heapq.heappush(self._heap, (h, x))

    def _evict_min(self) -> int:
        freq, score, heap = self._freq, self._score, self._heap
        while True:
            h, victim = heapq.heappop(heap)
            if score.get(victim) == h:
                self.L = h  # the aging credit ratchets to the victim's H
                self._parked[victim] = freq.pop(victim)
                del score[victim]
                self.bytes -= self._size(victim)
                self.evictions += 1
                return victim

    def request(self, x: int, fill: bool = True) -> bool:
        f = self._freq.get(x)
        if f is not None:
            self.hits += 1
            self._bump(x, f + 1)  # re-priced under the current L
            return True
        self.misses += 1
        if not fill:
            self._parked[x] = self._parked.get(x, 0) + 1
            return False
        fnew = self._parked.pop(x, 0) + 1
        if self.capacity_bytes:
            if not self._room_for(x, lambda: len(self._freq), self._evict_min):
                self._parked[x] = fnew  # did not fit: demand stays parked
                return False
        elif len(self._freq) >= self.capacity:
            self._evict_min()
        self._bump(x, fnew)  # priced under the post-eviction L
        self.bytes += self._size(x)
        return False

    def contains(self, x: int) -> bool:
        return x in self._freq

    @property
    def metadata_entries(self) -> int:
        return len(self._freq) + len(self._parked)


class ARCCache(CachePolicy):
    """Adaptive Replacement Cache [Megiddo & Modha 2003, FAST'03].

    Four lists over the id space, pairwise disjoint:

      * T1 — residents seen exactly once recently (recency side)
      * T2 — residents seen at least twice (frequency side)
      * B1 — ghosts of objects evicted from T1 (metadata only)
      * B2 — ghosts of objects evicted from T2

    Invariants (property-tested in tests/test_arc.py): ``|T1|+|T2| <= c``,
    ``|T1|+|B1| <= c``, ``|T1|+|T2|+|B1|+|B2| <= 2c``, ``0 <= p <= c``.
    The adaptation target ``p`` is the desired size of T1: a hit in B1
    (evicted-from-recency demand) grows it, a hit in B2 shrinks it, with
    the classic integer deltas ``max(1, |B_other| // |B_hit|)``.

    Placement-gated misses (``fill=False``) park *ghost* metadata only: a
    ghost hit still adapts ``p`` and refreshes the ghost to MRU; a cold miss
    enters B1 as a ghost (trimming other ghosts, never residents — a parking
    that would require a resident eviction is skipped). Flat runs
    (``fill=True`` throughout) are exactly textbook ARC.

    REPLACE's eviction is additionally gated on the cache actually being
    full — in flat ARC the cache is provably full whenever REPLACE runs, so
    the guard is bit-neutral there, and under placement gating it stops a
    ghost-hit promotion from evicting out of a half-empty cache.

    Byte-capacity mode is not supported (the T1/T2 balance point ``p`` is
    defined in object slots); the constructor rejects ``capacity_bytes``.
    """

    name = "arc"

    def __init__(self, capacity: int, **kw):
        super().__init__(capacity, **kw)
        if self.capacity_bytes:
            raise ValueError("arc does not support byte-capacity mode")
        self._t1: OrderedDict[int, None] = OrderedDict()
        self._t2: OrderedDict[int, None] = OrderedDict()
        self._b1: OrderedDict[int, None] = OrderedDict()
        self._b2: OrderedDict[int, None] = OrderedDict()
        self.p = 0

    def _replace(self, in_b2: bool) -> None:
        """Demote the LRU of T1 or T2 to the MRU of its ghost list.

        Evicts from T1 when ``|T1| > p`` (or ``|T1| == p`` on a B2 hit, or
        T2 is empty), else from T2 — the textbook rule, guarded on fullness
        so placement-parked states never evict below a full cache."""
        t1, t2 = self._t1, self._t2
        if len(t1) + len(t2) < self.capacity:
            return
        t1n = len(t1)
        from_t1 = t1n >= 1 and (
            (in_b2 and t1n == self.p) or t1n > self.p or not t2
        )
        if from_t1:
            victim, _ = t1.popitem(last=False)
            self._b1[victim] = None
        else:
            victim, _ = t2.popitem(last=False)
            self._b2[victim] = None
        self.bytes -= self._size(victim)
        self.evictions += 1

    def request(self, x: int, fill: bool = True) -> bool:
        t1, t2, b1, b2 = self._t1, self._t2, self._b1, self._b2
        c = self.capacity
        if x in t1 or x in t2:  # Case I: resident hit -> MRU of T2
            self.hits += 1
            (t1 if x in t1 else t2).pop(x)
            t2[x] = None
            return True
        self.misses += 1
        in_b1, in_b2 = x in b1, x in b2
        if in_b1 or in_b2:  # Case II/III: ghost hit
            if in_b1:
                self.p = min(c, self.p + max(1, len(b2) // max(1, len(b1))))
            else:
                self.p = max(0, self.p - max(1, len(b1) // max(1, len(b2))))
            if not fill:
                # parked demand: p adapted above; the ghost refreshes to MRU
                g = b1 if in_b1 else b2
                g.pop(x)
                g[x] = None
                return False
            self._replace(in_b2)
            (b1 if in_b1 else b2).pop(x)
            t2[x] = None
            self.bytes += self._size(x)
            return False
        # Case IV: cold miss
        if not fill:
            # park x as a B1 ghost, trimming ghosts only (never residents)
            if len(t1) + len(b1) >= c:
                if not b1:
                    return False  # trimming would need a resident eviction
                b1.popitem(last=False)
            elif len(t1) + len(t2) + len(b1) + len(b2) >= 2 * c and b2:
                b2.popitem(last=False)
            b1[x] = None
            return False
        if len(t1) + len(b1) >= c:  # Case IV(a): recency side at capacity
            if b1:
                b1.popitem(last=False)
                self._replace(False)
            else:
                # T1 itself holds c residents: hard-drop its LRU, no ghost
                victim, _ = t1.popitem(last=False)
                self.bytes -= self._size(victim)
                self.evictions += 1
        else:  # Case IV(b)
            total = len(t1) + len(t2) + len(b1) + len(b2)
            if total >= c:
                if total >= 2 * c and b2:
                    b2.popitem(last=False)
                self._replace(False)
        t1[x] = None
        self.bytes += self._size(x)
        return False

    def contains(self, x: int) -> bool:
        return x in self._t1 or x in self._t2

    @property
    def metadata_entries(self) -> int:
        """Residents + ghosts: ARC's metadata footprint is up to 2c entries."""
        return len(self._t1) + len(self._t2) + len(self._b1) + len(self._b2)


POLICY_NAMES = registry.names(reference=True)


def make_policy(
    name: str,
    capacity: int,
    *,
    n_objects: int | None = None,
    hot: Iterable[int] | None = None,
    window: int | None = None,
    refresh: int = 0,
    sketch_width: int = 0,
    doorkeeper: int = 0,
    evict: str = "heap",
    sizes=None,
    capacity_bytes: int = 0,
    max_victims: int = 0,
) -> CachePolicy:
    """Factory. PLFUA needs a hot set: explicit ``hot`` ids, or the rank prefix
    [0, 2*capacity) when ids are popularity ranks (our Zipf traces); plfua_dyn
    needs ``n_objects`` (the id universe its sketch ranks over).
    ``evict``: "heap" (optimised) or "scan" (the paper's O(C) cost profile).
    ``sizes``/``capacity_bytes``/``max_victims`` enable byte-capacity mode on
    any kind (see the module docstring)."""
    name = name.lower()
    bkw = dict(sizes=sizes, capacity_bytes=capacity_bytes, max_victims=max_victims)
    if name == "lru":
        return LRUCache(capacity, **bkw)
    if name == "lfu":
        return LFUCache(capacity, evict=evict, **bkw)
    if name == "plfu":
        return PLFUCache(capacity, evict=evict, **bkw)
    if name == "plfua":
        if hot is None:
            hi = 2 * capacity if n_objects is None else min(n_objects, 2 * capacity)
            hot = range(hi)
        return PLFUACache(capacity, hot, **bkw)
    if name == "wlfu":
        return WLFUCache(capacity, window or 10_000, **bkw)
    if name == "tinylfu":
        return TinyLFUCache(capacity, window, sketch_width or None, doorkeeper, **bkw)
    if name == "plfua_dyn":
        if n_objects is None:
            raise ValueError("plfua_dyn requires n_objects (sketch id universe)")
        return DynamicPLFUACache(
            capacity, n_objects, refresh=refresh, sketch_width=sketch_width, **bkw
        )
    if name == "gdsf":
        return GDSFCache(capacity, n_objects=n_objects, **bkw)
    if name == "arc":
        return ARCCache(capacity, **bkw)
    raise ValueError(f"unknown policy {name!r}; expected one of {POLICY_NAMES}")
