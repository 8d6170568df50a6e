"""Fixed-shape PyTorch formulation of the paper's cache policies.

The counterpart of the reference package's jitted simulator and the plain
version of the cache_sim kernel. Object ids are array indices, the cache is an
``in_cache`` mask, and the LFU frequency container and the PLFU parked-list
collapse into one dense ``freq`` vector (parked = freq of non-cached ids; LFU
zeroes the victim's entry on eviction). Eviction is a masked argmin whose ties
go to the lowest id.

Samples are the leading dimension of every tensor :func:`step` touches: that
is the reference's ``vmap`` written out. :func:`step` updates the state's
tensors in place (the reference is pure); :func:`simulate` and
:func:`simulate_batch` copy the state they are given first.

The port covers ``lru``, ``lfu``, ``plfu``, ``plfua``, ``wlfu``, ``tinylfu``
(with or without the doorkeeper) and ``plfua_dyn`` in object-count mode
without telemetry. ``gdsf``, ``arc``, per-object sizes, byte budgets and
telemetry raise ``NotImplementedError`` naming the ROADMAP item that brings
them.

plfua_dyn refreshes its hot set every ``effective_refresh`` requests counted
from the start of the run (the reference's global-time cadence); a run
continued from a handed-over state counts from its own start, so hand a
plfua_dyn state over only at a refresh boundary.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch._device import arange, resolve_device
from repro_torch.core import registry, sketch

_I32_MAX = torch.iinfo(torch.int32).max

#: kinds a PolicySpec accepts (the reference simulator's)
SPEC_KINDS = registry.names(jax=True)
#: kinds this module steps; the rest of SPEC_KINDS build a spec only
PORTED_KINDS = ("lru", "lfu", "plfu", "plfua", "wlfu", "tinylfu", "plfua_dyn")
#: kinds that carry count-min sketch rows (and an ``inserts`` counter)
SKETCH_KINDS = registry.names(sketch=True)

#: where each missing piece sits in ROADMAP.md
_ROADMAP = {
    "gdsf": "ROADMAP.md module 3 (gdsf)",
    "arc": "ROADMAP.md module 3 (arc)",
    "bytes": "ROADMAP.md module 3 (byte mode)",
    "telemetry": "ROADMAP.md module 4 (telemetry)",
}


def not_ported(what: str) -> NotImplementedError:
    """The error for a kind or option this slice does not cover."""
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet: see {_ROADMAP[what]}"
    )


@dataclasses.dataclass(frozen=True)
class PolicySpec:
    """Static policy configuration, field for field the reference's."""

    kind: str
    n_objects: int
    capacity: int
    hot_size: int = 0  # plfua/plfua_dyn; 0 means the "2 * capacity" convention
    window: int = 0  # wlfu (required) and tinylfu aging (0 -> sketch.default_window)
    refresh: int = 0  # plfua_dyn hot-set period (0 -> sketch.default_refresh)
    sketch_width: int = 0  # sketch kinds (0 -> sketch.default_width)
    doorkeeper: int = 0  # tinylfu bloom front, in bits (0 = off, the default)
    capacity_bytes: int = 0  # >0 switches the limit to a byte budget
    max_victims: int = 0  # byte mode eviction bound (0 -> DEFAULT_MAX_VICTIMS)

    def __post_init__(self):
        if self.kind not in SPEC_KINDS:
            raise ValueError(f"kind={self.kind!r} not in {SPEC_KINDS}")
        if self.kind == "wlfu" and self.window < 1:
            raise ValueError("wlfu requires window >= 1")
        if self.doorkeeper < 0:
            raise ValueError(f"doorkeeper must be >= 0, got {self.doorkeeper}")
        if self.doorkeeper and self.kind != "tinylfu":
            raise ValueError("doorkeeper is a tinylfu-only option")
        if self.capacity_bytes < 0:
            raise ValueError(f"capacity_bytes must be >= 0, got {self.capacity_bytes}")
        if self.kind == "arc" and self.capacity_bytes:
            # the T1/T2 balance target p is defined in object slots
            raise ValueError("arc does not support byte-capacity mode")
        if self.max_victims < 0:
            raise ValueError(f"max_victims must be >= 0, got {self.max_victims}")
        if self.max_victims and not self.capacity_bytes:
            raise ValueError("max_victims is a byte-capacity (capacity_bytes) option")

    @property
    def size_aware(self) -> bool:
        """Whether the step consults per-object sizes at all (gdsf always
        scores by size; every kind does under a byte budget)."""
        return self.capacity_bytes > 0 or self.kind == "gdsf"

    @property
    def effective_max_victims(self) -> int:
        return self.max_victims or registry.DEFAULT_MAX_VICTIMS

    @property
    def effective_hot(self) -> int:
        if self.kind not in ("plfua", "plfua_dyn"):
            return self.n_objects
        h = self.hot_size or 2 * self.capacity
        return min(self.n_objects, h)

    @property
    def effective_window(self) -> int:
        """TinyLFU sketch-aging window (wlfu keeps its mandatory window)."""
        if self.kind == "tinylfu":
            return self.window or sketch.default_window(self.capacity)
        return self.window

    @property
    def effective_refresh(self) -> int:
        return self.refresh or sketch.default_refresh(self.capacity)

    @property
    def effective_sketch_width(self) -> int:
        return self.sketch_width or sketch.default_width(self.capacity)

    def _bucket_table(self) -> np.ndarray:
        return sketch.bucket_table(np.arange(self.n_objects), self.effective_sketch_width)

    def _bloom_table(self) -> np.ndarray:
        return sketch.bloom_table(np.arange(self.n_objects), self.doorkeeper)


def _require_ported(spec: PolicySpec) -> None:
    if spec.kind not in PORTED_KINDS:
        raise not_ported(spec.kind)
    if spec.capacity_bytes:
        raise not_ported("bytes")


@functools.lru_cache(maxsize=16)
def _tables(spec: PolicySpec, device: torch.device):
    """The spec's sketch bucket table ``(N, DEPTH)`` and doorkeeper bloom
    table ``(N, BLOOM_DEPTH)`` (``None`` without a doorkeeper), int64 on
    ``device``; made once per spec and device, not once per step."""
    bloom = spec._bloom_table() if spec.kind == "tinylfu" and spec.doorkeeper else None
    as_index = lambda a: None if a is None else torch.as_tensor(a, device=device).long()
    return as_index(spec._bucket_table()), as_index(bloom)


def init_state(spec: PolicySpec, n_samples: int | None = None, device=None) -> dict:
    """Zero state, shaped like the reference's (``(N,)`` rows, ``()``
    scalars), or with a leading ``n_samples`` dimension when it is given.
    ``hot`` is the PLFUA admission mask (the rank-prefix hot set, which for
    plfua_dyn is the prior until the first refresh)."""
    _require_ported(spec)
    dev = resolve_device(device)
    lead = () if n_samples is None else (n_samples,)
    n = spec.n_objects
    zeros = lambda *shape, dtype=torch.int32: torch.zeros(lead + shape, dtype=dtype, device=dev)
    state = {"in_cache": zeros(n, dtype=torch.bool), "count": zeros()}
    if spec.kind == "lru":
        state["last"] = zeros(n)
        state["t"] = zeros()
    else:
        state["freq"] = zeros(n)
    if spec.kind in ("plfua", "plfua_dyn"):
        hot = torch.arange(n, device=dev) < spec.effective_hot
        state["hot"] = hot.expand(lead + (n,)).clone()
    if spec.kind == "wlfu":
        state["ring"] = torch.full(lead + (spec.window,), -1, dtype=torch.int32, device=dev)
        state["ptr"] = zeros()
    if spec.kind in SKETCH_KINDS:
        state["sketch"] = zeros(sketch.DEPTH, spec.effective_sketch_width)
        # admissions depend on the data, so the insert count is carried
        state["inserts"] = zeros()
    if spec.kind == "tinylfu":
        state["seen"] = zeros()  # aging-window position
        if spec.doorkeeper:
            state["bloom"] = zeros(spec.doorkeeper, dtype=torch.bool)
    return state


def state_from_numpy(spec: PolicySpec, np_state: dict, device=None) -> dict:
    """The port's state from the reference's (``jax_cache.init_state`` or the
    state ``jax_cache.simulate`` returns, as numpy arrays). Shapes are kept:
    a single-sample state stays unbatched, a batched one keeps its leading
    sample dimension."""
    _require_ported(spec)
    dev = resolve_device(device)
    want = set(init_state(spec, device="cpu"))
    if set(np_state) != want:
        raise ValueError(f"state keys {sorted(np_state)} != {sorted(want)} for {spec.kind}")
    return {k: torch.as_tensor(np.array(v), device=dev) for k, v in np_state.items()}


def state_to_numpy(spec: PolicySpec, state: dict) -> dict:
    """numpy arrays of the port's state, in the reference's keys and dtypes."""
    _require_ported(spec)
    return {k: v.detach().cpu().numpy() for k, v in state.items()}


def _masked_argmin(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """argmin over the last dim of ``values`` where mask, lowest index on ties
    (``torch.argmin`` returns the first minimal index)."""
    masked = torch.where(mask, values, torch.full_like(values, _I32_MAX))
    return masked.argmin(dim=-1)


def _i32(b: torch.Tensor) -> torch.Tensor:
    return b.to(torch.int32)


# The step functions below run once per request on the card too (as the
# kernel's yardstick), where every tensor operation is a kernel launch: they
# add bools to int32 counters directly and index samples with a shared arange.
def _wlfu_step(spec, state, rows, x, cap, fill):
    """Window-LFU: the ring of the last ``window`` ids slides *before* the
    hit test, and every miss inserts (``fill`` permitting)."""
    in_cache, count, freq, ring, ptr = (state[k] for k in ("in_cache", "count", "freq", "ring", "ptr"))
    slot = ptr.long()
    old = ring[rows, slot].long()
    freq[rows, old.clamp(min=0)] -= _i32(old >= 0)
    ring[rows, slot] = x.to(torch.int32)
    ptr.copy_((ptr + 1) % spec.window)
    freq[rows, x] += 1
    hit = in_cache[rows, x]
    insert = ~hit & fill
    need_evict = insert & (count >= cap)
    victim = _masked_argmin(freq, in_cache)
    in_cache[rows, victim] = in_cache[rows, victim] & ~need_evict
    in_cache[rows, x] = in_cache[rows, x] | insert
    count += insert
    count -= _i32(need_evict)
    return hit


def _tinylfu_step(spec, state, rows, x, cap, fill):
    """TinyLFU: sketch add (gated by the doorkeeper when it is on), then
    aging, then an admission duel of the request against the LFU victim by
    post-aging estimate; LFU eviction semantics (a victim's count dies, an
    insert restarts at 1)."""
    in_cache, count, freq, rows_sk, seen = (
        state[k] for k in ("in_cache", "count", "freq", "sketch", "seen"))
    table, btab = _tables(spec, in_cache.device)
    idx = table[x]
    if spec.doorkeeper:
        bloom = state["bloom"]
        bidx = btab[x]
        # first touch per window marks the bloom only; the sketch counts from
        # the second touch on
        sketch.rows_add(rows_sk, idx, sketch.bloom_contains(bloom, bidx))
        sketch.bloom_set(bloom, bidx)
    else:
        sketch.rows_add(rows_sk, idx)
    seen += 1
    age = seen >= spec.effective_window
    rows_sk >>= age[:, None, None].to(torch.int32)
    seen.masked_fill_(age, 0)
    if spec.doorkeeper:
        bloom &= ~age[:, None]

    hit = in_cache[rows, x]
    full = count >= cap
    victim = _masked_argmin(freq, in_cache)
    est_x = sketch.rows_estimate(rows_sk, idx)
    est_v = sketch.rows_estimate(rows_sk, table[victim])
    if spec.doorkeeper:
        # the doorkeeper'd occurrence counts back in (post-aging membership)
        est_x = est_x + sketch.bloom_contains(bloom, bidx)
        est_v = est_v + sketch.bloom_contains(bloom, btab[victim])
    admit = est_x > est_v
    insert = ~hit & (~full | admit) & fill
    need_evict = ~hit & full & admit & fill
    in_cache[rows, victim] = in_cache[rows, victim] & ~need_evict
    freq[rows, victim] = torch.where(need_evict, 0, freq[rows, victim])
    fx = freq[rows, x]
    freq[rows, x] = torch.where(hit, fx + 1, torch.where(insert, 1, fx))
    in_cache[rows, x] = in_cache[rows, x] | insert
    count += insert
    count -= _i32(need_evict)
    state["inserts"] += insert
    return hit


def step(spec: PolicySpec, state: dict, x: torch.Tensor, cap=None, fill=None):
    """One request per sample: ``x`` is ``(S,)`` ids, ``state`` batched.
    Updates ``state`` in place and returns ``(state, hit (S,) bool)``. The
    order of operations is the reference's.

    ``cap`` overrides ``spec.capacity`` (a scalar or an ``(S,)`` tensor).
    ``fill`` gates insertion and the eviction that makes room for it (a bool
    or an ``(S,)`` bool tensor); an unfilled miss still updates the policy's
    metadata (parked frequency, window, sketch), and lru still stamps it.
    ``None`` inserts always. plfua_dyn's hot-set refresh is not a step: see
    :func:`refresh_hot`."""
    _require_ported(spec)
    in_cache, count = state["in_cache"], state["count"]
    rows = arange(in_cache.shape[0], in_cache.device)
    x = x.to(device=in_cache.device, dtype=torch.long)
    cap = spec.capacity if cap is None else torch.as_tensor(cap, device=count.device)
    fill = True if fill is None else torch.as_tensor(fill, device=count.device)
    if spec.kind == "wlfu":
        return state, _wlfu_step(spec, state, rows, x, cap, fill)
    if spec.kind == "tinylfu":
        return state, _tinylfu_step(spec, state, rows, x, cap, fill)

    hit = in_cache[rows, x]
    key = state["last"] if spec.kind == "lru" else state["freq"]
    if spec.kind == "plfua_dyn":
        # the step only feeds the sketch; a dynamic hot set gates admission
        # only, so a cached object keeps hitting after it leaves the set
        sketch.rows_add(state["sketch"], _tables(spec, in_cache.device)[0][x])
        admitted = state["hot"][rows, x] | hit
    elif spec.kind == "plfua":
        admitted = state["hot"][rows, x]
    else:
        admitted = True
    want = ~hit & admitted & fill
    need_evict = want & (count >= cap)
    victim = _masked_argmin(key, in_cache)
    in_cache[rows, victim] = in_cache[rows, victim] & ~need_evict
    if spec.kind == "lfu":
        # in-memory LFU: eviction destroys the metadata -> restart from 1
        key[rows, victim] = torch.where(need_evict, 0, key[rows, victim])
    if spec.kind == "lru":
        key[rows, x] = state["t"]
        state["t"] += 1
    else:
        # PLFU/PLFUA: freq[x] of a non-cached object *is* the parked entry
        key[rows, x] += hit | admitted
    in_cache[rows, x] = in_cache[rows, x] | want
    count += want
    count -= _i32(need_evict)
    if spec.kind == "plfua_dyn":
        state["inserts"] += want
    return state, hit


def refresh_hot(spec: PolicySpec, state: dict) -> dict:
    """plfua_dyn hot-set refresh, in place: the new mask is the top
    ``effective_hot`` ids by sketch estimate (descending, ties to the lowest
    id: a stable sort, whose order ``torch.topk`` does not promise), then
    the sketch rows halve."""
    rows_sk = state["sketch"]
    est = sketch.rows_estimate_all(rows_sk, _tables(spec, rows_sk.device)[0])
    top = torch.argsort(-est, dim=-1, stable=True)[:, : spec.effective_hot]
    hot = state["hot"]
    hot.zero_()
    hot.scatter_(1, top, True)
    sketch.rows_halve(rows_sk)
    return state


def _check_options(spec, telemetry, sizes, groups):
    _require_ported(spec)
    if telemetry is not None or groups is not None:
        raise not_ported("telemetry")
    if sizes is not None:
        raise not_ported("bytes")


def simulate_batch(spec, traces, telemetry=None, sizes=None, groups=None, *, state=None, device=None):
    """Run ``(S, T)`` traces from a zero state, or from a copy of ``state``
    (batched, e.g. from :func:`state_from_numpy`). Returns ``(hits (S, T)
    bool, final state)``. ``telemetry``, ``sizes`` and ``groups`` must be
    ``None``: they are not ported yet.

    plfua_dyn refreshes its hot set after every whole ``effective_refresh``
    requests of this run (the reference's ``_chunked_scan``); a partial
    tail period never refreshes."""
    _check_options(spec, telemetry, sizes, groups)
    dev = resolve_device(device)
    traces = torch.as_tensor(traces, device=dev)
    if traces.ndim != 2:
        raise ValueError(f"traces must be (S, T), got shape {tuple(traces.shape)}")
    s, t = traces.shape
    if state is None:
        state = init_state(spec, n_samples=s, device=dev)
    else:
        state = {k: v.to(dev).clone() for k, v in state.items()}
    refresh = spec.effective_refresh if spec.kind == "plfua_dyn" else 0
    hits = torch.zeros((s, t), dtype=torch.bool, device=dev)
    for i in range(t):
        state, hit = step(spec, state, traces[:, i])
        hits[:, i] = hit
        if refresh and (i + 1) % refresh == 0:
            refresh_hot(spec, state)
    return hits, state


def simulate(spec, trace, telemetry=None, sizes=None, groups=None, *, state=None, device=None):
    """Run one ``(T,)`` trace. Returns ``(hits (T,) bool, final state)`` with
    the reference's unbatched shapes; ``state`` (unbatched) continues a run."""
    _check_options(spec, telemetry, sizes, groups)
    trace = torch.as_tensor(trace)
    if state is not None:
        state = {k: v.unsqueeze(0) for k, v in state.items()}
    hits, state = simulate_batch(spec, trace[None], state=state, device=device)
    return hits[0], {k: v[0] for k, v in state.items()}


def chr_of(hits: torch.Tensor) -> torch.Tensor:
    return hits.to(torch.float64).mean(dim=-1)


def metadata_entries(spec: PolicySpec, state: dict) -> torch.Tensor:
    """Live metadata entries: cached entries, plus parked ones for the
    frequency family (lfu parks only under the fill gate; its eviction still
    zeroes the victim), plus the sketch's counters for the sketch kinds
    (and tinylfu's doorkeeper bits); wlfu counts its window's distinct ids."""
    _require_ported(spec)
    count = state["count"]
    if spec.kind == "lru":
        return count
    if spec.kind == "wlfu":
        return (state["freq"] > 0).sum(dim=-1) + count
    sketch_size = sketch.DEPTH * spec.effective_sketch_width if spec.kind in SKETCH_KINDS else 0
    if spec.kind == "tinylfu":
        return count + sketch_size + spec.doorkeeper
    parked = ((state["freq"] > 0) & ~state["in_cache"]).sum(dim=-1)
    return count + parked + sketch_size


def eviction_count(spec: PolicySpec, hits, trace, state) -> int:
    """Total evictions implied by one :func:`simulate` run (host-side): every
    admitted miss inserts, so evictions = inserts - final occupancy. The
    sketch kinds carry the insert count in their state."""
    _require_ported(spec)
    count = int(state["count"])
    if spec.kind in SKETCH_KINDS:
        return int(state["inserts"]) - count
    hits = torch.as_tensor(hits).cpu().numpy()
    if spec.kind == "plfua":
        hot = np.arange(spec.n_objects) < spec.effective_hot
        inserts = int((~hits & hot[torch.as_tensor(trace).cpu().numpy()]).sum())
    else:
        inserts = int((~hits).sum())
    return inserts - count
