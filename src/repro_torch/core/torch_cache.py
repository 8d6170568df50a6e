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

The port covers every kind of the reference simulator: ``lru``, ``lfu``,
``plfu``, ``plfua``, ``wlfu``, ``tinylfu`` (with or without the doorkeeper),
``plfua_dyn``, ``gdsf`` and ``arc``, in object-count mode and (all but arc)
under a byte budget over per-object ``sizes``. Telemetry raises
``NotImplementedError`` naming the ROADMAP item that brings it.

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
#: kinds this module steps: every spec kind
PORTED_KINDS = SPEC_KINDS
#: kinds that carry count-min sketch rows (and an ``inserts`` counter)
SKETCH_KINDS = registry.names(sketch=True)

#: where each missing piece sits in ROADMAP.md
_ROADMAP = {"telemetry": "ROADMAP.md module 4 (telemetry)"}
#: GDSF's fixed-point scale, registry.GDSF_SHIFT
GDSF_SHIFT = registry.GDSF_SHIFT
#: arc's list tags in ``lst``: 0 = untracked
T1, T2, B1, B2 = 1, 2, 3, 4


def not_ported(what: str) -> NotImplementedError:
    """The error for an option this slice does not cover."""
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
    plfua_dyn is the prior until the first refresh). Byte mode adds the
    resident ``bytes`` and, for the kinds without a sketch, ``inserts``."""
    dev = resolve_device(device)
    lead = () if n_samples is None else (n_samples,)
    n = spec.n_objects
    zeros = lambda *shape, dtype=torch.int32: torch.zeros(lead + shape, dtype=dtype, device=dev)
    state = {"in_cache": zeros(n, dtype=torch.bool), "count": zeros()}
    if spec.kind == "lru":
        state["last"] = zeros(n)
        state["t"] = zeros()
    elif spec.kind == "arc":
        # list tag per id (0 untracked, T1, T2, B1, B2) and entry stamp: a
        # list's LRU is its least-stamped member
        state["lst"] = zeros(n)
        state["stamp"] = zeros(n)
        state["p"] = zeros()  # adaptive T1 size target
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
    if spec.kind == "gdsf":
        state["score"] = zeros(n)  # cached priority H
        state["L"] = zeros()  # global aging credit
    if spec.capacity_bytes:
        state["bytes"] = zeros()  # resident bytes
        # whether a miss fits is data-dependent, so every kind carries its inserts
        state.setdefault("inserts", zeros())
    return state


def state_from_numpy(spec: PolicySpec, np_state: dict, device=None) -> dict:
    """The port's state from the reference's (``jax_cache.init_state`` or the
    state ``jax_cache.simulate`` returns, as numpy arrays). Shapes are kept:
    a single-sample state stays unbatched, a batched one keeps its leading
    sample dimension."""
    dev = resolve_device(device)
    want = set(init_state(spec, device="cpu"))
    if set(np_state) != want:
        raise ValueError(f"state keys {sorted(np_state)} != {sorted(want)} for {spec.kind}")
    return {k: torch.as_tensor(np.array(v), device=dev) for k, v in np_state.items()}


def state_to_numpy(spec: PolicySpec, state: dict) -> dict:
    """numpy arrays of the port's state, in the reference's keys and dtypes."""
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
class _Budget:
    """A step's byte budget: the request's size, the budget and the sizes
    row (``None`` = unit sizes), and the room-making that precedes an
    insert."""

    def __init__(self, spec, sizes, x, cap_bytes):
        self.spec, self.sizes = spec, sizes
        self.size_x = _sz(sizes, x)
        self.cap_b = spec.capacity_bytes if cap_bytes is None else cap_bytes

    def evict(self, state, rows, key, want, credit=None):
        """The reference's ``_evict_bytes_loop``, in place: evict the masked
        argmin of ``key`` until x fits, the cache is empty or
        ``effective_max_victims`` victims are gone; an object larger than the
        whole budget evicts nothing. lfu and tinylfu zero each victim's key,
        and gdsf's ``credit`` ratchets to each victim's score. ``need``
        never turns back to true, so once no sample needs a victim the
        reference's remaining iterations change nothing and are skipped."""
        in_cache, count, nbytes = state["in_cache"], state["count"], state["bytes"]
        size_x, cap_b = self.size_x, self.cap_b
        want_fits = want & (size_x <= cap_b)
        for _ in range(self.spec.effective_max_victims):
            need = want_fits & (nbytes + size_x > cap_b) & (count > 0)
            if not bool(need.any()):
                break
            v = _masked_argmin(key, in_cache)
            kv = key[rows, v]
            if credit is not None:
                credit.copy_(torch.where(need, kv, credit))
            in_cache[rows, v] = in_cache[rows, v] & ~need
            count -= _i32(need)
            nbytes -= _i32(need) * _sz(self.sizes, v)
            if self.spec.kind in ("lfu", "tinylfu"):
                key[rows, v] = torch.where(need, 0, kv)

    def insert(self, state, rows, key, want, credit=None):
        """Make room for x, then admit it if it fits: updates count, bytes
        and inserts, and returns the insert mask."""
        self.evict(state, rows, key, want, credit)
        insert = want & (state["bytes"] + self.size_x <= self.cap_b)
        state["count"] += insert
        state["bytes"] += _i32(insert) * self.size_x
        state["inserts"] += insert
        return insert


def _sz(sizes, i):
    """Per-object size lookup; ``sizes=None`` is the unit-size convention."""
    return 1 if sizes is None else sizes[i]


def _wlfu_step(spec, state, rows, x, cap, fill, budget):
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
    if budget is not None:
        insert = budget.insert(state, rows, freq, insert)
        in_cache[rows, x] = in_cache[rows, x] | insert
        return hit
    need_evict = insert & (count >= cap)
    victim = _masked_argmin(freq, in_cache)
    in_cache[rows, victim] = in_cache[rows, victim] & ~need_evict
    in_cache[rows, x] = in_cache[rows, x] | insert
    count += insert
    count -= _i32(need_evict)
    return hit


def _tinylfu_step(spec, state, rows, x, cap, fill, budget):
    """TinyLFU: sketch add (gated by the doorkeeper when it is on), then
    aging, then an admission duel of the request against the LFU victim by
    post-aging estimate; LFU eviction semantics (a victim's count dies, an
    insert restarts at 1). Under a byte budget "full" means x does not fit
    as it is, and a won duel makes room with the bounded loop."""
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
    full = state["bytes"] + budget.size_x > budget.cap_b if budget is not None else count >= cap
    victim = _masked_argmin(freq, in_cache)
    est_x = sketch.rows_estimate(rows_sk, idx)
    est_v = sketch.rows_estimate(rows_sk, table[victim])
    if spec.doorkeeper:
        # the doorkeeper'd occurrence counts back in (post-aging membership)
        est_x = est_x + sketch.bloom_contains(bloom, bidx)
        est_v = est_v + sketch.bloom_contains(bloom, btab[victim])
    admit = est_x > est_v
    if budget is not None:
        # an empty cache has no victim to duel: an over-budget object is rejected
        want = ~hit & (~full | ((count > 0) & admit)) & fill
        insert = budget.insert(state, rows, freq, want)
    else:
        insert = ~hit & (~full | admit) & fill
        need_evict = ~hit & full & admit & fill
        in_cache[rows, victim] = in_cache[rows, victim] & ~need_evict
        freq[rows, victim] = torch.where(need_evict, 0, freq[rows, victim])
        count += insert
        count -= _i32(need_evict)
        state["inserts"] += insert
    fx = freq[rows, x]
    freq[rows, x] = torch.where(hit, fx + 1, torch.where(insert, 1, fx))
    in_cache[rows, x] = in_cache[rows, x] | insert
    return hit


def _list_lru(stamp, lst, tags):
    """Each sample's LRU of the list ``tags[sample]`` names (id 0 when empty)."""
    return _masked_argmin(stamp, lst == tags[:, None])


def _arc_step(state, rows, x, cap, fill):
    """ARC case for case, as the reference's scan: list sizes are tag counts,
    a list's LRU its least-stamped member (an empty list's argmin is id 0,
    whose tag a write then follows). Ghost hits adapt ``p``; a cold miss
    trims B1 (or hard-drops T1's LRU when B1 is empty) or B2 first; a filled
    miss into a full cache demotes T1's or T2's LRU to its ghost list. An
    unfilled ghost hit refreshes its stamp in place, an unfilled cold miss
    parks in B1, unless that would need a resident eviction (``park_skip``).
    The reference searches all four lists' LRUs every step; a sample needs
    at most one trim and one demotion, so this searches the one list each
    takes."""
    lst, stamp, p, t = (state[k] for k in ("lst", "stamp", "p", "t"))
    lx = lst[rows, x]
    hit = (lx == T1) | (lx == T2)
    g1, g2, cold = lx == B1, lx == B2, lx == 0
    ghost = g1 | g2
    counts = torch.zeros((lst.shape[0], B2 + 1), dtype=torch.int32, device=lst.device)
    counts.scatter_add_(1, lst.long(), torch.ones_like(lst))
    t1n, t2n, b1n, b2n = counts[:, 1:].unbind(dim=1)
    total = t1n + t2n + b1n + b2n
    # adaptation (ghost hits only, filled or not): a B1 hit grows the recency
    # target p, a B2 hit shrinks it
    d1 = (b2n // b1n.clamp(min=1)).clamp(min=1)
    d2 = (b1n // b2n.clamp(min=1)).clamp(min=1)
    p.copy_(torch.where(g1, (p + d1).clamp(max=cap), torch.where(g2, (p - d2).clamp(min=0), p)))
    # `fill` is True (every miss inserts) or a bool tensor; the unfilled
    # paths exist only for the latter
    gated = fill is not True
    case_a = cold & (t1n + b1n >= cap)
    hard_t1 = case_a & (b1n == 0)
    if gated:
        park_skip = hard_t1 & ~fill
        hard_t1 = hard_t1 & fill
    gone_b1 = case_a & (b1n > 0)
    gone_b2 = cold & ~case_a & (total >= 2 * cap) & (b2n > 0)
    trimmed = _list_lru(stamp, lst, torch.where(gone_b1, B1, B2))
    lst[rows, trimmed] = torch.where(gone_b1 | gone_b2, 0, lst[rows, trimmed])
    need_evict = ~hit & ~hard_t1 & (t1n + t2n >= cap)
    if gated:
        need_evict = need_evict & fill
    from_t1 = (t1n >= 1) & ((g2 & (t1n == p)) | (t1n > p) | (t2n == 0))
    victim = _list_lru(stamp, lst, torch.where(hard_t1 | from_t1, T1, T2))
    evict = need_evict | hard_t1
    vdst = torch.where(hard_t1, 0, torch.where(from_t1, B1, B2)).to(torch.int32)
    lst[rows, victim] = torch.where(evict, vdst, lst[rows, victim])
    stamp[rows, victim] = torch.where(need_evict, t, stamp[rows, victim])
    # any hit and every filled ghost hit land at T2's MRU, a filled cold miss
    # at T1's; an unfilled ghost hit refreshes in place, an unfilled cold
    # miss parks in B1, unless parking would need a resident eviction
    if gated:
        dst = torch.where(hit | (ghost & fill), T2, torch.where(cold & fill, T1, torch.where(ghost, lx, B1)))
        lst[rows, x] = torch.where(park_skip, lst[rows, x], dst.to(torch.int32))
        stamp[rows, x] = torch.where(park_skip, stamp[rows, x], t)
    else:
        lst[rows, x] = torch.where(hit | ghost, T2, T1).to(torch.int32)
        stamp[rows, x] = t
    # only the demoted id and x can change residency
    in_cache = state["in_cache"]
    for ids in (victim, x):
        tag = lst[rows, ids]
        in_cache[rows, ids] = (tag == T1) | (tag == T2)
    state["count"].copy_(in_cache.sum(dim=1, dtype=torch.int32))
    t += 1
    return hit


def step(spec: PolicySpec, state: dict, x: torch.Tensor, cap=None, fill=None, sizes=None, cap_bytes=None):
    """One request per sample: ``x`` is ``(S,)`` ids, ``state`` batched.
    Updates ``state`` in place and returns ``(state, hit (S,) bool)``. The
    order of operations is the reference's.

    ``cap`` overrides ``spec.capacity`` (a scalar or an ``(S,)`` tensor).
    ``fill`` gates insertion and the eviction that makes room for it (a bool
    or an ``(S,)`` bool tensor); an unfilled miss still updates the policy's
    metadata (parked frequency, window, sketch, arc's ghost lists), and lru
    still stamps it. ``None`` inserts always. ``sizes`` is the ``(N,)`` int32
    size row shared by the samples (``None`` = unit sizes) and ``cap_bytes``
    overrides ``spec.capacity_bytes``; both are consulted only when
    ``spec.size_aware``. plfua_dyn's hot-set refresh is not a step: see
    :func:`refresh_hot`."""
    in_cache, count = state["in_cache"], state["count"]
    dev = in_cache.device
    rows = arange(in_cache.shape[0], dev)
    x = x.to(device=dev, dtype=torch.long)
    cap = spec.capacity if cap is None else torch.as_tensor(cap, device=dev)
    fill = True if fill is None else torch.as_tensor(fill, device=dev)
    if spec.kind == "arc":
        return state, _arc_step(state, rows, x, cap, fill)
    if spec.size_aware and sizes is not None:
        sizes = torch.as_tensor(sizes, dtype=torch.int32, device=dev)
    if spec.capacity_bytes:
        cap_bytes = None if cap_bytes is None else torch.as_tensor(cap_bytes, device=dev)
        budget = _Budget(spec, sizes, x, cap_bytes)
    else:
        budget = None
    if spec.kind == "wlfu":
        return state, _wlfu_step(spec, state, rows, x, cap, fill, budget)
    if spec.kind == "tinylfu":
        return state, _tinylfu_step(spec, state, rows, x, cap, fill, budget)

    # lru and the frequency family: lfu / plfu / plfua / plfua_dyn / gdsf
    hit = in_cache[rows, x]
    if spec.kind == "plfua_dyn":
        # the step only feeds the sketch; a dynamic hot set gates admission
        # only, so a cached object keeps hitting after it leaves the set
        sketch.rows_add(state["sketch"], _tables(spec, dev)[0][x])
        admitted = state["hot"][rows, x] | hit
    elif spec.kind == "plfua":
        admitted = state["hot"][rows, x]
    else:
        admitted = True
    want = ~hit & admitted & fill
    key = state["last"] if spec.kind == "lru" else state["score"] if spec.kind == "gdsf" else state["freq"]
    credit = state.get("L")
    if budget is not None:
        insert = budget.insert(state, rows, key, want, credit)
    else:
        need_evict = want & (count >= cap)
        victim = _masked_argmin(key, in_cache)
        if spec.kind == "gdsf":
            # the aging credit ratchets to the evicted victim's priority
            credit.copy_(torch.where(need_evict, key[rows, victim], credit))
        in_cache[rows, victim] = in_cache[rows, victim] & ~need_evict
        if spec.kind == "lfu":
            # in-memory LFU: eviction destroys the metadata -> restart from 1
            key[rows, victim] = torch.where(need_evict, 0, key[rows, victim])
        insert = want
        count += want
        count -= _i32(need_evict)
        if spec.kind == "plfua_dyn":
            state["inserts"] += want
    if spec.kind == "lru":
        key[rows, x] = state["t"]
        state["t"] += 1
    else:
        # PLFU/PLFUA/GDSF: freq[x] of a non-cached object *is* the parked entry
        freq = state["freq"]
        freq[rows, x] += hit | admitted
        if spec.kind == "gdsf":
            # every request touches, so x re-prices under the post-eviction
            # credit (int32: the shift and the floor division wrap and floor
            # as the reference's)
            key[rows, x] = credit + (freq[rows, x] << GDSF_SHIFT) // _sz(sizes, x)
    in_cache[rows, x] = in_cache[rows, x] | insert
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


def _check_options(spec, telemetry, sizes, groups, device):
    """Raise on what is not ported (telemetry); return the sizes row as an
    int32 tensor on ``device`` when the spec consults it, else ``None``."""
    if telemetry is not None or groups is not None:
        raise not_ported("telemetry")
    if sizes is None or not spec.size_aware:
        return None
    sizes = torch.as_tensor(sizes, dtype=torch.int32, device=device)
    if tuple(sizes.shape) != (spec.n_objects,):
        raise ValueError(f"sizes must have shape ({spec.n_objects},), got {tuple(sizes.shape)}")
    return sizes


def simulate_batch(spec, traces, telemetry=None, sizes=None, groups=None, *, cap_bytes=None, state=None,
                   device=None):
    """Run ``(S, T)`` traces from a zero state, or from a copy of ``state``
    (batched, e.g. from :func:`state_from_numpy`). Returns ``(hits (S, T)
    bool, final state)``. ``sizes`` is the ``(N,)`` size row shared by the
    samples (``None`` = unit sizes; consulted when ``spec.size_aware``) and
    ``cap_bytes`` overrides ``spec.capacity_bytes``. ``telemetry`` and
    ``groups`` must be ``None``: they are not ported yet.

    plfua_dyn refreshes its hot set after every whole ``effective_refresh``
    requests of this run (the reference's ``_chunked_scan``); a partial
    tail period never refreshes."""
    dev = resolve_device(device)
    sizes = _check_options(spec, telemetry, sizes, groups, dev)
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
        state, hit = step(spec, state, traces[:, i], sizes=sizes, cap_bytes=cap_bytes)
        hits[:, i] = hit
        if refresh and (i + 1) % refresh == 0:
            refresh_hot(spec, state)
    return hits, state


def simulate(spec, trace, telemetry=None, sizes=None, groups=None, *, cap_bytes=None, state=None, device=None):
    """Run one ``(T,)`` trace. Returns ``(hits (T,) bool, final state)`` with
    the reference's unbatched shapes; ``state`` (unbatched) continues a run."""
    trace = torch.as_tensor(trace)
    if state is not None:
        state = {k: v.unsqueeze(0) for k, v in state.items()}
    hits, state = simulate_batch(spec, trace[None], telemetry, sizes, groups, cap_bytes=cap_bytes, state=state,
                                 device=device)
    return hits[0], {k: v[0] for k, v in state.items()}


def chr_of(hits: torch.Tensor) -> torch.Tensor:
    return hits.to(torch.float64).mean(dim=-1)


def metadata_entries(spec: PolicySpec, state: dict) -> torch.Tensor:
    """Live metadata entries: cached entries, plus parked ones for the
    frequency family (lfu parks only under the fill gate; its eviction still
    zeroes the victim), plus the sketch's counters for the sketch kinds
    (and tinylfu's doorkeeper bits); wlfu counts its window's distinct ids,
    arc its whole directory (residents and ghosts)."""
    count = state["count"]
    if spec.kind == "lru":
        return count
    if spec.kind == "arc":
        return (state["lst"] != 0).sum(dim=-1)
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
    sketch kinds and byte-mode runs carry the insert count in their state."""
    count = int(state["count"])
    if spec.kind in SKETCH_KINDS or spec.capacity_bytes:
        return int(state["inserts"]) - count
    hits = torch.as_tensor(hits).cpu().numpy()
    if spec.kind == "plfua":
        hot = np.arange(spec.n_objects) < spec.effective_hot
        inserts = int((~hits & hot[torch.as_tensor(trace).cpu().numpy()]).sum())
    else:
        inserts = int((~hits).sum())
    return inserts - count
