"""Serving engine: prefill/decode with the content cache in front.

The port of the reference's ``serving/engine.py``. Requests are keyed by
``obj_id`` (prompt identity). On a content hit the stored prefill state (the
request's decode cache, its next position and the next-token logits) is reused
and prefill is skipped; on an admitted miss the state is offered back to the
cache. The engine meters prefill tokens computed vs. saved.

Two differences from the reference, both from PyTorch's mutable tensors: the
model carries its weights (``ServeEngine(model, cache_len, ...)``, no
``params``), and decode writes its cache in place (K/V at the new position;
an SSM layer's whole recurrent state), so the engine decodes on a copy of a
cache that the content cache holds (a hit, or an admitted miss): a stored
payload stays bit-unchanged for the next hit. For an SSM layer that state is
the whole prefix, whatever the prompt's length (rwkv6-7b: 1 MB a layer). The content cache is a
``ContentCache`` or a ``FleetContentCache``. On the card every attention call of prefill and
decode runs the flash kernel.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.model import Model
from repro_torch.serving.content_cache import ContentCache
from repro_torch.telemetry import TelemetrySpec
from repro_torch.telemetry import spec as telemetry_spec


@dataclasses.dataclass
class Request:
    obj_id: int
    tokens: np.ndarray  # (prompt_len,) int32
    max_new: int = 8


@dataclasses.dataclass
class Result:
    obj_id: int
    prompt_len: int
    new_tokens: list
    prefill_skipped: bool


@dataclasses.dataclass
class EngineStats:
    prefill_tokens_computed: int = 0
    prefill_tokens_saved: int = 0
    decode_tokens: int = 0


class ServeEngine:
    """Single-host engine, batch 1 a request, on the model's device."""

    def __init__(
        self,
        model: Model,
        cache_len: int,
        content_cache: ContentCache | None = None,
        telemetry: TelemetrySpec | None = None,
    ):
        if telemetry is not None and content_cache is None:
            raise ValueError("telemetry requires a content cache to observe")
        self.model = model
        self.cache_len = cache_len
        self.content = content_cache
        self.telemetry = telemetry
        #: per-request (hit, fill, evict, occupancy, hit_bytes, miss_bytes)
        #: outcomes, recorded when telemetry is on; window_series() buckets
        #: them on the shared telemetry window semantics. Byte columns use the
        #: policy brain's size catalogue (unit fallback on unsized caches).
        self._outcomes: list[tuple[int, int, int, int, int, int]] = []
        self.stats = EngineStats()

    # ------------------------------------------------------------- serving
    def _prefill_state(self, req: Request):
        """Content-cache-aware prefill: returns ((cache, next_pos,
        last_logits), skipped, held): ``held`` whether the content cache holds
        the payload (a hit, or a miss some node stored)."""
        if self.content is not None:
            payload = self.content.lookup(req.obj_id)
            if payload is not None:
                self.stats.prefill_tokens_saved += len(req.tokens)
                return payload, True, True
        tokens = torch.as_tensor(np.asarray(req.tokens, np.int32), device=self.model.device)[None, :]
        logits, cache = self.model.prefill({"tokens": tokens}, self.cache_len)
        self.stats.prefill_tokens_computed += len(req.tokens)
        # a copy of the last row, so that the (1, S, V) logits are freed
        payload = (cache, len(req.tokens), logits[:, -1, :].clone())
        held = self.content is not None and self.content.offer(req.obj_id, payload)
        return payload, False, held

    def generate(self, req: Request) -> Result:
        """Greedy decode for one request (B=1 reference path)."""
        pre = (
            (self.content.stats.inserts, self.content.stats.evictions)
            if self.telemetry is not None
            else None
        )
        state, skipped, held = self._prefill_state(req)
        cache, pos, last_logits = state
        if pre is not None:
            s = self.content.stats
            sz = self.content.policy._size(req.obj_id)
            self._outcomes.append(
                (
                    int(skipped),
                    int(s.inserts > pre[0]),
                    int(s.evictions > pre[1]),
                    len(self.content),
                    sz * int(skipped),
                    sz * int(not skipped),
                )
            )
        if held:
            # decode writes in place: keep the payload the content cache holds intact
            cache = {name: c.clone() for name, c in cache.items()}
        out = []
        logits = last_logits
        for t in range(req.max_new):
            nxt = torch.argmax(logits, dim=-1)  # (1,)
            out.append(int(nxt[0]))
            logits, cache = self.model.decode_step(cache, nxt[:, None], pos + t)
            self.stats.decode_tokens += 1
        return Result(req.obj_id, len(req.tokens), out, skipped)

    def run(self, requests: list[Request]) -> list[Result]:
        return [self.generate(r) for r in requests]

    def window_series(self) -> torch.Tensor:
        """``(n_windows, N_METRICS)`` int32 over the requests served so far —
        the layout the simulator tiers emit. fill_offers equals misses (the
        engine offers every computed prefill back); refresh/churn stay zero."""
        if self.telemetry is None:
            raise ValueError("engine was built without telemetry=TelemetrySpec(...)")
        if not self._outcomes:
            raise ValueError("no requests served yet")
        ev = torch.as_tensor(np.asarray(self._outcomes, np.int64).T)  # (6, T)
        return telemetry_spec.series_from_run(
            self.telemetry.window,
            ev.shape[1],
            hits=ev[0],
            fills=ev[1],
            evictions=ev[2],
            occupancy=ev[3],
            hit_bytes=ev[4],
            miss_bytes=ev[5],
        )

    def report(self) -> dict:
        """Engine-level accounting incl. the paper's management-time metric:
        ``mgmt_time_s`` is the CPU time the content-cache policy brain burned
        on admission/eviction decisions."""
        out = {
            "prefill_tokens_computed": self.stats.prefill_tokens_computed,
            "prefill_tokens_saved": self.stats.prefill_tokens_saved,
            "decode_tokens": self.stats.decode_tokens,
        }
        if self.content is not None:
            s = self.content.stats
            out.update(
                cache_chr=s.chr,
                cache_hits=s.hits,
                cache_misses=s.misses,
                cache_evictions=s.evictions,
                bytes_stored=s.bytes_stored,
                mgmt_time_s=s.mgmt_time_s,
            )
        return out
