"""The port's serving layer against the reference's, on the CPU.

* ``core.policies`` (the copy that drives the content cache): every registry
  kind makes the reference's decisions exactly — the same hit sequence and
  the same resident set after every request — on Zipf traces, in object-count
  and byte mode.
* ``ContentCache``: the reference's semantics tests, mirrored.
* ``ServeEngine`` on the reduced smollm-360m with the reference's weights
  (``convert.params_from_jax``), against the reference engine on the same
  requests: the same tokens, stats, ``report()`` keys and counts, and
  ``window_series``; the same on the reduced deepseek-v2-236b (MLA attention,
  its latent cache, a dense prefix layer and MoE layers), and on the reduced
  rwkv6-7b and jamba-1.5-large-398b (their payloads hold each SSM layer's
  recurrent state: RWKV's ``state``/``prev_x``/``prev_x_c``, Mamba's
  ``h``/``conv`` beside the attention layers' ``k``/``v``). The reduced configs
  compute in float32, where the two engines' logits differ by about 1e-7, far
  below the top-2 margins. ``launch.serve`` prints the reference launcher's
  line for the MoE and SSM archs.
* The engine's own properties: a hit generates what a cold run does, the
  paper's CHR ordering, the scheduler, and a stored payload that stays
  bit-unchanged when a hit decodes from it.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import policies as ref_policies
from repro.core import zipf
from repro.models import build as ref_build
from repro.serving import ContentCache as RefContentCache
from repro.serving import Request as RefRequest
from repro.serving import ServeEngine as RefServeEngine
from repro.telemetry import TelemetrySpec as RefTelemetrySpec
from repro_torch.configs import get_config
from repro_torch.core import policies, registry
from repro_torch.models import build
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import ContentCache, Request, Scheduler, SchedulerConfig, ServeEngine
from repro_torch.telemetry import TelemetrySpec
from repro_torch.telemetry.spec import METRIC_INDEX

# (kind, make_policy options): every registry kind, tinylfu's doorkeeper, and
# plfua_dyn with a refresh that fires several times in the trace
POLICY_CASES = [(kind, {}) for kind in registry.names(reference=True)] + [
    ("tinylfu", dict(doorkeeper=256)),
    ("plfua_dyn", dict(refresh=150, sketch_width=64)),
    ("wlfu", dict(window=100)),
]


# byte mode for every kind but arc, which has none (both raise)
SIZED_CASES = [(kind, kw, sized) for kind, kw in POLICY_CASES for sized in (False, True)
               if not (sized and kind == "arc")]


@pytest.mark.parametrize("kind,kw,sized", SIZED_CASES)
def test_policies_make_the_reference_decisions(kind, kw, sized):
    n, cap = 120, 12
    trace = zipf.sample_trace(n, 1500, seed=9)
    extra = dict(n_objects=n, **kw)
    if sized:
        sizes = np.random.default_rng(2).integers(1, 9, n)
        extra.update(sizes=sizes, capacity_bytes=int(cap * sizes.mean()), max_victims=3)
    port = policies.make_policy(kind, cap, **extra)
    ref = ref_policies.make_policy(kind, cap, **extra)
    for t, x in enumerate(trace.tolist()):
        assert port.request(x) == ref.request(x), (kind, t)
        if t % 50 == 0 or t == len(trace) - 1:
            assert {i for i in range(n) if port.contains(i)} == {i for i in range(n) if ref.contains(i)}, (kind, t)
    assert port.metadata_entries == ref.metadata_entries


def test_policy_names_and_errors_match_reference():
    assert policies.POLICY_NAMES == ref_policies.POLICY_NAMES
    for make in (policies.make_policy, ref_policies.make_policy):
        with pytest.raises(ValueError, match="byte"):
            make("arc", 4, sizes=np.ones(10, np.int64), capacity_bytes=4)
    with pytest.raises(ValueError, match="plfua_dyn requires n_objects"):
        policies.make_policy("plfua_dyn", 4)
    with pytest.raises(ValueError, match="unknown policy"):
        policies.make_policy("mru", 4)


# ------------------------------------------------------------ content cache
def test_content_cache_hit_miss_accounting():
    c = ContentCache(capacity=2, policy="lfu")
    assert c.lookup(1) is None
    c.offer(1, "payload-1")
    assert c.lookup(1) == "payload-1"
    assert c.stats.hits == 1 and c.stats.misses == 1
    assert c.stats.mgmt_time_s > 0


def test_content_cache_eviction_syncs_payloads():
    c = ContentCache(capacity=2, policy="lfu")
    for i in (1, 2):
        c.lookup(i)
        c.offer(i, f"p{i}")
    c.lookup(1)
    c.lookup(3)
    c.offer(3, "p3")  # evicts 2 (min freq)
    assert len(c) == 2
    assert c.lookup(2) is None
    assert c.lookup(1) == "p1"


def test_plfua_content_cache_rejects_cold():
    c = ContentCache(capacity=4, policy="plfua", n_objects=100)
    c.lookup(50)
    assert not c.offer(50, "x")
    c.lookup(3)
    assert c.offer(3, "y")


def test_content_cache_byte_accounting_tracks_live_payloads():
    c = ContentCache(capacity=3, policy="lfu", size_of=len)
    rng = np.random.default_rng(0)
    for _ in range(300):
        obj = int(rng.integers(0, 10))
        if c.lookup(obj) is None:
            c.offer(obj, "x" * int(rng.integers(1, 50)))
        assert c.stats.bytes_stored == sum(len(p) for p in c._payloads.values())
    assert c.stats.evictions > 0
    c2 = ContentCache(capacity=2, policy="lfu", size_of=len)
    c2.lookup(1)
    c2.offer(1, "abc")
    c2.lookup(1)
    c2.offer(1, "defgh")
    assert c2.stats.bytes_stored == 5


# ------------------------------------------------------------------- engine
@pytest.fixture(scope="module")
def engines():
    """The reference's reduced smollm-360m and the port's, with the same weights."""
    ref_model = ref_build(ref_get_config("smollm-360m").reduced())
    params = ref_model.init(jax.random.PRNGKey(0))
    model = params_from_jax(build(get_config("smollm-360m").reduced(), device="cpu"),
                            jax.tree_util.tree_map(np.asarray, params))
    return ref_model, params, model


def _requests(n_objects=20, n_requests=40, prompt_len=8, seed=0, cls=Request):
    rng = np.random.default_rng(seed)
    trace = zipf.sample_trace(n_objects, n_requests, seed=seed)
    prompts = {i: rng.integers(0, 200, size=prompt_len).astype(np.int32) for i in range(n_objects)}
    return [cls(obj_id=int(x), tokens=prompts[int(x)], max_new=4) for x in trace]


@pytest.mark.parametrize("policy,kw", [("plfua", {}), ("lru", {}), ("tinylfu", {}), ("plfua_dyn", dict(n_objects=20)),
                                       ("gdsf", dict(sizes=np.arange(2, 22), capacity_bytes=60))])
def test_engine_matches_reference_engine(engines, policy, kw):
    ref_model, params, model = engines
    kw = {"n_objects": 20, **kw}
    ref = RefServeEngine(ref_model, params, cache_len=16, content_cache=RefContentCache(5, policy=policy, **kw),
                         telemetry=RefTelemetrySpec(7))
    port = ServeEngine(model, cache_len=16, content_cache=ContentCache(5, policy=policy, **kw),
                       telemetry=TelemetrySpec(7))
    ref_out = ref.run(_requests(seed=4, cls=RefRequest))
    out = port.run(_requests(seed=4))
    assert [dataclasses.astuple(r) for r in out] == [dataclasses.astuple(r) for r in ref_out]
    assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref.stats)
    ref_report, report = ref.report(), port.report()
    assert set(report) == set(ref_report)
    for key in report:
        if key != "mgmt_time_s":  # host CPU time, measured
            assert report[key] == ref_report[key], key
    np.testing.assert_array_equal(port.window_series().numpy(), np.asarray(ref.window_series()))


def test_engine_cached_generation_identical(engines):
    """A content-cache hit produces exactly the generation a cold run does."""
    model = engines[2]
    reqs = _requests()
    cold = ServeEngine(model, cache_len=16)
    warm = ServeEngine(model, cache_len=16, content_cache=ContentCache(capacity=8, policy="plfu"))
    out_cold, out_warm = cold.run(reqs), warm.run(reqs)
    for a, b in zip(out_cold, out_warm):
        assert a.new_tokens == b.new_tokens, (a.obj_id, a.new_tokens, b.new_tokens)
    assert warm.stats.prefill_tokens_saved > 0
    assert (warm.stats.prefill_tokens_computed + warm.stats.prefill_tokens_saved
            == cold.stats.prefill_tokens_computed)


def test_engine_policy_chr_ordering(engines):
    """Paper ordering at the serving layer: PLFU >= LFU on a Zipf workload."""
    model = engines[2]
    reqs = _requests(n_objects=30, n_requests=120, seed=3)
    chrs = {}
    for policy in ("lfu", "plfu", "plfua"):
        eng = ServeEngine(model, cache_len=16, content_cache=ContentCache(capacity=5, policy=policy, n_objects=30))
        eng.run(reqs)
        chrs[policy] = eng.content.stats.chr
    assert chrs["plfu"] >= chrs["lfu"] - 0.02
    assert chrs["plfua"] >= chrs["plfu"] - 0.02


def test_scheduler_batches_and_deadlines(engines):
    eng = ServeEngine(engines[2], cache_len=16)
    sched = Scheduler(eng, SchedulerConfig(max_batch=4, deadline_s=1e9))
    for r in _requests(n_requests=10):
        sched.submit(r)
    assert len(sched.drain()) == 10
    assert sched.stats.batches == 3  # 4 + 4 + 2
    sched2 = Scheduler(eng, SchedulerConfig(max_batch=4, deadline_s=-1.0))
    for r in _requests(n_requests=5):
        sched2.submit(r, now=0.0)
    assert sched2.drain() == []
    assert sched2.stats.dropped == 5


def test_hit_leaves_the_stored_payload_unchanged(engines):
    """Decode writes K/V in place; a hit decodes on a copy, so the payload in
    the content cache is bit-unchanged for the next hit."""
    model = engines[2]
    cache = ContentCache(capacity=4, policy="lru")
    eng = ServeEngine(model, cache_len=16, content_cache=cache)
    req = _requests(n_requests=1)[0]
    first = eng.generate(req)
    stored_cache, pos, logits = cache._payloads[req.obj_id]
    snapshot = {k: v.clone() for k, v in stored_cache.items()}, logits.clone()
    second = eng.generate(req)
    third = eng.generate(req)
    assert second.prefill_skipped and third.prefill_skipped
    assert first.new_tokens == second.new_tokens == third.new_tokens
    for name, tensor in stored_cache.items():
        assert torch.equal(tensor, snapshot[0][name]), name
    assert torch.equal(logits, snapshot[1]) and pos == len(req.tokens)


def test_engine_copies_the_kv_cache_only_when_the_content_cache_holds_it(engines, monkeypatch):
    """Decode writes in place: a miss the policy does not admit decodes on
    prefill's own KV cache, with no copy; an admitted miss decodes on a copy,
    so the stored payload stays what prefill gave."""
    model = engines[2]
    prefilled, decoded = [], []
    prefill, decode_step = model.prefill, model.decode_step

    def prefill_spy(batch, cache_len):
        out = prefill(batch, cache_len)
        prefilled.append(out[1])
        return out

    def decode_spy(cache, tokens, pos):
        decoded.append(cache)
        return decode_step(cache, tokens, pos)

    monkeypatch.setattr(model, "prefill", prefill_spy)
    monkeypatch.setattr(model, "decode_step", decode_spy)
    content = ContentCache(capacity=4, policy="plfua", n_objects=20)  # admits the hot set, ids 0-7
    eng = ServeEngine(model, cache_len=16, content_cache=content)
    tokens = np.arange(1, 9, dtype=np.int32)
    eng.generate(Request(15, tokens, max_new=2))
    assert 15 not in content._payloads and decoded[0] is prefilled[0]
    eng.generate(Request(1, tokens, max_new=2))
    stored = content._payloads[1][0]
    assert stored is prefilled[1] and decoded[2] is not stored
    _, fresh = prefill({"tokens": torch.as_tensor(tokens)[None, :]}, 16)
    for name in stored:
        assert torch.equal(stored[name], fresh[name]), name


def test_engine_sized_window_series_roundtrip(engines):
    """A sized content cache reports real byte traffic in window_series."""
    model = engines[2]
    n_objects = 20
    sizes = np.arange(2, 2 + n_objects, dtype=np.int64)
    reqs = _requests(n_objects=n_objects, n_requests=30, seed=11)
    eng = ServeEngine(model, cache_len=16, telemetry=TelemetrySpec(8),
                      content_cache=ContentCache(capacity=8, policy="gdsf", n_objects=n_objects, sizes=sizes,
                                                 capacity_bytes=64))
    eng.run(reqs)
    series = eng.window_series()
    req_w, hit_w = series[:, METRIC_INDEX["requests"]], series[:, METRIC_INDEX["hits"]]
    hb_w, mb_w = series[:, METRIC_INDEX["hit_bytes"]], series[:, METRIC_INDEX["miss_bytes"]]
    assert int(req_w.sum()) == len(reqs)
    assert int(hb_w.sum()) > int(hit_w.sum()) > 0
    assert int(hb_w.sum() + mb_w.sum()) == sum(int(sizes[r.obj_id]) for r in reqs)


@pytest.fixture(scope="module")
def moe_engines():
    """The reference's reduced deepseek-v2-236b and the port's, with the same weights."""
    ref_model = ref_build(ref_get_config("deepseek-v2-236b").reduced())
    params = ref_model.init(jax.random.PRNGKey(1))
    model = params_from_jax(build(get_config("deepseek-v2-236b").reduced(), device="cpu"),
                            jax.tree_util.tree_map(np.asarray, params))
    return ref_model, params, model


@pytest.mark.parametrize("policy", ["plfua", "lru"])
def test_moe_engine_matches_reference_engine(moe_engines, policy):
    """deepseek reduced behind the content cache: the reference engine's
    generated tokens, CHR, tokens saved and computed; a hit's payload is the
    MLA latent cache ({"ckv", "k_rope"}), copied before decoding."""
    ref_model, params, model = moe_engines
    ref = RefServeEngine(ref_model, params, cache_len=16, content_cache=RefContentCache(5, policy=policy, n_objects=20))
    port = ServeEngine(model, cache_len=16, content_cache=ContentCache(5, policy=policy, n_objects=20))
    reqs = _requests(n_requests=24, seed=5)
    ref_out = ref.run(_requests(n_requests=24, seed=5, cls=RefRequest))
    out = port.run(reqs)
    assert [dataclasses.astuple(r) for r in out] == [dataclasses.astuple(r) for r in ref_out]
    assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref.stats)
    assert port.content.stats.chr == ref.content.stats.chr and port.stats.prefill_tokens_saved > 0
    payload = next(iter(port.content._payloads.values()))[0]
    assert set(payload) == {"ckv", "k_rope"} and payload["ckv"].shape[0] == model.cfg.n_layers


@pytest.fixture(scope="module", params=["rwkv6-7b", "jamba-1.5-large-398b"])
def ssm_engines(request):
    """The reference's reduced rwkv6-7b or jamba-1.5-large-398b and the port's, with the same weights."""
    ref_model = ref_build(ref_get_config(request.param).reduced())
    params = ref_model.init(jax.random.PRNGKey(2))
    model = params_from_jax(build(get_config(request.param).reduced(), device="cpu"),
                            jax.tree_util.tree_map(np.asarray, params))
    return ref_model, params, model


SSM_CACHE_NAMES = {"rwkv6-7b-reduced": {"state", "prev_x", "prev_x_c"},
                   "jamba-1.5-large-398b-reduced": {"k", "v", "h", "conv"}}


def test_ssm_engine_matches_reference_engine(ssm_engines):
    """rwkv6 or jamba reduced behind the content cache: the reference
    engine's generated tokens, stats and CHR; a payload holds every layer's
    recurrent state (jamba: k/v over its 2 attention layers, h/conv over its
    2 Mamba layers)."""
    ref_model, params, model = ssm_engines
    ref = RefServeEngine(ref_model, params, cache_len=16, content_cache=RefContentCache(5, policy="plfua", n_objects=20))
    port = ServeEngine(model, cache_len=16, content_cache=ContentCache(5, policy="plfua", n_objects=20))
    ref_out = ref.run(_requests(n_requests=24, seed=6, cls=RefRequest))
    out = port.run(_requests(n_requests=24, seed=6))
    assert [dataclasses.astuple(r) for r in out] == [dataclasses.astuple(r) for r in ref_out]
    assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref.stats)
    assert port.content.stats.chr == ref.content.stats.chr and port.stats.prefill_tokens_saved > 0
    payload = next(iter(port.content._payloads.values()))[0]
    assert set(payload) == SSM_CACHE_NAMES[model.cfg.name]
    mixers = [d.mixer for d in model.descs]
    for name, tensor in payload.items():
        holders = {"k": "gqa", "v": "gqa", "h": "mamba", "conv": "mamba"}.get(name)
        assert tensor.shape[0] == (mixers.count(holders) if holders else model.cfg.n_layers), name


def test_ssm_engine_hit_decodes_the_first_serve_and_keeps_the_payload(ssm_engines):
    """Cold and warm engines generate the same tokens; a hit generates its
    object's first serve's tokens; the payload the content cache holds is
    bit for bit what prefill gave after every hit's decode (decode writes
    the recurrent state in place, on a copy)."""
    model = ssm_engines[2]
    reqs = _requests(n_requests=30, seed=7)
    cold = ServeEngine(model, cache_len=16)
    content = ContentCache(capacity=8, policy="lru")
    warm = ServeEngine(model, cache_len=16, content_cache=content)
    out_cold = cold.run(reqs)
    stored = {}
    out_warm = []
    for req in reqs:
        out_warm.append(warm.generate(req))
        if req.obj_id in content._payloads and req.obj_id not in stored:
            cache, pos, logits = content._payloads[req.obj_id]
            stored[req.obj_id] = ({k: v.clone() for k, v in cache.items()}, pos, logits.clone())
    assert [r.new_tokens for r in out_cold] == [r.new_tokens for r in out_warm]
    first = {}
    for r in out_warm:
        if not r.prefill_skipped:
            first.setdefault(r.obj_id, r.new_tokens)
    hits = [r for r in out_warm if r.prefill_skipped]
    assert hits and all(r.new_tokens == first[r.obj_id] for r in hits)
    for obj, (cache, pos, logits) in stored.items():
        if obj in content._payloads:
            held, held_pos, held_logits = content._payloads[obj]
            assert held_pos == pos and torch.equal(held_logits, logits)
            for name, tensor in cache.items():
                assert torch.equal(held[name], tensor), (obj, name)
    assert any(obj in content._payloads for obj in stored)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "grok-1-314b", "rwkv6-7b", "jamba-1.5-large-398b"])
def test_launcher_prints_the_reference_line(arch, monkeypatch, capsys):
    """``launch.serve --arch <arch> --device cpu`` runs the reduced config
    and prints the reference launcher's line (the management ms, host CPU
    time, aside)."""
    import sys

    from repro.launch import serve as ref_serve
    from repro_torch.launch import serve

    serve.main(["--arch", arch, "--device", "cpu"])
    port_line = capsys.readouterr().out.strip()
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch])
    ref_serve.main()
    ref_line = capsys.readouterr().out.strip()
    assert port_line.rsplit(" mgmt=", 1)[0] == ref_line.rsplit(" mgmt=", 1)[0]
    assert port_line.startswith("[serve] plfua: CHR=")


def test_engine_report_and_errors(engines):
    model = engines[2]
    eng = ServeEngine(model, cache_len=16, content_cache=ContentCache(capacity=8, policy="plfu"))
    eng.run(_requests(n_requests=20))
    rep = eng.report()
    assert rep["mgmt_time_s"] > 0 and rep["cache_hits"] + rep["cache_misses"] == 20
    assert "mgmt_time_s" not in ServeEngine(model, cache_len=16).report()
    with pytest.raises(ValueError, match="telemetry requires a content cache"):
        ServeEngine(model, cache_len=16, telemetry=TelemetrySpec(4))
    with pytest.raises(ValueError, match="without telemetry"):
        eng.window_series()
