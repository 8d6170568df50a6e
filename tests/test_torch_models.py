"""The port's configs and models against the reference's, on the CPU.

Configs are pinned field for field. Models (every arch: the dense archs;
the MoE archs deepseek-v2-236b with MLA attention and a dense prefix layer,
and grok-1-314b with GQA; rwkv6-7b, RWKV6 time and channel mixes; the hybrid
jamba-1.5-large-398b, Mamba layers with an attention layer between and MoE
FFNs on every other layer; llava-next-mistral-7b, its 8 prefix embeddings
(reduced; drawn at 0.02, as the reference's smoke test draws them) before
the text; and the encoder-decoder whisper-large-v3): the reference's weights
(its ``init`` from ``PRNGKey(0)``) are carried into a port ``Model`` with
``convert.params_from_jax``; both then run ``apply``, ``prefill`` (the dense
attention branch at a 12-token prompt, the chunked one at 48 tokens: the
reduced configs switch at 16; at 48 the reduced MoE, E = 4, k = 2, C = 32,
runs near its capacity; llava's prompt counts its prefix; whisper's prompt
is its source, 12 or 48 frames, before a 4-token decoder prompt) and 3 ``decode_step``s on the same tokens.
tests/test_torch_whisper.py holds whisper's parts (``encode``, ``hidden``)
on their own. The new archs' (llava's, whisper's) own forward, decode and
parameter counts are also held to what tests/test_models_smoke.py asks of
the reference.
Tolerances: float32 1e-5 on logits of magnitude below 1 (summation order
only); bfloat16 2e-2, a few bf16 ulps at that magnitude (the two frameworks
round bf16 matmuls, activations and the logits at different points).
Greedy tokens are compared where the top-2 margin exceeds twice the
tolerance (each of the two logits may move by the tolerance). Each package
gets its own copy of every input array: no buffer is shared between the two.

The decode caches are compared leaf by leaf, each name stacked over the
layers that hold it (jamba: ``k``/``v`` over its attention layers, ``h``/
``conv`` over its Mamba layers).

The MoE archs' router choices are compared call by call (``Routes``): in
float32 they are equal everywhere. In bfloat16 the two frameworks' router
inputs differ by an ulp or so, so a token whose k-th and (k+1)-th router
logits lie within a few ulps may pick another expert in each: a batch row
whose choices differ is held no further, the difference must sit at such a
near tie (``NEAR_TIE``), and some row must be held to the end. The route and
dispatch steps themselves are held to the reference exactly in
tests/test_torch_moe.py, which also explains ``F32Dots`` (the reference's
bf16 MLA decode on XLA's CPU runtime).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import attention as ref_attention
from repro.models import build as ref_build
from repro.models import common as ref_common
from repro_torch import configs
from repro_torch.models import build, common, moe
from repro_torch.models.convert import params_from_jax, port_arrays
from test_torch_moe import F32Dots

DENSE = ("smollm-360m", "granite-3-2b", "phi4-mini-3.8b", "mistral-large-123b")
MOE = ("deepseek-v2-236b", "grok-1-314b", "jamba-1.5-large-398b")
SSM = ("rwkv6-7b", "jamba-1.5-large-398b")
#: the archs whose families the port took last: the vlm's prefix and the encoder-decoder
NEW = ("llava-next-mistral-7b", "whisper-large-v3")
PORTED = DENSE + MOE + ("rwkv6-7b",) + NEW
#: the encoder-decoder's decoder prompt in the parity test (its ``prompt`` is the source's length)
ENC_DEC_PROMPT = 4
#: tests/test_models_smoke.py's published parameter counts of the new archs (a band of 18 % either side)
PUBLISHED_PARAMS = {"whisper-large-v3": 1.6e9, "llava-next-mistral-7b": 7.2e9}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
#: a router near tie: the k-th and (k+1)-th logits within 4 bf16 ulps (2**-5 relative)
NEAR_TIE = 2**-5


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_configs_pinned_field_for_field(arch):
    ref, port = ref_configs.get_config(arch), configs.get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == dataclasses.asdict(ref.reduced())
    for layer in range(ref.n_layers):
        assert port.moe_at(layer) == ref.moe_at(layer) and port.attn_at(layer) == ref.attn_at(layer)
    assert port.applicable_shapes() == ref.applicable_shapes()


def test_registry_and_shapes_pinned():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_configs.SHAPES.items()}
    assert dataclasses.asdict(configs.get_shape("decode_32k")) == dataclasses.asdict(ref_configs.get_shape("decode_32k"))
    with pytest.raises(ValueError, match="unknown arch"):
        configs.get_config("gpt-2")


@pytest.mark.parametrize("arch", PORTED)
def test_n_params_equal_at_full_config(arch):
    """The spec trees count the reference's parameters at the published
    widths (smollm-360m: about 409 M), and a built model holds them; the
    active parameters too (a model on the meta device allocates nothing)."""
    cfg, ref_cfg = configs.get_config(arch), ref_configs.get_config(arch)
    full = build(cfg, device="meta")
    assert common.count_params(full.param_specs) == ref_build(ref_cfg).n_params
    assert full.n_params == ref_build(ref_cfg).n_params == sum(p.numel() for p in full.parameters())
    assert full.n_active_params == ref_build(ref_cfg).n_active_params
    model = build(cfg.reduced(), device="cpu")
    assert model.n_params == ref_build(ref_cfg.reduced()).n_params == sum(p.numel() for p in model.parameters())
    assert model.n_active_params == ref_build(ref_cfg.reduced()).n_active_params
    if arch == "smollm-360m":
        assert 400e6 < ref_build(ref_cfg).n_params < 420e6
    if arch in MOE:
        assert full.n_active_params < full.n_params


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_build_takes_every_config(arch):
    """No config is refused: every arch builds at its reduced widths and
    holds the parameters its spec tree names."""
    model = build(configs.get_config(arch).reduced(), device="cpu")
    assert {name for name, _ in model.named_parameters()} == set(model.port_specs())


def _smoke_batch(cfg, b=2, s=32, seed=0):
    """tests/test_models_smoke.py's batch: the encoder-decoder's ``s``
    source frames and ``max_target_positions`` tokens; the vlm's prefix
    embeddings (0.02 x normal) before ``s - n_prefix_embeds`` tokens."""
    rng = np.random.default_rng(seed)
    if cfg.encoder_decoder:
        return {"enc_embeds": rng.normal(size=(b, s, cfg.d_model)).astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab_size, (b, cfg.max_target_positions)).astype(np.int32)}
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s - cfg.n_prefix_embeds)).astype(np.int32)}
    if cfg.n_prefix_embeds:
        out["prefix_embeds"] = (rng.normal(size=(b, cfg.n_prefix_embeds, cfg.d_model)) * 0.02).astype(np.float32)
    return out


@pytest.mark.parametrize("arch", NEW)
def test_forward_smoke(arch):
    """tests/test_models_smoke.py's forward smoke on the port: f32 logits of
    the batch's shape, all finite."""
    cfg = configs.get_config(arch).reduced()
    model = build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    batch = _smoke_batch(cfg)
    logits = model.apply(batch)
    exp_s = cfg.max_target_positions if cfg.encoder_decoder else 32
    assert logits.shape == (2, exp_s, cfg.vocab_size) and logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all()), f"{arch}: non-finite logits"


@pytest.mark.parametrize("arch", NEW)
def test_decode_matches_forward(arch):
    """tests/test_models_smoke.py's decode check on the port: a prefill of 8
    tokens and 3 decode steps reproduce the full forward's logits (the vlm's
    positions after its prefix), at the reference test's 2e-3."""
    cfg = configs.get_config(arch).reduced()
    model = build(cfg, device="cpu").init(torch.Generator().manual_seed(1))
    batch = _smoke_batch(cfg, seed=1)
    full = model.apply(batch)
    tokens = batch["tokens"]
    p_len, offset = 8, cfg.n_prefix_embeds
    _, cache = model.prefill(dict(batch, tokens=tokens[:, :p_len]), tokens.shape[1] + offset)
    for t in range(p_len, p_len + 3):
        logits, cache = model.decode_step(cache, tokens[:, t:t + 1], offset + t)
        np.testing.assert_allclose(logits.numpy(), full[:, offset + t].numpy(), atol=2e-3, rtol=2e-3,
                                   err_msg=f"{arch}: decode diverges from forward at t={t}")


@pytest.mark.parametrize("arch", NEW)
def test_full_config_param_count(arch):
    """tests/test_models_smoke.py's count on the port, with no allocation:
    the published band."""
    model = build(configs.get_config(arch), device="meta")
    target = PUBLISHED_PARAMS[arch]
    assert 0.82 * target <= model.n_params <= 1.18 * target, f"{arch}: {model.n_params / 1e9:.2f}B"


def _pair(arch, compute_dtype, **over):
    ref_cfg = dataclasses.replace(ref_configs.get_config(arch).reduced(), compute_dtype=compute_dtype, **over)
    cfg = dataclasses.replace(configs.get_config(arch).reduced(), compute_dtype=compute_dtype, **over)
    ref_model = ref_build(ref_cfg)
    params = ref_model.init(jax.random.PRNGKey(0))
    model = params_from_jax(build(cfg, device="cpu"), jax.tree_util.tree_map(np.asarray, params))
    return ref_model, params, model


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), atol=tol, rtol=tol)


def _greedy_equal_where_clear(port_logits, ref_logits, tol):
    ref_logits = np.asarray(ref_logits, np.float32)
    top2 = np.sort(ref_logits, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * tol
    got = port_logits.float().numpy().argmax(-1)
    np.testing.assert_array_equal(got[clear], ref_logits.argmax(-1)[clear])


def _ref_cache(ref_model, ref_cache, name):
    """The reference's cache leaf ``name`` stacked over the layers that hold
    it, in layer order (its prefix layers, then the scanned blocks), as the
    port stacks it; the encoder-decoder's leaves are stacked already."""
    from repro.models.transformer import stack_pattern

    if ref_model.cfg.encoder_decoder:
        return np.asarray(ref_cache[name], np.float32)
    prefix, pattern, n_blocks = stack_pattern(ref_model.cfg)
    layers = [np.asarray(ref_cache["prefix"][str(i)][name], np.float32) for i in range(len(prefix))
              if name in ref_cache["prefix"][str(i)]]
    layers += [np.asarray(ref_cache["blocks"][str(j)][name][blk], np.float32)
               for blk in range(n_blocks) for j in range(len(pattern)) if name in ref_cache["blocks"][str(j)]]
    return np.stack(layers)


def _ref_cache_names(ref_cache) -> set:
    if not any(isinstance(part, dict) for part in ref_cache.values()):
        return set(ref_cache)
    return {name for part in ref_cache.values() for layer in part.values() for name in layer}


class Routes:
    """Both packages' router choices, call by call: the reference's through a
    ``jax.lax.top_k`` that reports its indices as it runs (a debug callback,
    in order, inside jit and scan alike), the port's through ``moe.route``,
    with each call's near ties (the k-th and (k+1)-th logits within
    ``NEAR_TIE``). ``update()`` adds to ``flipped`` each batch row in which
    a token's choice differs; the first difference in a row must be a near
    tie on the port's side."""

    def __init__(self, monkeypatch):
        self.ref, self.port, self.flipped, self.checked = [], [], set(), 0
        top_k, route = jax.lax.top_k, moe.route

        def ref_top_k(x, k):
            values, idx = top_k(x, k)
            jax.debug.callback(lambda i: self.ref.append(np.asarray(i)), idx, ordered=True)
            return values, idx

        def port_route(router, x, k):
            weights, idx = route(router, x, k)
            top = torch.sort(torch.einsum("bsd,de->bse", x, router).float(), dim=-1, descending=True).values
            a, b = top[..., k - 1], top[..., k]
            self.port.append((idx.numpy(), ((a - b) <= NEAR_TIE * torch.maximum(a.abs(), b.abs())).numpy()))
            return weights, idx

        monkeypatch.setattr(jax.lax, "top_k", ref_top_k)
        monkeypatch.setattr(moe, "route", port_route)

    def update(self):
        jax.effects_barrier()
        assert len(self.ref) == len(self.port), (len(self.ref), len(self.port))
        for ref, (port, near) in zip(self.ref, self.port):
            differs = (np.sort(ref, -1) != np.sort(port, -1)).any(-1)  # (B, S): another set of experts
            for r in range(differs.shape[0]):
                if differs[r].any() and r not in self.flipped:
                    assert near[r][differs[r]].all(), "the routing differs away from a near tie"
                    self.flipped.add(r)
            self.checked += differs.size
        self.ref.clear()
        self.port.clear()


def _batches(cfg, prompt):
    """(port batch, reference batch, the first decode position), each
    package with its own copy of the arrays: ``prompt`` positions (the vlm's
    prefix embeddings, 0.02 x normal, and ``prompt - n_prefix_embeds``
    tokens, as tests/test_models_smoke.py's batch: the chunked path needs a
    multiple of its chunk); for the encoder-decoder a source of ``prompt``
    frames and an ``ENC_DEC_PROMPT``-token decoder prompt."""
    rng = np.random.default_rng(prompt)
    n_tokens = ENC_DEC_PROMPT if cfg.encoder_decoder else prompt - cfg.n_prefix_embeds
    arrays = {"tokens": rng.integers(0, cfg.vocab_size, (2, n_tokens)).astype(np.int32)}
    if cfg.encoder_decoder:
        arrays["enc_embeds"] = rng.standard_normal((2, prompt, cfg.d_model)).astype(np.float32)
    if cfg.n_prefix_embeds:
        arrays["prefix_embeds"] = (rng.standard_normal((2, cfg.n_prefix_embeds, cfg.d_model)) * 0.02).astype(np.float32)
    return ({k: v.copy() for k, v in arrays.items()}, {k: jnp.array(v, copy=True) for k, v in arrays.items()},
            cfg.n_prefix_embeds + n_tokens)


@pytest.mark.parametrize("arch", PORTED)
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("prompt", [12, 48])
def test_forward_prefill_decode_match_reference(monkeypatch, arch, compute_dtype, prompt):
    if arch in MOE:
        monkeypatch.setattr(ref_attention, "jnp", F32Dots(jnp))
    ref_model, params, model = _pair(arch, compute_dtype)
    tol = TOL[compute_dtype]
    routes = Routes(monkeypatch) if arch in MOE else None

    def held():
        """The batch rows held to the reference: all, but in bf16 a row whose
        routing flipped at a near tie."""
        if routes is not None:
            routes.update()
            assert compute_dtype == "bfloat16" or not routes.flipped, "f32 routing differs"
            return [r for r in range(2) if r not in routes.flipped]
        return [0, 1]

    port_batch, ref_batch, start = _batches(model.cfg, prompt)
    cache_len = prompt if model.cfg.encoder_decoder else start + 4
    got = model.apply(port_batch)
    want = np.asarray(jax.jit(ref_model.apply)(params, ref_batch))
    _close(got[held()], want[held()], tol)
    ref_logits, ref_cache = jax.jit(lambda p, b: ref_model.prefill(p, b, cache_len))(params, ref_batch)
    logits, cache = model.prefill(port_batch, cache_len)
    _close(logits[held()], np.asarray(ref_logits)[held()], tol)
    names = tuple(cache)
    assert set(names) == _ref_cache_names(ref_cache) == set(model.cache_spec(2, cache_len))
    for name in names:
        _close(cache[name].float()[:, held()], _ref_cache(ref_model, ref_cache, name)[:, held()], tol)
    decode = jax.jit(ref_model.decode_step)
    nxt = np.array(jnp.argmax(ref_logits[:, -1], -1), np.int32)[:, None]
    for t in range(3):
        ref_logits, ref_cache = decode(params, ref_cache, jnp.asarray(nxt), jnp.int32(start + t))
        logits, cache = model.decode_step(cache, nxt, start + t)
        _close(logits[held()], np.asarray(ref_logits)[held()], tol)
        _greedy_equal_where_clear(logits[held()], np.asarray(ref_logits)[held()], tol)
        nxt = np.array(jnp.argmax(ref_logits, -1), np.int32)[:, None]
    for name in names:
        _close(cache[name].float()[:, held()], _ref_cache(ref_model, ref_cache, name)[:, held()], tol)
    assert held(), "the routing flipped in every batch row: nothing held to the reference"
    if routes is not None:
        assert routes.checked == 2 * (2 * prompt + 3) * sum(map(model.cfg.moe_at, range(model.cfg.n_layers)))


def test_decode_past_the_cache_clamps_like_dynamic_update_slice():
    """At pos >= cache_len the reference writes K/V at the last slot and every
    column is live; the port gives the same logits and cache."""
    ref_model, params, model = _pair("smollm-360m", "float32")
    tokens = np.arange(10, dtype=np.int32)[None, :] % model.cfg.vocab_size
    ref_logits, ref_cache = ref_model.prefill(params, {"tokens": jnp.asarray(tokens)}, 10)
    logits, cache = model.prefill({"tokens": tokens}, 10)
    nxt = np.array([[3]], np.int32)
    for pos in (10, 11, 25):
        ref_logits, ref_cache = ref_model.decode_step(params, ref_cache, jnp.asarray(nxt), jnp.int32(pos))
        logits, cache = model.decode_step(cache, nxt, pos)
        _close(logits, ref_logits, TOL["float32"])
        _close(cache["k"], ref_cache["blocks"]["0"]["k"], TOL["float32"])


def test_init_follows_the_specs():
    """Model.init: normal x 0.02 weights, ones for the norms, from a
    torch.Generator; the same seed gives the same weights."""
    cfg = configs.get_config("smollm-360m").reduced()
    a = build(cfg, device="cpu").init(torch.Generator().manual_seed(5))
    b = build(cfg, device="cpu").init(torch.Generator().manual_seed(5))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
        if name.endswith(("ln1", "ln2", "ln_f")):
            assert torch.equal(pa, torch.ones_like(pa))
        else:
            assert 0.015 < float(pa.std()) < 0.025, name


def test_compute_copies_follow_parameter_changes():
    """bf16 compute copies are made once and made again after a parameter changes."""
    cfg = dataclasses.replace(configs.get_config("smollm-360m").reduced(), compute_dtype="bfloat16")
    model = build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    first = model.params()
    assert model.params() is first and first["embed"].dtype == torch.bfloat16
    with torch.no_grad():
        model.ln_f.mul_(2.0)
    assert model.params() is not first
    assert torch.equal(model.params()["ln_f"], torch.full_like(first["ln_f"], 2.0))


@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-v2-236b"])
def test_port_arrays_unstack_the_layers_axis(arch):
    """Blocks unstack into ``layers.<i>`` after the prefix layers (deepseek:
    one dense prefix layer, ``stack.prefix.0``), nested names (the shared
    expert's ``ffn.shared.w_gate``) and 3-d expert arrays included."""
    cfg = configs.get_config(arch).reduced()
    n_prefix = cfg.first_k_dense
    n_blocks = cfg.n_layers - n_prefix
    stacked = np.arange(n_prefix, cfg.n_layers)[:, None] * np.ones((1, cfg.d_model))
    tree = {"embed": np.zeros((cfg.vocab_size, cfg.d_model)), "stack": {"blocks": {"0": {"ln1": stacked}}}}
    if n_prefix:
        tree["stack"]["prefix"] = {"0": {"ln1": np.zeros(cfg.d_model)}}
        f = cfg.moe_d_ff
        tree["stack"]["blocks"]["0"]["ffn"] = {
            "w_gate": np.arange(n_blocks)[:, None, None, None] * np.ones((1, cfg.n_experts, cfg.d_model, f)),
            "shared": {"w_gate": np.arange(n_blocks)[:, None, None] * np.ones((1, cfg.d_model, f))}}
    arrays = port_arrays(cfg, tree)
    assert [float(arrays[f"layers.{i}.ln1"][0]) for i in range(cfg.n_layers)] == list(range(cfg.n_layers))
    if n_prefix:
        for i in range(n_prefix, cfg.n_layers):
            assert arrays[f"layers.{i}.ffn.w_gate"].shape == (cfg.n_experts, cfg.d_model, cfg.moe_d_ff)
            assert float(arrays[f"layers.{i}.ffn.shared.w_gate"][0, 0]) == i - n_prefix
        names = dict(build(cfg, device="cpu").named_parameters())
        assert all(name in names for name in arrays if name.startswith("layers."))
    model = build(cfg, device="cpu")
    with pytest.raises(ValueError, match="parameter trees differ"):
        params_from_jax(model, tree)


@pytest.mark.parametrize("arch,n_layers", [("rwkv6-7b", None), ("jamba-1.5-large-398b", None),
                                           ("jamba-1.5-large-398b", 5)])
def test_port_arrays_unstack_the_ssm_patterns(arch, n_layers):
    """The reference's spec tree at full width (rwkv6: a 1-sublayer pattern
    in 32 blocks; jamba: its 8-sublayer pattern in 9 blocks, and at the
    served cut of 5 layers one block of 5) unstacks into every port
    parameter once, each layer's slice at its own index, with the shape of
    the port's spec. The arrays stand in for the weights (one value a layer)."""
    from repro.models.model import lm_specs as ref_lm_specs
    from repro.models.transformer import stack_pattern

    over = {} if n_layers is None else {"n_layers": n_layers}
    cfg = dataclasses.replace(configs.get_config(arch), **over)
    ref_cfg = dataclasses.replace(ref_configs.get_config(arch), **over)
    prefix, pattern, n_blocks = stack_pattern(ref_cfg)
    assert (len(pattern), n_blocks) == {("rwkv6-7b", None): (1, 32), ("jamba-1.5-large-398b", None): (8, 9),
                                        ("jamba-1.5-large-398b", 5): (5, 1)}[(arch, n_layers)]

    def tree(specs, j=None):
        out = {}
        for k, v in specs.items():
            if isinstance(v, ref_common.ParamSpec):
                out[k] = (np.zeros(1) if j is None else
                          len(prefix) + np.arange(n_blocks)[:, None] * len(pattern) + j)
            else:
                out[k] = tree(v, int(k) if j is None and k.isdigit() and specs is blocks else j)
        return out

    specs = ref_lm_specs(ref_cfg)
    blocks = specs["stack"]["blocks"]
    arrays = port_arrays(cfg, tree(specs))
    model = build(cfg, device="meta")
    port = model.port_specs()
    assert set(arrays) == set(port) == {name for name, _ in model.named_parameters()}
    for name, array in arrays.items():
        if name.startswith("layers."):
            i = int(name.split(".")[1])
            assert float(array[0]) == i, name
    for i, desc in enumerate(model.descs):
        keys = {n.split(".", 2)[2] for n in port if n.startswith(f"layers.{i}.")}
        assert ("mixer.a_log" in keys) == (desc.mixer == "mamba") and ("mixer.wq" in keys) == (desc.mixer == "gqa")
        assert ("ffn.router" in keys) == (desc.ffn == "moe") and ("mixer.bonus_u" in keys) == (desc.mixer == "rwkv6")


@pytest.mark.parametrize("causal,q_offset", [(True, 0), (False, 0), (True, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_attention_paths_match_reference(causal, q_offset, dtype):
    """chunked_attention and naive_causal_attention with the reference's bf16
    rounding points (p cast to V's type before PV)."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((2, 32, 6, 16), (2, 48, 2, 16), (2, 48, 2, 16)))
    tq, tk, tv = (torch.tensor(a).to(getattr(torch, dtype)) for a in (q, k, v))
    jq, jk, jv = (jnp.array(a).astype(dtype) for a in (q, k, v))
    tol = TOL[dtype]
    got = common.chunked_attention(tq, tk, tv, causal=causal, chunk_q=16, chunk_k=16, q_offset=q_offset)
    want = ref_common.chunked_attention(jq, jk, jv, causal=causal, chunk_q=16, chunk_k=16, q_offset=q_offset)
    _close(got.float(), want, tol)
    got = common.naive_causal_attention(tq, tk, tv, causal=causal, q_offset=q_offset)
    want = ref_common.naive_causal_attention(jq, jk, jv, causal=causal, q_offset=q_offset)
    _close(got.float(), want, tol)


@pytest.mark.parametrize("pos", [0, 20, 47, 60])
def test_plain_decode_attention_matches_reference(pos):
    rng = np.random.default_rng(pos)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((2, 1, 6, 16), (2, 48, 2, 16), (2, 48, 2, 16)))
    got = common.decode_attention(*(torch.tensor(a) for a in (q, k, v)), pos)
    want = ref_common.decode_attention(*(jnp.array(a) for a in (q, k, v)), jnp.int32(pos))
    _close(got, want, TOL["float32"])


def test_norm_and_rope_match_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = np.arange(5, dtype=np.int32)[None, :].repeat(2, 0)
    for dtype in ("float32", "bfloat16"):
        got = common.rope(torch.tensor(x).to(getattr(torch, dtype)), torch.tensor(pos), 1e6)
        want = ref_common.rope(jnp.array(x).astype(dtype), jnp.array(pos), 1e6)
        _close(got.float(), want, TOL[dtype])
    g = rng.standard_normal(16).astype(np.float32)
    _close(common.rms_norm(torch.tensor(x), torch.tensor(g)), ref_common.rms_norm(jnp.array(x), jnp.array(g)),
           TOL["float32"])
