"""The port's encoder-decoder (``repro_torch.models.whisper`` through
``Model``) against the reference's ``repro.models.whisper``, on the CPU.

The reduced whisper-large-v3 (2 encoder and 4 decoder layers, d_model 64, 4
heads of 16, 16 target positions) with the reference's weights (its ``init``
from ``PRNGKey(0)``) carried across by ``convert.params_from_jax``. Both
packages run ``encode``, ``hidden``, ``apply``, ``prefill`` (logits and the
four cache leaves) and 3 ``decode_step``s on the same inputs: a source of 32
or 48 frames (past the reduced config's chunk threshold of 16, so that the
encoder runs the chunked path on the CPU) and prompts of 4 and 12 tokens.
Tolerances as in tests/test_torch_models.py: float32 1e-5, bfloat16 2e-2,
each as ``atol`` and ``rtol``. Each package gets its own copy of every input
array.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import build as ref_build
from repro.models import whisper as ref_whisper
from repro_torch import configs
from repro_torch.models import build, whisper
from repro_torch.models.convert import params_from_jax, port_arrays

ARCH = "whisper-large-v3"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = ("float32", "bfloat16")
CACHE_NAMES = ("self_k", "self_v", "cross_k", "cross_v")


def _pair(compute_dtype):
    ref_cfg = dataclasses.replace(ref_configs.get_config(ARCH).reduced(), compute_dtype=compute_dtype)
    cfg = dataclasses.replace(configs.get_config(ARCH).reduced(), compute_dtype=compute_dtype)
    ref_model = ref_build(ref_cfg)
    params = ref_model.init(jax.random.PRNGKey(0))
    model = params_from_jax(build(cfg, device="cpu"), jax.tree_util.tree_map(np.asarray, params))
    return ref_model, params, model


def _batch(cfg, src_len, n_tokens, seed):
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((2, src_len, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (2, n_tokens)).astype(np.int32)
    return ({"enc_embeds": enc.copy(), "tokens": tokens.copy()},
            {"enc_embeds": jnp.array(enc, copy=True), "tokens": jnp.array(tokens, copy=True)})


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("compute_dtype", DTYPES)
@pytest.mark.parametrize("src_len", [32, 48])
def test_encode_matches_reference(compute_dtype, src_len):
    ref_model, params, model = _pair(compute_dtype)
    port_batch, ref_batch = _batch(model.cfg, src_len, 4, seed=src_len)
    cdt = jnp.dtype(compute_dtype)
    want = ref_whisper.encode(ref_model.cfg, jax.tree_util.tree_map(lambda a: a.astype(cdt), params),
                              ref_batch["enc_embeds"].astype(cdt))
    got = whisper.encode(model.cfg, model.params(), model._embeds(port_batch["enc_embeds"]))
    assert got.shape == (2, src_len, model.cfg.d_model) and got.dtype == model.compute_dtype
    _close(got.float(), want, TOL[compute_dtype])


@pytest.mark.parametrize("compute_dtype", DTYPES)
def test_hidden_and_apply_match_reference(compute_dtype):
    ref_model, params, model = _pair(compute_dtype)
    port_batch, ref_batch = _batch(model.cfg, 32, model.cfg.max_target_positions, seed=3)
    tol = TOL[compute_dtype]
    want = jax.jit(ref_model.hidden)(params, ref_batch)
    _close(model.hidden(port_batch).float(), want, tol)
    got = model.apply(port_batch)
    assert got.dtype == torch.float32 and got.shape == (2, model.cfg.max_target_positions, model.cfg.vocab_size)
    _close(got, jax.jit(ref_model.apply)(params, ref_batch), tol)
    direct = whisper.apply(model.cfg, model.params(), model._embeds(port_batch["enc_embeds"]),
                           model._tokens(port_batch["tokens"]))
    assert torch.equal(direct, got)


@pytest.mark.parametrize("compute_dtype", DTYPES)
@pytest.mark.parametrize("prompt", [4, 12])
def test_prefill_and_decode_match_reference(compute_dtype, prompt):
    """prefill's logits and all four cache leaves, then 3 greedy decode steps
    (the reference's tokens fed to both) and the caches after them."""
    ref_model, params, model = _pair(compute_dtype)
    cfg = model.cfg
    tol = TOL[compute_dtype]
    port_batch, ref_batch = _batch(cfg, 48, prompt, seed=prompt)
    ref_logits, ref_cache = jax.jit(lambda p, b: ref_model.prefill(p, b, 48))(params, ref_batch)
    logits, cache = model.prefill(port_batch, 48)
    _close(logits, ref_logits, tol)
    assert tuple(cache) == CACHE_NAMES and set(ref_cache) == set(CACHE_NAMES)
    spec = model.cache_spec(2, 48)
    for name in CACHE_NAMES:
        assert tuple(cache[name].shape) == spec[name][0] == tuple(ref_cache[name].shape), name
        _close(cache[name].float(), ref_cache[name], tol)
    decode = jax.jit(ref_model.decode_step)
    nxt = np.array(jnp.argmax(ref_logits[:, -1], -1), np.int32)[:, None]
    for t in range(3):
        ref_logits, ref_cache = decode(params, ref_cache, jnp.asarray(nxt), jnp.int32(prompt + t))
        logits, cache = model.decode_step(cache, nxt, prompt + t)
        assert logits.shape == (2, cfg.vocab_size)
        _close(logits, ref_logits, tol)
        nxt = np.array(jnp.argmax(ref_logits, -1), np.int32)[:, None]
    for name in CACHE_NAMES:
        _close(cache[name].float(), ref_cache[name], tol)


def test_cache_spec_lengths():
    """``cache_len`` is the source length; the self cache is always
    ``max_target_positions`` long, in the compute dtype."""
    cfg = configs.get_config(ARCH)
    model = build(cfg, device="meta")
    spec = model.cache_spec(3, 1_500)
    L, kh, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    assert spec["self_k"][0] == spec["self_v"][0] == (L, 3, 448, kh, hd)
    assert spec["cross_k"][0] == spec["cross_v"][0] == (L, 3, 1_500, kh, hd)
    assert all(dt == torch.bfloat16 for _, _, dt in spec.values())
    ref_spec = ref_build(ref_configs.get_config(ARCH)).cache_spec(3, 1_500)
    assert {k: (v[0], v[1]) for k, v in spec.items()} == {k: (v[0], v[1]) for k, v in ref_spec.items()}


def test_port_arrays_unstack_the_encoder_and_decoder():
    """The reference's spec tree at full width (32 + 32 layers) unstacks into
    every port parameter once, each layer's slice at its own index, the
    final encoder norm kept; each array stands in for its layer (one value)."""
    from repro.models.common import ParamSpec as RefSpec

    cfg = configs.get_config(ARCH)
    specs = ref_whisper.whisper_specs(ref_configs.get_config(ARCH))

    def tree(node):
        return {k: (np.arange(v.shape[0]) if "layers" in v.logical_axes else np.zeros(1))
                if isinstance(v, RefSpec) else tree(v) for k, v in node.items()}

    arrays = port_arrays(cfg, tree(specs))
    model = build(cfg, device="meta")
    assert set(arrays) == set(model.port_specs()) == {name for name, _ in model.named_parameters()}
    assert "enc_ln_f" in arrays and len([n for n in arrays if n.startswith("encoder.")]) == 32 * 8
    for name, array in arrays.items():
        if name.startswith(("encoder.", "decoder.")):
            assert int(array) == int(name.split(".")[1]), name
    bad = tree(specs)
    bad["decoder"]["ln1"] = np.zeros(31)
    with pytest.raises(ValueError, match="31 stacked layers, the config has 32"):
        port_arrays(cfg, bad)
