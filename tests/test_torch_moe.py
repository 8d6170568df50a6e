"""The port's MoE FFN and MLA attention against the reference's, on the CPU.

Inputs are made with numpy from a seed and each package gets its own copy;
weights come from the reference's ``init_params`` (PRNGKey) and are handed to
the port as numpy arrays.

* The route step (top k of the f32 router logits, softmax weights) equals
  ``jax.lax.top_k`` + softmax exactly, on random logits and on logits with
  deliberate ties (equal router columns), where ``jax.lax.top_k`` puts the
  lower expert id first.
* The dispatch (stable sort by expert, position within the expert, capacity
  drop) equals the reference's exactly: the capacity buffers that the
  reference's ``moe_apply`` builds (read where it hands them to
  ``shard_hint``) hold the same copies in the same slots, on a row where
  expert 0 overflows and on rows where none does.
* ``moe_apply`` and ``aux_load_balance_loss`` equal the reference's within
  the model tests' TOL, with shared experts (deepseek reduced) and without
  (grok reduced). MLA's apply, prefill (its latent cache included) and
  decode equal the reference's, decode at positions inside the cache and
  past its end (the write clamps as ``dynamic_update_slice``).

XLA's CPU runtime (jax 0.9.0) refuses one of the reference's bf16 products
with f32 output (``DotThunk``: BF16 x BF16 = F32, the weight-absorbed
decode's ``o_lat``); where a test runs the reference's MLA decode in bf16 it
takes those products on f32 operands (:class:`F32Dots`), which gives the
same values: a product of two bf16 numbers is exact in f32, and both sum in
f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as ref_attention
import repro.models.moe as ref_moe
from repro import configs as ref_configs
from repro.models.common import init_params
from repro_torch import configs
from repro_torch.models import attention, moe

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


class F32Dots:
    """``jax.numpy`` with each einsum asked for f32 output taken on f32
    operands (the value XLA would give; its CPU runtime refuses the bf16
    form in one place)."""

    def __init__(self, module):
        self._module = module

    def __getattr__(self, name):
        return getattr(self._module, name)

    def einsum(self, spec, *operands, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            operands = [o.astype(jnp.float32) for o in operands]
        return self._module.einsum(spec, *operands, preferred_element_type=preferred_element_type, **kw)


def _cfgs(arch, dtype="float32", **over):
    ref = dataclasses.replace(ref_configs.get_config(arch).reduced(), compute_dtype=dtype, **over)
    port = dataclasses.replace(configs.get_config(arch).reduced(), compute_dtype=dtype, **over)
    return ref, port


def _weights(specs, seed):
    """The reference's params (f32) and the port's copy (torch tensors)."""
    params = init_params(jax.random.PRNGKey(seed), specs, jnp.float32)
    return params, jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), params)


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.astype(dtype) if isinstance(tree, jax.Array) else tree.to(getattr(torch, dtype))


def _x(shape, seed, dtype="float32"):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.array(a, copy=True).astype(dtype), torch.tensor(a).to(getattr(torch, dtype))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


# ----------------------------------------------------------------- route


def _ref_route(router, x, k):
    logits = jnp.einsum("bsd,de->bse", x, router).astype(jnp.float32)
    topw, topi = jax.lax.top_k(logits, k)
    return jax.nn.softmax(topw, axis=-1).astype(x.dtype), topi, logits


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tied", [False, True])
def test_route_equals_top_k_and_softmax(dtype, tied):
    """Random router, and one whose columns 1..5 are equal (their logits tie
    in every token, in both packages): the same expert ids in the same order
    (the lower id first among ties), the same weights."""
    e, k = 8, 3
    rng = np.random.default_rng(11)
    router = rng.standard_normal((16, e)).astype(np.float32) * 0.3
    if tied:
        router[:, 1:6] = router[:, 1:2]
        router[:, 0] = router[:, 1] * 0.5  # below the tied group where the tie is positive
    jr, tr = jnp.array(router, copy=True).astype(dtype), torch.tensor(router).to(getattr(torch, dtype))
    jx, tx = _x((2, 24, 16), 12, dtype)
    w, ids = moe.route(tr, tx, k)
    ref_w, ref_ids, ref_logits = _ref_route(jr, jx, k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    np.testing.assert_allclose(_np(w), _np(ref_w), rtol=2**-8 if dtype == "bfloat16" else 1e-6, atol=0)
    # the selection alone, on the reference's own logits: exactly jax.lax.top_k
    values, idx = moe.top_k(torch.tensor(np.asarray(ref_logits)), k)
    ref_values, ref_idx = jax.lax.top_k(ref_logits, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(values.numpy(), np.asarray(ref_values))
    if tied:
        logits = np.asarray(ref_logits)
        assert (logits[..., 1:6] == logits[..., 1:2]).all()
        # each token picks tied experts, lowest ids first
        picked = np.asarray(ref_idx)
        in_group = (picked >= 1) & (picked <= 5)
        assert in_group.any()
        for row in picked.reshape(-1, k):
            group = [i for i in row if 1 <= i <= 5]
            assert group == list(range(1, 1 + len(group)))


def test_top_k_keeps_the_lower_id_first_on_exact_ties():
    logits = torch.tensor([[0.5, 1.0, 1.0, 1.0, 0.5, 1.0]])
    values, idx = moe.top_k(logits, 4)
    assert idx.tolist() == [[1, 2, 3, 5]] and values.tolist() == [[1.0] * 4]
    ref_values, ref_idx = jax.lax.top_k(jnp.array(logits.numpy()), 4)
    assert np.asarray(ref_idx).tolist() == idx.tolist()


# -------------------------------------------------------------- dispatch


def _ref_buffers(monkeypatch, params, x, cfg):
    """The reference's ``moe_apply`` output and the capacity buffers it built
    (the first (B, E, C, d) tensor it hands to ``shard_hint``)."""
    seen = []

    def hint(a, *axes):
        if axes == ("batch", "experts", None, None):
            seen.append(a)
        return a

    monkeypatch.setattr(ref_moe, "shard_hint", hint)
    out = ref_moe.moe_apply(params, x, cfg)
    return out, seen[0]


@pytest.mark.parametrize("s,biased", [(48, True), (12, True), (8, False)])
def test_dispatch_positions_and_drops_equal_the_reference(monkeypatch, s, biased):
    """grok reduced (E = 4, k = 2): with the router biased so that every token
    picks expert 0 first, expert 0 gets S copies; at S = 48 (C = 32) 16 of
    them are dropped, at S = 12 (C = 8) 4. Unbiased at S = 8 no expert
    overflows. The port's buffers equal the reference's bit for bit (the same
    copy in the same slot), and its kept mask drops exactly the copies at
    position >= C of the stable order."""
    ref_cfg, cfg = _cfgs("grok-1-314b")
    specs = ref_moe.moe_specs(ref_cfg)
    params, tparams = _weights(specs, 3)
    a = np.random.default_rng(s).standard_normal((2, s, cfg.d_model)).astype(np.float32)
    if biased:  # feature 0 is 4 in every token and feeds expert 0's logit 10-fold
        a[..., 0] = 4.0
        params = {**params, "router": params["router"].at[0, 0].add(10.0)}
        tparams = {**tparams, "router": torch.tensor(np.asarray(params["router"]))}
    jx, tx = jnp.array(a, copy=True), torch.tensor(a)
    ref_out, ref_buf = _ref_buffers(monkeypatch, params, jx, ref_cfg)
    k, cap = cfg.experts_per_token, moe._capacity(s, cfg)
    assert cap == ref_moe._capacity(s, ref_cfg) == ref_buf.shape[2]
    _, ids = moe.route(tparams["router"], tx, k)
    disp = moe.dispatch(tx, ids.reshape(2, s * k), cfg.n_experts, k, cap)
    np.testing.assert_array_equal(disp.buf.numpy(), np.asarray(ref_buf))
    # the kept mask: a copy is kept iff fewer than C earlier copies (stable order) chose its expert
    eid = ids.reshape(2, s * k).numpy()
    for r in range(2):
        rank = np.array([(eid[r, :i] == eid[r, i]).sum() for i in range(s * k)])
        np.testing.assert_array_equal(disp.pos[r].numpy(), rank)
        np.testing.assert_array_equal(disp.keep[r].numpy(), rank < cap)
    dropped = int((~disp.keep).sum())
    if biased:
        assert (eid[:, 0::k] == 0).all() and dropped == 2 * max(0, s - cap) > 0
    else:
        assert dropped == 0
    _close(moe.moe_apply(tparams, tx, cfg), ref_out, TOL["float32"])


# ------------------------------------------------------------- moe_apply


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "grok-1-314b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_apply_and_aux_loss_match_reference(arch, dtype):
    """deepseek reduced has a shared expert (E = 4, k = 2, d_ff 64), grok
    reduced none (d_ff 128); S = 40 runs near the capacity (C = 32)."""
    ref_cfg, cfg = _cfgs(arch, dtype)
    params, tparams = _weights(ref_moe.moe_specs(ref_cfg), 5)
    assert ("shared" in params) == (arch == "deepseek-v2-236b")
    params, tparams = _cast(params, dtype), _cast(tparams, dtype)
    jx, tx = _x((2, 40, cfg.d_model), 6, dtype)
    got = moe.moe_apply(tparams, tx, cfg)
    want = jax.jit(lambda p, x: ref_moe.moe_apply(p, x, ref_cfg))(params, jx)
    assert got.dtype == tx.dtype and tuple(got.shape) == tuple(want.shape)
    _close(got, want, TOL[dtype])
    loss = moe.aux_load_balance_loss(tparams, tx, cfg)
    _close(loss, ref_moe.aux_load_balance_loss(params, jx, ref_cfg), 1e-5)


def test_moe_specs_match_reference():
    for arch in ("deepseek-v2-236b", "grok-1-314b"):
        ref_cfg, cfg = _cfgs(arch)
        ref, port = ref_moe.moe_specs(ref_cfg), moe.moe_specs(cfg)
        assert jax.tree_util.tree_map(lambda s: (s.shape, s.logical_axes), ref,
                                      is_leaf=lambda s: hasattr(s, "logical_axes")) == \
            jax.tree_util.tree_map(lambda s: (s.shape, s.logical_axes), port,
                                   is_leaf=lambda s: hasattr(s, "logical_axes"))


# ------------------------------------------------------------------- MLA


@pytest.fixture(scope="module")
def mla_weights():
    """deepseek reduced's MLA weights (q_lora 32, kv_lora 16, nope/rope/v 16/8/16, 4 heads)."""
    ref_cfg, cfg = _cfgs("deepseek-v2-236b")
    params, tparams = _weights(ref_attention.mla_specs(ref_cfg), 7)
    return params, tparams


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [12, 48])
def test_mla_apply_and_prefill_match_reference(mla_weights, dtype, s):
    """The dense attention branch (12 tokens) and the chunked one (48: the
    reduced configs switch at 16), V padded to the QK head dim 24; prefill's
    latent cache right-padded to S + 4."""
    ref_cfg, cfg = _cfgs("deepseek-v2-236b", dtype)
    params, tparams = (_cast(w, dtype) for w in mla_weights)
    jx, tx = _x((2, s, cfg.d_model), s, dtype)
    tol = TOL[dtype]
    _close(attention.mla_apply(tparams, tx, cfg), jax.jit(lambda p, x: ref_attention.mla_apply(p, x, ref_cfg))(params, jx),
           tol)
    out, cache = attention.mla_prefill(tparams, tx, cfg, s + 4)
    ref_out, ref_cache = jax.jit(lambda p, x: ref_attention.mla_prefill(p, x, ref_cfg, s + 4))(params, jx)
    _close(out, ref_out, tol)
    assert set(cache) == set(ref_cache) == {"ckv", "k_rope"}
    for name in cache:
        assert tuple(cache[name].shape) == tuple(ref_cache[name].shape)
        _close(cache[name], ref_cache[name], tol)
        assert not cache[name][:, s:].any()
    with pytest.raises(ValueError, match="does not fit"):
        attention.mla_prefill(tparams, tx, cfg, s - 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_matches_reference_inside_and_past_the_cache(mla_weights, monkeypatch, dtype):
    """Weight-absorbed decode on the latent cache of a 10-token prefill
    (cache_len 12) at positions 10, 11 (the last slot), 12 and 20 (past the
    end: the write lands in the last slot and every column is live): the same
    output and the same cache, updated in place."""
    monkeypatch.setattr(ref_attention, "jnp", F32Dots(jnp))
    ref_cfg, cfg = _cfgs("deepseek-v2-236b", dtype)
    params, tparams = (_cast(w, dtype) for w in mla_weights)
    jx, tx = _x((2, 10, cfg.d_model), 1, dtype)
    _, cache = attention.mla_prefill(tparams, tx, cfg, 12)
    _, ref_cache = jax.jit(lambda p, x: ref_attention.mla_prefill(p, x, ref_cfg, 12))(params, jx)
    decode = jax.jit(lambda p, x, c, pos: ref_attention.mla_decode(p, x, c, pos, ref_cfg))
    tol = TOL[dtype]
    for i, pos in enumerate((10, 11, 12, 20)):
        jy, ty = _x((2, 1, cfg.d_model), 100 + i, dtype)
        ckv = cache["ckv"]
        out, cache = attention.mla_decode(tparams, ty, cache, pos, cfg)
        ref_out, ref_cache = decode(params, jy, ref_cache, jnp.int32(pos))
        assert cache["ckv"] is ckv
        _close(out, ref_out, tol)
        for name in cache:
            _close(cache[name], ref_cache[name], tol)


def test_mla_specs_and_cache_spec_match_reference():
    ref_cfg, cfg = _cfgs("deepseek-v2-236b")
    for name, s in attention.mla_specs(cfg).items():
        ref = ref_attention.mla_specs(ref_cfg)[name]
        assert (s.shape, s.logical_axes) == (ref.shape, ref.logical_axes), name
    ref_spec = ref_attention.mla_cache_spec(ref_cfg, 2, 12, jnp.float32)
    spec = attention.mla_cache_spec(cfg, 2, 12, torch.float32)
    assert {k: v[:2] for k, v in spec.items()} == {k: v[:2] for k, v in ref_spec.items()}
