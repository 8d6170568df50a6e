"""The port's SSM mixers (``repro_torch.models.ssm``) against the reference's
``repro.models.ssm``, on the CPU.

RWKV6's time-mix (``rwkv6_apply``, ``rwkv6_decode``), its channel mix
(``rwkv6_cmix_apply``) and Mamba (``mamba_apply``, from zeros and from a prior
``conv``/``h`` carry) at the reduced rwkv6-7b and jamba-1.5-large-398b widths,
on sequences of 1, 12, 300 (one unchunked scan) and 512 tokens (the
reference's chunked scan, 2 x ``TIME_CHUNK``). The weights and inputs are
numpy draws from a seed, each array copied into both packages. The weights
are drawn at the scale of a trained model rather than at ``init``'s (where
``bonus_u``, ``a_log``, ``conv_w`` and the decay's lora are 1e-3 and the
decay base 0): there the recurrences' terms are large enough that a wrong
state, decay or bonus moves the outputs well past the tolerance.
Tolerances as in tests/test_torch_models.py: float32 1e-5 (the order of a
few f32 sums), bfloat16 2e-2 (bf16 roundings at different points in the two
frameworks), each as ``atol`` and ``rtol``.

A prefill over the first tokens followed by one decode step a token carries
the state exactly as one pass over the whole sequence does, and a decode
writes its cache in place.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import ssm as ref_ssm
from repro_torch import configs
from repro_torch.models import ssm

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LENGTHS = (1, 12, 300, 512)
DTYPES = ("float32", "bfloat16")
#: each parameter's draw: ("normal", std), ("uniform", lo, hi) or ("ones+normal", std); a std of
#: None means 1/sqrt(fan_in), fan_in the product of the leading axes a matmul contracts. Mamba's
#: dt_bias and a_log as a trained model's (dt in about [0.02, 0.3], A in [-16, -1]), w_x at half
#: the fan-in scale: its B and C then keep y = C h + D u at O(1), where one bf16 rounding is within
#: the tolerance (at the fan-in scale |y| reaches 25, where a bf16 ulp is 0.125). RWKV's wo at half
#: the fan-in scale keeps its outputs at about 1, the magnitude the bf16 tolerance is stated for: at
#: the fan-in scale they reach 3, and after 312 steps in bf16 each package lies about 0.055 from the
#: same function in float64 (seed 10), and the two 0.031 apart
RWKV_DRAWS = {
    "mix": ("uniform", 0.0, 1.0), "wr": ("normal", None), "wk": ("normal", None), "wv": ("normal", None),
    "wg": ("normal", None), "w_decay_a": ("normal", 0.1), "w_decay_b": ("normal", 0.1),
    "decay_base": ("normal", 1.0), "bonus_u": ("normal", 1.0), "wo": ("normal", 0.5 / np.sqrt(64)),
    "ln_x": ("ones+normal", 0.1),
}
MAMBA_DRAWS = {
    "w_in": ("normal", None), "conv_w": ("normal", 0.5), "conv_b": ("normal", 0.1), "w_x": ("normal", 0.5 / np.sqrt(128)),
    "w_dt": ("normal", None), "dt_bias": ("uniform", -4.0, -1.0), "a_log": ("uniform", 0.0, np.log(16)), "d_skip": ("ones+normal", 0.1),
    "w_out": ("normal", None),
}
CMIX_DRAWS = {"mix": ("uniform", 0.0, 1.0), "wk": ("normal", None), "wv": ("normal", None), "wr": ("normal", None)}
FAN_IN_AXES = {"wo": 2}  # (h, n, d): contracts two axes


def _cfgs(arch, dtype):
    ref = dataclasses.replace(ref_configs.get_config(arch).reduced(), compute_dtype=dtype)
    port = dataclasses.replace(configs.get_config(arch).reduced(), compute_dtype=dtype)
    return ref, port


def _draw(specs, draws, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in specs.items():
        how = draws[name]
        if how[0] == "uniform":
            a = rng.uniform(how[1], how[2], spec.shape)
        else:
            std = how[1] if how[1] is not None else 1 / np.sqrt(np.prod(spec.shape[:FAN_IN_AXES.get(name, 1)]))
            a = rng.standard_normal(spec.shape) * std + (1.0 if how[0] == "ones+normal" else 0.0)
        out[name] = a.astype(np.float32)
    return out


def _both(arrays: dict, dtype: str):
    """Each array as the reference's (jnp) and the port's (torch) copy, cast to ``dtype``."""
    ref = {k: jnp.asarray(v).astype(dtype) for k, v in arrays.items()}
    port = {k: torch.tensor(v).to(getattr(torch, dtype)) for k, v in arrays.items()}
    return ref, port


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


def _x(cfg, s, seed):
    return np.random.default_rng(seed).standard_normal((2, s, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", LENGTHS)
def test_rwkv6_apply_matches_reference(dtype, s):
    """From zeros and from a prior state and token-shift carry: the output,
    the final state (f32) and the carried last token."""
    ref_cfg, cfg = _cfgs("rwkv6-7b", dtype)
    ref_p, p = _both(_draw(ssm.rwkv6_specs(cfg), RWKV_DRAWS, 1), dtype)
    (ref_x,), (x,) = (v.values() for v in _both({"x": _x(cfg, s, 2)}, dtype))
    out, (state, last) = ssm.rwkv6_apply(p, x, cfg)
    want, (ref_state, ref_last) = ref_ssm.rwkv6_apply(ref_p, ref_x, ref_cfg)
    tol = TOL[dtype]
    _close(out, want, tol)
    _close(state, ref_state, tol)
    assert state.dtype == torch.float32 and torch.equal(last, x[:, -1, :])
    rng = np.random.default_rng(3)
    carry = {"state": rng.standard_normal(state.shape).astype(np.float32),
             "prev_x": rng.standard_normal(last.shape).astype(np.float32)}
    ref_c, c = _both(carry, dtype)
    c["state"] = c["state"].float()
    out, (state, _) = ssm.rwkv6_apply(p, x, cfg, c["state"], c["prev_x"])
    want, (ref_state, _) = ref_ssm.rwkv6_apply(ref_p, ref_x, ref_cfg, ref_c["state"].astype(jnp.float32),
                                               ref_c["prev_x"])
    _close(out, want, tol)
    _close(state, ref_state, tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", LENGTHS)
def test_mamba_apply_matches_reference(dtype, s):
    """From zeros and from a prior ``conv``/``h`` carry: the output, ``h``
    (f32) and the conv carry; the given cache is left unwritten."""
    ref_cfg, cfg = _cfgs("jamba-1.5-large-398b", dtype)
    ref_p, p = _both(_draw(ssm.mamba_specs(cfg), MAMBA_DRAWS, 4), dtype)
    (ref_x,), (x,) = (v.values() for v in _both({"x": _x(cfg, s, 5)}, dtype))
    tol = TOL[dtype]
    out, cache = ssm.mamba_apply(p, x, cfg)
    want, ref_cache = ref_ssm.mamba_apply(ref_p, ref_x, ref_cfg)
    _close(out, want, tol)
    for name in ("h", "conv"):
        _close(cache[name], ref_cache[name], tol)
    assert cache["h"].dtype == torch.float32 and cache["conv"].dtype == x.dtype
    rng = np.random.default_rng(6)
    carry = {name: rng.standard_normal(tuple(cache[name].shape)).astype(np.float32) for name in ("h", "conv")}
    ref_c, c = _both(carry, dtype)
    c["h"], ref_c["h"] = c["h"].float(), ref_c["h"].astype(jnp.float32)
    before = {k: v.clone() for k, v in c.items()}
    out, cache = ssm.mamba_apply(p, x, cfg, c)
    want, ref_cache = ref_ssm.mamba_apply(ref_p, ref_x, ref_cfg, ref_c)
    _close(out, want, tol)
    for name in ("h", "conv"):
        _close(cache[name], ref_cache[name], tol)
        assert torch.equal(c[name], before[name]), name


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", LENGTHS)
def test_rwkv6_cmix_apply_matches_reference(dtype, s):
    ref_cfg, cfg = _cfgs("rwkv6-7b", dtype)
    ref_p, p = _both(_draw(ssm.rwkv6_cmix_specs(cfg), CMIX_DRAWS, 7), dtype)
    arrays = {"x": _x(cfg, s, 8), "prev": np.random.default_rng(9).standard_normal((2, cfg.d_model)).astype(np.float32)}
    ref_a, a = _both(arrays, dtype)
    for prev, ref_prev in ((None, None), (a["prev"], ref_a["prev"])):
        out, last = ssm.rwkv6_cmix_apply(p, a["x"], cfg, prev)
        want, ref_last = ref_ssm.rwkv6_cmix_apply(ref_p, ref_a["x"], ref_cfg, ref_prev)
        _close(out, want, TOL[dtype])
        assert torch.equal(last, a["x"][:, -1, :])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mixer", ["rwkv6", "mamba"])
def test_prefill_then_decode_equals_one_pass(dtype, mixer):
    """A prefill over 300 tokens, then a decode step a token for 12 more
    (the cache written in place, the reference's decode on its own cache),
    gives one pass's outputs and final state; in f32 the port's two paths
    agree to f32 rounding."""
    arch = "rwkv6-7b" if mixer == "rwkv6" else "jamba-1.5-large-398b"
    ref_cfg, cfg = _cfgs(arch, dtype)
    specs, draws = (ssm.rwkv6_specs, RWKV_DRAWS) if mixer == "rwkv6" else (ssm.mamba_specs, MAMBA_DRAWS)
    ref_p, p = _both(_draw(specs(cfg), draws, 10), dtype)
    (ref_x,), (x,) = (v.values() for v in _both({"x": _x(cfg, 312, 11)}, dtype))
    tol = TOL[dtype]
    if mixer == "rwkv6":
        full, (state, _) = ssm.rwkv6_apply(p, x, cfg)
        out, (s0, last) = ssm.rwkv6_apply(p, x[:, :300], cfg)
        cache = {"state": s0.clone(), "prev_x": last.clone()}
        ref_out, (rs, rl) = ref_ssm.rwkv6_apply(ref_p, ref_x[:, :300], ref_cfg)
        ref_cache = {"state": rs, "prev_x": rl}
        decode, ref_decode = ssm.rwkv6_decode, ref_ssm.rwkv6_decode
        names = ("state", "prev_x")
    else:
        full, final = ssm.mamba_apply(p, x, cfg)
        state = final["h"]
        out, c0 = ssm.mamba_apply(p, x[:, :300], cfg)
        cache = {k: v.clone() for k, v in c0.items()}
        ref_out, ref_cache = ref_ssm.mamba_apply(ref_p, ref_x[:, :300], ref_cfg)
        decode = ssm.mamba_decode
        ref_decode = lambda prm, xt, c, cf: ref_ssm.mamba_apply(prm, xt, cf, c)  # noqa: E731
        names = ("h", "conv")
    views = {name: cache[name] for name in names}
    outs, ref_outs = [out], [ref_out]
    for t in range(300, 312):
        o, returned = decode(p, x[:, t:t + 1], cache, cfg)
        assert returned is cache and all(cache[n] is views[n] for n in names), "decode rebinds its cache"
        outs.append(o)
        o, ref_cache = ref_decode(ref_p, ref_x[:, t:t + 1], ref_cache, ref_cfg)
        ref_outs.append(o)
    stepped = torch.cat(outs, dim=1)
    _close(stepped, jnp.concatenate(ref_outs, axis=1), tol)
    _close(cache[names[0]], ref_cache[names[0]], tol)
    if dtype == "float32":
        _close(stepped, full, tol)
        _close(cache[names[0]], state, tol)


def test_cache_specs_and_widths_match_reference():
    """The cache specs' shapes and dtypes, and Mamba's d_inner and dt_rank
    (512 at jamba's d_model of 8,192)."""
    for arch in ("rwkv6-7b", "jamba-1.5-large-398b"):
        ref_cfg, cfg = ref_configs.get_config(arch), configs.get_config(arch)
        ref_spec = (ref_ssm.rwkv6_cache_spec if cfg.ssm_kind == "rwkv6" else ref_ssm.mamba_cache_spec)(
            ref_cfg, 2, jnp.bfloat16)
        spec = (ssm.rwkv6_cache_spec if cfg.ssm_kind == "rwkv6" else ssm.mamba_cache_spec)(cfg, 2, torch.bfloat16)
        assert set(spec) == set(ref_spec)
        for name, (shape, axes, dt) in spec.items():
            assert (shape, axes, str(dt).split(".")[-1]) == (ref_spec[name][0], ref_spec[name][1],
                                                             jnp.dtype(ref_spec[name][2]).name), name
    cfg = configs.get_config("jamba-1.5-large-398b")
    assert ssm.mamba_d_inner(cfg) == 16_384 and ssm.mamba_specs(cfg)["w_dt"].shape == (512, 16_384)
    assert ssm.RWKV_LORA == ref_ssm.RWKV_LORA and ssm.TIME_CHUNK == ref_ssm.TIME_CHUNK
    for specs_fn, ref_fn in ((ssm.rwkv6_specs, ref_ssm.rwkv6_specs), (ssm.mamba_specs, ref_ssm.mamba_specs),
                             (ssm.rwkv6_cmix_specs, ref_ssm.rwkv6_cmix_specs)):
        for arch in ("rwkv6-7b", "jamba-1.5-large-398b"):
            got, want = specs_fn(configs.get_config(arch)), ref_fn(ref_configs.get_config(arch))
            assert {k: dataclasses.astuple(v) for k, v in got.items()} == \
                {k: dataclasses.astuple(v) for k, v in want.items()}
