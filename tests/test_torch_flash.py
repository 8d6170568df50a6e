"""The port's flash attention (plain PyTorch path) against the reference kernel.

On the CPU ``ops.flash_attention`` runs the plain version
(``ref.naive_attention``). It is held to the reference's Pallas kernel in
interpret mode and to the reference's oracle on the same inputs, made with
numpy from a seed: over the ``SWEEP`` rows of tests/test_kernels_flash.py,
``kv_len`` masking with garbage past it, block-shape invariance and the
causality property. Tolerances are the reference test's: 2e-5 in float32
(summation order), 2e-2 in bfloat16 (the output's rounding). The CUDA kernel
itself is tested on the card in tests/test_torch_cuda.py.
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as ref_flash
from repro.kernels.flash_attention.ref import naive_attention as ref_naive
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import naive_attention

SWEEP = [
    # (B, H, KH, Sq, Skv, D, causal, dtype)
    (1, 2, 2, 128, 128, 64, True, "float32"),
    (2, 4, 2, 128, 128, 64, True, "float32"),
    (1, 8, 2, 256, 256, 128, True, "bfloat16"),
    (1, 2, 1, 96, 160, 64, True, "float32"),
    (1, 2, 2, 128, 384, 64, False, "float32"),
    (2, 3, 3, 64, 64, 32, True, "bfloat16"),
    (1, 2, 2, 1, 512, 64, False, "float32"),
    (1, 16, 8, 1, 300, 128, False, "bfloat16"),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(shape_q, shape_kv, dtype, seed):
    """The same q, k, v for both packages: f32 normals from numpy, rounded to
    ``dtype`` by each package (both round to nearest even). Each package gets
    its own copy of the arrays: no buffer is shared between the two."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in (shape_q, shape_kv, shape_kv)]
    port = [torch.tensor(a).to(_TORCH[dtype]) for a in arrays]
    ref = [jnp.array(a, copy=True).astype(dtype) for a in arrays]
    return port, ref


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("b,h,kh,sq,skv,d,causal,dtype", SWEEP)
def test_plain_matches_reference_kernel_and_oracle(b, h, kh, sq, skv, d, causal, dtype):
    (q, k, v), (jq, jk, jv) = _inputs((b, h, sq, d), (b, kh, skv, d), dtype, seed=sq * 1000 + skv)
    got = ops.flash_attention(q, k, v, causal=causal)
    assert got.dtype == q.dtype and tuple(got.shape) == (b, h, sq, d)
    kernel = ref_flash(jq, jk, jv, causal=causal, interpret=True)
    oracle = ref_naive(jq, jk, jv, causal=causal)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(kernel), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=tol, rtol=tol)


#: MLA's head dim (deepseek-v2: nope 128 + rope 64, V padded to it): a causal
#: prefill over two query tiles, a short causal prompt (the decode instance on
#: the card), a decode row against a longer cache with kv_len
MLA_CASES = [
    (1, 4, 4, 256, 256, 192, True, "bfloat16", None),
    (1, 4, 4, 130, 130, 192, True, "float32", None),
    (1, 8, 8, 12, 12, 192, True, "bfloat16", None),
    (1, 2, 2, 1, 200, 192, False, "float32", 150),
]


@pytest.mark.parametrize("b,h,kh,sq,skv,d,causal,dtype,kv_len", MLA_CASES)
def test_plain_matches_reference_kernel_at_mla_head_dim(b, h, kh, sq, skv, d, causal, dtype, kv_len):
    """D = 192 is in HEAD_DIMS, and the plain version there equals the
    reference's Pallas kernel (interpret mode) within the SWEEP tolerances."""
    assert d in fa.HEAD_DIMS
    (q, k, v), (jq, jk, jv) = _inputs((b, h, sq, d), (b, kh, skv, d), dtype, seed=sq * 7 + skv)
    got = ops.flash_attention(q, k, v, causal=causal, kv_len=kv_len)
    assert got.dtype == q.dtype and tuple(got.shape) == (b, h, sq, d)
    kernel = ref_flash(jq, jk, jv, causal=causal, kv_len=kv_len, interpret=True)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(kernel), atol=tol, rtol=tol)


#: whisper's and llava's shapes, heads cut to 2 (whisper) and 4 over 1 (llava's group of 4; the
#: Pallas interpreter runs a grid cell at a time): whisper's non-causal encoder over 1,500 frames
#: (1,500 = 23 x 64 + 28: the last key tile is partial) and a 300-frame one; cross-attention, not
#: causal, Sq != Skv over the 1,500-frame source from 4 rows (the decode instance on the card) and
#: from 128; the cross decode over the whole source; the decoder's causal prompt and its decode
#: against the self cache of 448; llava's causal prefill at D = 128 and its decode with kv_len
WHISPER_LLAVA_CASES = [
    (1, 2, 2, 1_500, 1_500, 64, False, "bfloat16", None),
    (1, 2, 2, 300, 300, 64, False, "float32", None),
    (1, 2, 2, 4, 1_500, 64, False, "float32", None),
    (1, 2, 2, 4, 1_500, 64, False, "bfloat16", None),
    (1, 2, 2, 128, 1_500, 64, False, "float32", None),
    (1, 2, 2, 128, 1_500, 64, False, "bfloat16", None),
    (1, 2, 2, 1, 1_500, 64, False, "float32", 1_500),
    (1, 2, 2, 1, 1_500, 64, False, "bfloat16", None),
    (1, 2, 2, 4, 4, 64, True, "bfloat16", None),
    (1, 2, 2, 1, 448, 64, False, "float32", 144),
    (1, 4, 1, 256, 256, 128, True, "bfloat16", None),
    (1, 4, 1, 1, 520, 128, False, "bfloat16", 517),
]


@pytest.mark.parametrize("b,h,kh,sq,skv,d,causal,dtype,kv_len", WHISPER_LLAVA_CASES)
def test_plain_matches_reference_kernel_at_whisper_and_llava_shapes(b, h, kh, sq, skv, d, causal, dtype, kv_len):
    """The plain version equals the reference's Pallas kernel (interpret
    mode) and its oracle within the SWEEP tolerances at the served models'
    shapes: non-causal rows over a source whose last key tile is partial,
    Sq != Skv, and kv_len below the cache."""
    (q, k, v), (jq, jk, jv) = _inputs((b, h, sq, d), (b, kh, skv, d), dtype, seed=sq * 13 + skv)
    got = ops.flash_attention(q, k, v, causal=causal, kv_len=kv_len)
    assert got.dtype == q.dtype and tuple(got.shape) == (b, h, sq, d)
    kernel = ref_flash(jq, jk, jv, causal=causal, kv_len=kv_len, interpret=True)
    oracle = ref_naive(jq, jk, jv, causal=causal, kv_len=kv_len)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(kernel), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=tol, rtol=tol)
    if not causal and sq > 1:
        # the same rows read causally are another function: the case's mask is what is held
        assert np.abs(_np(ops.flash_attention(q, k, v, causal=True, kv_len=kv_len)) - _np(got)).max() > 10 * tol


def _float64_attention(q, k, v, causal, kv_len=None):
    """The function in float64 from the same inputs: a yardstick for the
    plain path's own f32 rounding."""
    q, k, v = (x.double() for x in (q, k, v))
    group = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(group, dim=1), v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / q.shape[-1] ** 0.5
    col = torch.arange(k.shape[2])
    live = col[None, :] < (k.shape[2] if kv_len is None else kv_len)
    if causal:
        live = live & (col[None, :] <= torch.arange(q.shape[2])[:, None])
    return torch.einsum("bhqk,bhkd->bhqd", s.masked_fill(~live, float("-inf")).softmax(-1), v).numpy()


@pytest.mark.parametrize("b,h,kh,sq,skv,d,causal", [row[:7] for row in SWEEP if row[7] == "float32"])
def test_plain_f32_is_within_rounding_of_float64(b, h, kh, sq, skv, d, causal):
    """The plain path, the yardstick the card's kernel is held to, stays
    within f32 rounding of the function computed in float64: 4e-6, where it
    measures at most 9.3e-7 here (a fifth of the reference test's 2e-5)."""
    (q, k, v), _ = _inputs((b, h, sq, d), (b, kh, skv, d), "float32", seed=sq * 1000 + skv)
    got = _np(ops.flash_attention(q, k, v, causal=causal))
    np.testing.assert_allclose(got, _float64_attention(q, k, v, causal), atol=4e-6, rtol=4e-6)


def test_first_sweep_row_with_shared_buffers_stays_within_rounding():
    """Regression for a failure seen in 2 of 7 runs under ``pytest -n 3``:
    the first SWEEP row (seed 128,128), its inputs shared between numpy,
    torch and JAX as these tests first made them, gave port outputs off by
    up to 6e-5 at row 1. Here the port's output must stay within f32 rounding
    of the float64 function on every call, before and after the reference
    kernel reads the same buffers, and equal its first call bit for bit."""
    rng = np.random.default_rng(128 * 1000 + 128)
    arrays = [rng.standard_normal((1, 2, 128, 64)).astype(np.float32) for _ in range(3)]
    port = [torch.from_numpy(a) for a in arrays]
    ref = [jnp.asarray(a) for a in arrays]
    truth = _float64_attention(*port, causal=True)
    first = _np(ops.flash_attention(*port, causal=True))
    for _ in range(8):
        got = _np(ops.flash_attention(*port, causal=True))
        np.testing.assert_allclose(got, truth, atol=4e-6, rtol=4e-6)
        np.testing.assert_array_equal(got, first)
        kernel = np.asarray(ref_flash(*ref, causal=True, interpret=True))
        np.testing.assert_allclose(kernel, truth, atol=2e-5, rtol=2e-5)


def test_kv_len_masking_ignores_garbage():
    """Padded KV cache: only the first kv_len entries participate."""
    (q, k, v), (jq, jk, jv) = _inputs((1, 4, 1, 64), (1, 4, 256, 64), "float32", seed=0)
    out = ops.flash_attention(q, k, v, causal=False, kv_len=100)
    ref = ref_flash(jq, jk, jv, causal=False, kv_len=100, interpret=True)
    np.testing.assert_allclose(_np(out), _np(ref), atol=2e-5, rtol=2e-5)
    short = naive_attention(q, k[:, :, :100], v[:, :, :100], causal=False)
    np.testing.assert_allclose(_np(out), _np(short), atol=2e-5, rtol=2e-5)
    k2 = k.clone()
    k2[:, :, 100:] = 1e6
    np.testing.assert_allclose(_np(ops.flash_attention(q, k2, v, causal=False, kv_len=100)), _np(out), atol=1e-6)


def test_block_shape_invariance():
    """The output does not depend on block_q/block_k."""
    (q, k, v), _ = _inputs((1, 2, 256, 64), (1, 2, 256, 64), "float32", seed=1)
    outs = [_np(ops.flash_attention(q, k, v, causal=True, block_q=bq, block_k=bk))
            for bq, bk in [(64, 64), (128, 128), (256, 128), (64, 256)]]
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], atol=2e-5, rtol=2e-5)


def test_causality_property():
    """Perturbing future keys/values does not change past outputs."""
    (q, k, v), _ = _inputs((1, 2, 128, 64), (1, 2, 128, 64), "float32", seed=2)
    base = _np(ops.flash_attention(q, k, v, causal=True))
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 64:] += 3.0
    v2[:, :, 64:] -= 2.0
    pert = _np(ops.flash_attention(q, k2, v2, causal=True))
    np.testing.assert_allclose(pert[:, :, :64], base[:, :, :64], atol=1e-6)
    assert np.abs(pert[:, :, 64:] - base[:, :, 64:]).max() > 1e-3


@pytest.mark.parametrize("causal,kv_len", [(True, None), (True, 150), (False, 77)])
def test_rows_in_chunks_equal_one_pass(causal, kv_len):
    """The oracle over query rows in chunks, each at its ``q_offset`` (how
    chip_smoke bounds the plain version's memory), gives the one-pass result."""
    (q, k, v), _ = _inputs((1, 3, 200, 32), (1, 1, 200, 32), "float32", seed=3)
    whole = fa.flash_attention_plain(q, k, v, causal=causal, kv_len=kv_len)
    chunked = torch.cat([naive_attention(q[:, :, r0:r0 + 64], k, v, causal=causal, kv_len=kv_len, q_offset=r0)
                         for r0 in range(0, 200, 64)], dim=2)
    np.testing.assert_allclose(_np(chunked), _np(whole), atol=1e-6)


def test_transposed_views_keep_their_layout():
    """The model's (B, S, H, D) tensors go in as transposed views; the output
    comes back in q's layout."""
    (q, k, v), _ = _inputs((1, 40, 6, 16), (1, 40, 2, 16), "float32", seed=4)
    got = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True)
    want = naive_attention(q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                           v.transpose(1, 2).contiguous(), causal=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6)


@pytest.mark.parametrize("change,match", [
    (dict(d=48), "head dim 48"),
    (dict(kv_len=0), "kv_len must be >= 1"),
    (dict(kh=3), "not a multiple"),
    (dict(k_dtype=torch.bfloat16), "share a dtype"),
    (dict(dtype=torch.float16), "float32 or bfloat16"),
    (dict(block_q=0), "block_q"),
])
def test_refuses_what_the_kernel_does_not_take(change, match):
    d, kh = change.get("d", 64), change.get("kh", 2)
    dtype = change.get("dtype", torch.float32)
    q = torch.zeros(1, 4, 8, d, dtype=dtype)
    k = torch.zeros(1, kh, 8, d, dtype=change.get("k_dtype", dtype))
    v = torch.zeros(1, kh, 8, d, dtype=change.get("k_dtype", dtype))
    with pytest.raises(ValueError, match=match):
        ops.flash_attention(q, k, v, kv_len=change.get("kv_len"), block_q=change.get("block_q", 128))


def test_cuda_wrapper_refuses_cpu_tensors_and_counts_nothing():
    """The wrapper launches on CUDA tensors or raises: no fallback, and the
    CPU path launches nothing."""
    q = torch.zeros(1, 2, 4, 64)
    before = dict(fa.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_cuda(q, q, q)
    ops.flash_attention(q, q, q)
    assert fa.LAUNCHES == before


def test_launch_signature_matches_the_c_entry():
    """The ctypes argument types, one for one, are the C entry's parameters
    (4 pointers, 12 int64 strides, 8 ints, the float scale, 4 ints, the
    decode scratch and counters, the device, the stream): a mismatch would cut
    a pointer or shift every argument."""
    src = fa.SOURCE.read_text()
    decl = src[src.index('extern "C" int flash_attention_launch('):]
    params = decl[decl.index("(") + 1:decl.index(")")].split(",")
    c_types = {"const void*": fa._PTR, "void*": fa._PTR, "long long": fa._LONG, "int": fa._INT,
               "float": ctypes.c_float}
    assert [c_types[" ".join(p.split()[:-1])] for p in params] == list(fa.ARGTYPES)


# (B, H, KH, Sq, kv_end, SMs): the served decode (kv_len 1, 2,049, 2,056, the
# 16,384-token request's), GQA group 8 with 16 rows (row groups), more kv heads
# than SMs, a kv_len below one split's keys, and a long cache on few blocks
PLAN_CASES = [
    (1, 15, 5, 1, 1, 132), (1, 15, 5, 1, 2_049, 132), (1, 15, 5, 1, 2_056, 132), (1, 15, 5, 1, 16_388, 132),
    (2, 16, 2, 16, 650, 132), (8, 32, 32, 1, 300, 132), (1, 15, 5, 1, 40, 132), (1, 1, 1, 1, 20_000, 132),
]


@pytest.mark.parametrize("b,h,kh,sq,kv_end,sms", PLAN_CASES)
def test_decode_plan_covers_the_live_keys_once(b, h, kh, sq, kv_end, sms):
    """The decode splits cover [0, kv_end) once each and none is empty; there
    are as many as fill the SMs, at most one per DECODE_MIN_SPLIT_KEYS keys
    and at most DECODE_MAX_SPLITS; a block holds at most DECODE_BLOCK_ROWS
    query rows of one kv head."""
    row_groups, n_split, split_keys = fa.decode_plan(b, h, kh, sq, kv_end, sms)
    starts = [i * split_keys for i in range(n_split)]
    ends = [min(s0 + split_keys, kv_end) for s0 in starts]
    assert starts[0] == 0 and ends[-1] == kv_end and all(e > s0 for s0, e in zip(starts, ends))
    assert all(e == s1 for e, s1 in zip(ends, starts[1:]))
    assert row_groups * fa.DECODE_BLOCK_ROWS >= (h // kh) * sq > (row_groups - 1) * fa.DECODE_BLOCK_ROWS
    want = -(-sms // (b * kh * row_groups))
    assert n_split == min(want, -(-kv_end // fa.DECODE_MIN_SPLIT_KEYS), fa.DECODE_MAX_SPLITS)


def test_decode_plan_at_the_served_shape():
    """smollm-360m's decode (1, 15, 5) against a cache of 2,056 on 132 SMs: 27
    splits of 77 keys, 5 x 27 = 135 blocks (more than B * H = 15), each block
    the 3 query heads of one kv head; kv_len 1 runs one block a kv head."""
    assert fa.decode_plan(1, 15, 5, 1, 2_056, 132) == (1, 27, 77)
    assert fa.decode_plan(1, 15, 5, 1, 1, 132) == (1, 1, 1)
    with pytest.raises(ValueError, match="live key"):
        fa.decode_plan(1, 15, 5, 1, 0, 132)


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("make,why", [
    # the model's (B, S, H, D) projections and its (B, S, KH, D) cache, as transposed views
    (lambda: _bf16(1, 2_048, 15, 64).transpose(1, 2), None),
    (lambda: _bf16(1, 2_056, 5, 64).transpose(1, 2), None),
    (lambda: _bf16(1, 8, 24, 128).transpose(1, 2), None),
    (lambda: _bf16(2, 3, 64, 32), None),
    # a dim of one element may have any stride
    (lambda: _bf16(1, 1, 5, 16).as_strided((1, 1, 5, 16), (7, 3, 16, 1)), None),
    (lambda: _bf16(4 * 64 * 64 + 1)[1:].view(1, 4, 64, 64), "base address"),
    (lambda: _bf16(1, 4, 64, 68)[..., :64], "stride of dim 2 is 136 bytes"),
    (lambda: torch.zeros(1, 2, 8, 66)[..., :64], "stride of dim 2 is 264 bytes"),
])
def test_layout_check_takes_the_model_layouts_and_refuses_misaligned_ones(make, why):
    """The 16-byte reads' layout check (TMA for the bf16 prefill, vector
    copies for decode), on CPU tensors: the model's views pass; a misaligned
    base or a row stride that is not a multiple of 16 bytes raises."""
    a = make()
    assert (fa.layout_error(a) is None) == (why is None)
    if why is None:
        fa.check_layouts(q=a)
    else:
        assert why in fa.layout_error(a)
        with pytest.raises(ValueError, match="q cannot be read 16 bytes at a time"):
            fa.check_layouts(q=a)


def _attention_with_p(q, k, v, p_as):
    """Causal attention with f32 scores and softmax, P V with p as the kernel
    designs could feed the tensor cores: ``"bf16"`` (one bf16 rounding of p)
    or ``"hi_lo"`` (p as bf16(p) + bf16(p - bf16(p)), two products summed in
    f32); the output rounded to q's dtype once."""
    b, h, sq, d = q.shape
    group = h // k.shape[1]
    kq, vq = (x.repeat_interleave(group, dim=1).float() for x in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kq) / d ** 0.5
    s = s.masked_fill(torch.ones(sq, k.shape[2], dtype=torch.bool).triu(1), -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    hi = p.to(torch.bfloat16).float()
    pv = hi @ vq if p_as == "bf16" else hi @ vq + (p - hi).to(torch.bfloat16).float() @ vq
    return (pv / p.sum(dim=-1, keepdim=True)).to(q.dtype)


def test_bf16_tolerance_tells_one_rounding_of_p_from_hi_lo():
    """At the served widths (1, 15, 5) with 520 causal rows in bf16, the
    kernel's tolerance against the plain version (p in f32; atol 1e-4, rtol
    2**-7: one rounding of the output) rejects p rounded once to bf16 before
    P V (12.99 here) and takes the kernel's design, p as a bf16 pair (0.90)."""
    (q, k, v), _ = _inputs((1, 15, 520, 64), (1, 5, 520, 64), "bfloat16", seed=0)
    want = naive_attention(q, k, v, causal=True).float()

    def ratio(got):
        return float(((got.float() - want).abs() / (1e-4 + 2**-7 * want.abs())).max())

    assert ratio(_attention_with_p(q, k, v, "bf16")) > 1
    assert ratio(_attention_with_p(q, k, v, "hi_lo")) <= 1
