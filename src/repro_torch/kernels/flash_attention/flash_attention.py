"""The flash-attention kernel's wrapper and its plain PyTorch version.

``flash_attention_cuda`` launches the hand-written CUDA kernel in
``csrc/flash_attention.cu`` (the counterpart of the reference's
``_flash_kernel``: bf16 prefill on wgmma over TMA-staged tiles, f32 prefill
on the CUDA cores, decode split over the live keys with a kv head's query
rows in one block; see the source's header note) on CUDA tensors;
``flash_attention_plain`` computes the same function with
:func:`repro_torch.kernels.flash_attention.ref.naive_attention`.
Both take q ``(B, H, Sq, D)`` and k/v ``(B, KH, Skv, D)`` (``H`` a multiple of
``KH``: query head ``h`` reads kv head ``h // (H // KH)``), float32 or bfloat16,
any strides with a contiguous last dim, and return ``(B, H, Sq, D)`` in
``q.dtype`` with q's layout (so that the model's ``(B, S, H, D)`` tensors go in
and come out as transposed views, with no copy). A key is live if
``col < kv_len`` and, when causal, ``col <= row`` (top-left aligned); the
softmax accumulates in f32.

Rows with no live key: the kernel writes 0 there (the reference kernel's
``l == 0`` case, where every tile is skipped), the naive oracle the mean of V
over the masked columns, as the reference's oracle does. Both agree wherever a
row has a live key, which every row has once ``kv_len >= 1``; so both refuse a
``kv_len`` below 1.

The kernel reads some tensors 16 bytes at a time: the bf16 prefill reads q, k
and v through TMA, and decode reads k and v with 16-byte copies. Those tensors
need a 16-byte aligned base and strides of a multiple of 16 bytes (every
layout the model hands in has them); the wrapper raises ``ValueError`` on any
other, and copies nothing behind the caller's back.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import naive_attention

SOURCE = Path(__file__).parent / "csrc" / "flash_attention.cu"
#: nvcc optimises the source's many kernel instances on as many threads as the host has cores
#: (70 s on one core to 28 s on 8, an H100 host's Xeon, with the same registers a kernel)
SPLIT_COMPILE = ("--split-compile=0",)
#: head dims the kernel is instantiated for (every dense config's, the tests', and MLA's
#: nope + rope, 192, at which deepseek-v2's prefill runs)
HEAD_DIMS = (16, 32, 64, 128, 192)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: at most this many query rows run the decode instance
DECODE_MAX_ROWS = 16
#: query rows a decode block holds: the G * Sq rows of one kv head, in row groups beyond
DECODE_BLOCK_ROWS = 32
#: a decode split takes at least this many live keys
DECODE_MIN_SPLIT_KEYS = 64
#: a decode launch has at most this many splits (the kernel's merge holds their weights)
DECODE_MAX_SPLITS = 128
#: bytes the kernel's vector and TMA reads need bases and strides to be multiples of
VECTOR_BYTES = 16
_I32_MAX = torch.iinfo(torch.int32).max
_PTR, _INT, _LONG = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# q, k, v, o; their (b, h, s) strides; B, H, KH, Sq, Skv, D, kv_len, causal; scale;
# dtype, decode, n_split, split_keys; scratch, counters; device; stream
ARGTYPES = ((_PTR,) * 4 + (_LONG,) * 12 + (_INT,) * 8 + (ctypes.c_float,) + (_INT,) * 4 + (_PTR,) * 2
            + (_INT,) + (_PTR,))

#: the kernel's two instances: prefill (bf16: wgmma on TMA tiles of 128 query
#: rows; f32: CUDA cores), or decode (at most ``DECODE_MAX_ROWS`` query rows: a
#: kv head's query rows a block, its live keys split over blocks)
INSTANCES = ("flash_attention/prefill", "flash_attention/decode")
#: kernel launches by instance since import (or since a caller last set them to 0)
LAUNCHES = dict.fromkeys(INSTANCES, 0)
#: the same launches by shape, ``(Sq, Skv, causal)``: a caller that serves several
#: shapes on one instance reads each one's count here (set to 0 with ``LAUNCHES``)
SHAPE_LAUNCHES: collections.Counter = collections.Counter()


def instance_of(sq: int) -> str:
    """The instance a launch with ``sq`` query rows runs."""
    return INSTANCES[sq <= DECODE_MAX_ROWS]


def decode_plan(batch: int, n_heads: int, n_kv_heads: int, sq: int, kv_end: int, sms: int) -> tuple[int, int, int]:
    """``(row_groups, n_split, split_keys)`` of a decode launch over the live
    keys ``[0, kv_end)``: a block a (b, kv head, row group of
    ``DECODE_BLOCK_ROWS``) and split, as many splits as fill the ``sms`` SMs
    and at most one per ``DECODE_MIN_SPLIT_KEYS`` keys. Split ``i`` takes
    keys ``[i * split_keys, min((i + 1) * split_keys, kv_end))``: together
    they cover ``[0, kv_end)`` once, and none is empty. At most
    ``DECODE_MAX_SPLITS`` splits."""
    if kv_end < 1:
        raise ValueError(f"a decode launch needs a live key, got kv_end {kv_end}")
    row_groups = -(-(n_heads // n_kv_heads) * sq // DECODE_BLOCK_ROWS)
    want = -(-sms // (batch * n_kv_heads * row_groups))
    n_split = max(1, min(want, -(-kv_end // DECODE_MIN_SPLIT_KEYS), DECODE_MAX_SPLITS))
    split_keys = -(-kv_end // n_split)
    return row_groups, -(-kv_end // split_keys), split_keys


def layout_error(a: torch.Tensor) -> str | None:
    """Why the kernel's 16-byte reads cannot take ``a`` (its base, or the
    stride of a dim of more than one element, not a multiple of
    ``VECTOR_BYTES`` bytes), or None."""
    size = a.element_size()
    if a.data_ptr() % VECTOR_BYTES:
        return f"its base address is not {VECTOR_BYTES}-byte aligned"
    for dim, (n, stride) in enumerate(zip(a.shape[:3], a.stride()[:3])):
        if n > 1 and stride * size % VECTOR_BYTES:
            return f"the stride of dim {dim} is {stride * size} bytes, not a multiple of {VECTOR_BYTES}"
    return None


def check_layouts(**tensors) -> None:
    """Raise ``ValueError`` if a tensor does not take the kernel's 16-byte reads."""
    for name, a in tensors.items():
        why = layout_error(a)
        if why:
            raise ValueError(f"{name} cannot be read 16 bytes at a time: {why}; pass a copy laid out so")


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


#: the decode merge's counters by (device, stream): zero between launches (each
#: launch's last blocks reset theirs), so streams running at once keep apart
_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    have = _COUNTERS.get(key)
    if have is None or have.numel() < n:
        have = _COUNTERS[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return have


@functools.cache
def library() -> _build.Library:
    """Build (at first use) and load the kernel's library, with its C
    signatures; later calls return it without hashing the source again (the
    model launches the kernel once a layer a token)."""
    built = _build.build("flash_attention", (SOURCE,), extra_flags=SPLIT_COMPILE)
    built.lib.flash_attention_launch.argtypes = list(ARGTYPES)
    built.lib.flash_attention_launch.restype = ctypes.c_int
    built.lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    built.lib.flash_attention_error_string.restype = ctypes.c_char_p
    return built


def check_inputs(q, k, v, *, scale=None, kv_len=None) -> tuple[float, int]:
    """Validate a call as the kernel takes it and return ``(scale, kv_len)``
    with their defaults (``1 / sqrt(D)``, ``Skv``) filled in. Raises
    ``ValueError`` on anything the kernel does not take."""
    for name, a in (("q", q), ("k", k), ("v", v)):
        if not isinstance(a, torch.Tensor) or a.ndim != 4:
            raise ValueError(f"{name} must be a 4-d tensor")
        if a.dtype not in _DTYPE_CODE:
            raise ValueError(f"{name} must be float32 or bfloat16, got {a.dtype}")
        if a.shape[-1] > 1 and a.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous last dim, got strides {a.stride()}")
        if max(a.shape) > _I32_MAX:
            raise ValueError(f"{name} has a dim above {_I32_MAX}")
    b, h, sq, d = q.shape
    bk, kh, skv, dk = k.shape
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must share a dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if tuple(v.shape) != tuple(k.shape) or bk != b or dk != d:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if kh < 1 or h % kh:
        raise ValueError(f"q heads {h} not a multiple of kv heads {kh}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported; the kernel takes {HEAD_DIMS}")
    kv_len = skv if kv_len is None else int(kv_len)
    if not 1 <= kv_len <= _I32_MAX:
        raise ValueError(f"kv_len must be >= 1, got {kv_len}")
    return (1.0 / math.sqrt(d) if scale is None else float(scale)), kv_len


def flash_attention_cuda(q, k, v, *, causal: bool = True, scale=None, kv_len=None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors and return the output (``q``'s
    layout and dtype). Raises on anything the kernel does not take, and if
    the launch fails."""
    if not all(isinstance(a, torch.Tensor) and a.is_cuda for a in (q, k, v)):
        raise ValueError("flash_attention_cuda takes CUDA tensors; flash_attention_plain is the CPU version")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k and v lie on different devices: {q.device}, {k.device}, {v.device}")
    scale, kv_len = check_inputs(q, k, v, scale=scale, kv_len=kv_len)
    b, h, sq, d = q.shape
    _, kh, skv, _ = k.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    decode = instance_of(sq) == INSTANCES[1]
    if decode:
        check_layouts(k=k, v=v)
    elif q.dtype == torch.bfloat16:
        check_layouts(q=q, k=k, v=v)
    built = library()
    dev = q.device if q.device.index is not None else torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_split, split_keys, scratch, counters = 1, 1, None, None
    if decode:
        kv_end = min(kv_len, skv, sq) if causal else min(kv_len, skv)
        row_groups, n_split, split_keys = decode_plan(b, h, kh, sq, kv_end, _sm_count(dev.index))
        if n_split > 1:
            blocks = b * kh * row_groups
            scratch = torch.empty(blocks * n_split * DECODE_BLOCK_ROWS * (d + 2), dtype=torch.float32, device=dev)
            counters = _counters(dev, stream, blocks)
    strides = [s for a in (q, k, v, out) for s in a.stride()[:3]]
    err = built.lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *strides, b, h, kh, sq, skv, d, kv_len,
        int(bool(causal)), scale, _DTYPE_CODE[q.dtype], int(decode), n_split, split_keys,
        None if scratch is None else scratch.data_ptr(), None if counters is None else counters.data_ptr(),
        dev.index, stream,
    )
    if err:
        msg = built.lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err} ({msg})")
    LAUNCHES[instance_of(sq)] += 1
    SHAPE_LAUNCHES[(sq, skv, bool(causal))] += 1
    return out


def flash_attention_plain(q, k, v, *, causal: bool = True, scale=None, kv_len=None) -> torch.Tensor:
    """The kernel's function with the naive oracle, on the tensors' own
    device: the CPU path of ``ops.flash_attention``, and the yardstick the
    kernel is held to on the card."""
    scale, kv_len = check_inputs(q, k, v, scale=scale, kv_len=kv_len)
    return naive_attention(q, k, v, causal=causal, scale=scale, kv_len=kv_len)
