"""The flash-attention kernel's wrapper and its plain PyTorch version.

``flash_attention_cuda`` launches the hand-written CUDA kernel in
``csrc/flash_attention.cu`` (the counterpart of the reference's
``_flash_kernel``) on CUDA tensors; ``flash_attention_plain`` computes the same
function with :func:`repro_torch.kernels.flash_attention.ref.naive_attention`.
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
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import naive_attention

SOURCE = Path(__file__).parent / "csrc" / "flash_attention.cu"
#: head dims the kernel is instantiated for (every dense config's, and the tests')
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: at most this many query rows run in decode mode (one row a block, keys over the block)
DECODE_MAX_ROWS = 16
_I32_MAX = torch.iinfo(torch.int32).max
_PTR, _INT, _LONG = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# q, k, v, o; their (b, h, s) strides; B, H, KH, Sq, Skv, D, kv_len, causal; scale;
# dtype, decode, device; stream
ARGTYPES = (_PTR,) * 4 + (_LONG,) * 12 + (_INT,) * 8 + (ctypes.c_float,) + (_INT,) * 3 + (_PTR,)

#: the kernel's two instances: 128 / P query rows a block (prefill), or one
#: row a block with its keys spread over the block (decode: at most
#: ``DECODE_MAX_ROWS`` query rows)
INSTANCES = ("flash_attention/prefill", "flash_attention/decode")
#: kernel launches by instance since import (or since a caller last set them to 0)
LAUNCHES = dict.fromkeys(INSTANCES, 0)


def instance_of(sq: int) -> str:
    """The instance a launch with ``sq`` query rows runs."""
    return INSTANCES[sq <= DECODE_MAX_ROWS]


@functools.cache
def library() -> _build.Library:
    """Build (at first use) and load the kernel's library, with its C
    signatures; later calls return it without hashing the source again (the
    model launches the kernel once a layer a token)."""
    built = _build.build("flash_attention", (SOURCE,))
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
    built = library()
    dev = q.device
    strides = [s for a in (q, k, v, out) for s in a.stride()[:3]]
    err = built.lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *strides, b, h, kh, sq, skv, d, kv_len,
        int(bool(causal)), scale, _DTYPE_CODE[q.dtype], int(instance_of(sq) == INSTANCES[1]),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        msg = built.lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err} ({msg})")
    LAUNCHES[instance_of(sq)] += 1
    return out


def flash_attention_plain(q, k, v, *, causal: bool = True, scale=None, kv_len=None) -> torch.Tensor:
    """The kernel's function with the naive oracle, on the tensors' own
    device: the CPU path of ``ops.flash_attention``, and the yardstick the
    kernel is held to on the card."""
    scale, kv_len = check_inputs(q, k, v, scale=scale, kv_len=kv_len)
    return naive_attention(q, k, v, causal=causal, scale=scale, kv_len=kv_len)
