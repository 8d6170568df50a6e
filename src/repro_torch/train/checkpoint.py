"""Fault-tolerant checkpointing in the reference's on-disk format: the port of
the reference's ``train/checkpoint.py``.

Layout per step:
    <dir>/step_<n>.tmp/      — written first (crash-safe)
    <dir>/step_<n>/          — atomic rename on completion
        manifest.json        — step, meta, and per leaf its file, shape, dtype
                               and the crc32 of the array's bytes
        leaf_<i>.npy         — one file per leaf, numbered in the sorted order
                               of the leaves' keys (path parts joined by "\\x1f")

A tree is nested dicts (keys sorted, as ``jax.tree_util`` flattens them),
lists and tuples of tensors, numpy arrays or scalars: a checkpoint of the same
tree written by either package reads in the other. bf16 (and the float8
types) are stored as a byte view (``uint16``, ``uint8``) with the dtype's
name in the manifest, through ``torch``'s ``view`` (numpy has no bf16).

Properties:
  * atomicity: a crash mid-save leaves only a .tmp dir, which restore ignores;
  * integrity: crc32 per leaf — corrupt files are detected and the previous
    valid checkpoint is used;
  * elasticity: ``restore(..., device=)`` puts the leaves on any device (the
    card's state restores onto the CPU); placement on a mesh waits for the
    port's sharding module;
  * async save: the snapshot to the host happens synchronously, the disk
    write on a background thread.
"""
from __future__ import annotations

import json
import shutil
import threading
import time
import zlib
from pathlib import Path

import numpy as np
import torch

_SEP = "\x1f"
_BYTE_VIEW = {"bfloat16": np.uint16, "float8_e4m3fn": np.uint8, "float8_e5m2": np.uint8}
#: the dtypes numpy lacks: the torch dtype, and the torch integer type its bytes are read through
_TORCH_VIEW = {"bfloat16": (torch.bfloat16, torch.int16), "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8),
               "float8_e5m2": (torch.float8_e5m2, torch.uint8)}


def _flatten(tree, path: tuple = ()) -> dict:
    """``{key: leaf}``, a key the leaf's path parts joined by ``_SEP``, dict
    keys in sorted order (as ``jax.tree_util`` flattens)."""
    if isinstance(tree, dict):
        out = {}
        for key in sorted(tree):
            out.update(_flatten(tree[key], path + (str(key),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, value in enumerate(tree):
            out.update(_flatten(value, path + (str(i),)))
        return out
    if tree is None:
        return {}
    return {_SEP.join(path): tree}


def _unflatten(like, leaves: dict, path: tuple = ()):
    """``like``'s structure with ``leaves`` (by key) in it."""
    if isinstance(like, dict):
        return {key: _unflatten(value, leaves, path + (str(key),)) for key, value in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(value, leaves, path + (str(i),)) for i, value in enumerate(like))
    if like is None:
        return None
    return leaves[_SEP.join(path)]


def _host(leaf):
    """A copy of ``leaf`` on the host: a tensor stays a tensor (bf16 too)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def _stored(leaf) -> tuple[np.ndarray, str]:
    """(the array written to disk, the dtype's name in the manifest)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = str(t.dtype).removeprefix("torch.")
        if name in _TORCH_VIEW:
            return t.view(_TORCH_VIEW[name][1]).numpy().view(_BYTE_VIEW[name]), name
        return t.numpy(), name
    arr = np.asarray(leaf)
    name = str(arr.dtype)
    return (arr.view(_BYTE_VIEW[name]) if name in _BYTE_VIEW else arr), name


def _crc32(arr: np.ndarray) -> int:
    """crc32 of the array's bytes in C order (``zlib.crc32(arr.tobytes())``, without the copy)."""
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def _tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype in _TORCH_VIEW:
        torch_dtype, bits = _TORCH_VIEW[dtype]
        t = torch.from_numpy(arr.view(np.dtype(str(bits).removeprefix("torch.")))).view(torch_dtype)
    else:
        t = torch.from_numpy(arr)
    return t if device is None else t.to(device)


def save(ckpt_dir: str | Path, step: int, tree, *, meta: dict | None = None, keep: int = 3) -> Path:
    """Synchronous atomic save. Returns the final directory."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f"step_{step}.tmp"
    final = ckpt_dir / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    manifest = {"step": step, "meta": meta or {}, "leaves": {}}
    for i, (key, leaf) in enumerate(sorted(_flatten(tree).items())):
        arr, dtype_name = _stored(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(tmp / fname, arr)
        manifest["leaves"][key] = {
            "file": fname,
            "shape": list(arr.shape),
            "dtype": dtype_name,
            "crc32": _crc32(arr),
        }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    _gc(ckpt_dir, keep)
    return final


class AsyncSaver:
    """Double-buffered async save: snapshot now, write on a worker thread.
    ``snapshot_s`` and ``write_s`` are the last save's seconds of each."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self.last_error: Exception | None = None
        self.snapshot_s = self.write_s = 0.0

    def save(self, ckpt_dir, step, tree, *, meta=None, keep: int = 3):
        self.wait()
        t0 = time.perf_counter()
        host_tree = _unflatten(tree, {k: _host(v) for k, v in _flatten(tree).items()})
        self.snapshot_s = time.perf_counter() - t0

        def work():
            t1 = time.perf_counter()
            try:
                save(ckpt_dir, step, host_tree, meta=meta, keep=keep)
            except Exception as e:  # pragma: no cover
                self.last_error = e
            self.write_s = time.perf_counter() - t1

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            raise self.last_error


def available_steps(ckpt_dir: str | Path) -> list[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    out = []
    for p in ckpt_dir.iterdir():
        if p.is_dir() and p.name.startswith("step_") and not p.name.endswith(".tmp"):
            if (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
    return sorted(out)


def _load_verified(step_dir: Path) -> tuple[dict, dict] | None:
    """(manifest, {key: array}) with every leaf's crc32 checked, or None
    where a file is missing, unreadable or corrupt."""
    try:
        manifest = json.loads((step_dir / "manifest.json").read_text())
        arrays = {}
        for key, ent in manifest["leaves"].items():
            arr = np.load(step_dir / ent["file"])
            if _crc32(arr) != ent["crc32"]:
                return None
            arrays[key] = arr
        return manifest, arrays
    except Exception:
        return None


def _verify(step_dir: Path) -> bool:
    return _load_verified(step_dir) is not None


def restore(ckpt_dir: str | Path, like, *, step: int | None = None, device=None) -> tuple[int, object]:
    """Restore the newest *valid* checkpoint into the structure of ``like``
    (its leaves give only the keys: each leaf comes back in the checkpoint's
    dtype) as tensors on ``device`` (the CPU where None): a checkpoint written
    from one device resumes on another."""
    steps = available_steps(ckpt_dir)
    if step is not None:
        steps = [s for s in steps if s == step]
    for s in sorted(steps, reverse=True):
        loaded = _load_verified(Path(ckpt_dir) / f"step_{s}")
        if loaded is None:
            continue  # corrupt/partial — fall back to an older checkpoint
        manifest, arrays = loaded
        restored = {}
        for key in _flatten(like):
            ent = manifest["leaves"].get(key)
            if ent is None:
                raise KeyError(f"checkpoint at step {s} missing leaf {key!r}")
            restored[key] = _tensor(arrays[key], ent["dtype"], device)
        return s, _unflatten(like, restored)
    raise FileNotFoundError(f"no valid checkpoint under {ckpt_dir}")


def _gc(ckpt_dir: Path, keep: int):
    steps = available_steps(ckpt_dir)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(ckpt_dir / f"step_{s}", ignore_errors=True)
