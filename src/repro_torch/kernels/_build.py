"""Build the port's CUDA sources into shared libraries and load them.

``nvcc`` compiles a kernel's ``csrc/`` sources for ``sm_90a`` into a shared
library with a plain C interface, at first use, into ``build/kernels/`` at the
root of the checkout. The library's name carries a hash of the sources, the
headers (``*.cuh``) beside them and the flags, so an edited source or header
builds anew and an unchanged one loads the library already built. ``ctypes`` loads it; the caller declares each function's
``argtypes``. The compiler's ``-Xptxas -v`` report (registers, shared memory,
spills) is kept beside the library; ``Library.ptxas`` holds its ``ptxas info``
lines and each function's stack and spill line.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"


@dataclasses.dataclass(frozen=True)
class Library:
    """A loaded kernel library and what ptxas said when it was built."""

    lib: ctypes.CDLL
    path: Path
    ptxas: tuple[str, ...]


_LOADED: dict[Path, Library] = {}
_LOCK = threading.Lock()
_BUILDING: dict[Path, threading.Lock] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(found, os.X_OK):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return found


def build(name: str, sources, extra_flags: tuple[str, ...] = ()) -> Library:
    """Compile ``sources`` (unless a library of the same hash exists) and load
    it, with ``extra_flags`` after ``NVCC_FLAGS``. Safe to call from several
    threads at once, so that several libraries build in parallel; a second
    call for a library being built waits for it."""
    sources = [Path(s) for s in sources]
    flags = (*NVCC_FLAGS, *extra_flags)
    headers = sorted({h for src in sources for h in src.parent.glob("*.cuh")})
    digest = hashlib.sha256("\0".join(flags).encode())
    for src in [*sources, *headers]:
        digest.update(src.read_bytes())
    path = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"
    with _LOCK:
        lock = _BUILDING.setdefault(path, threading.Lock())
    with lock:
        return _build_locked(name, sources, flags, path)


def _build_locked(name: str, sources: list[Path], flags: tuple[str, ...], path: Path) -> Library:
    if path in _LOADED:
        return _LOADED[path]
    log = path.with_suffix(".log")
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.run(
            [_nvcc(), *flags, "-o", str(tmp), *map(str, sources)],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {name}:\n{proc.stdout}{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, path)
    ptxas = tuple(
        line.strip() for line in log.read_text().splitlines()
        if line.startswith("ptxas info") or "bytes spill stores" in line
    )
    library = Library(lib=ctypes.CDLL(str(path)), path=path, ptxas=ptxas)
    _LOADED[path] = library
    return library
