"""The port imports nothing of JAX and nothing of the reference package.

Every ``.py`` under ``src/repro_torch/`` and ``chip_smoke.py`` is parsed with
``ast``; an ``import jax``/``from jax...`` or ``import repro``/``from repro...``
anywhere in it (a function body included) fails the test. ``repro_torch`` is
the port itself and passes.
"""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "repro")


def forbidden_imports(source: str) -> list[str]:
    """Names of the forbidden top-level packages that ``source`` imports."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            modules = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            modules = [node.module or ""]
        else:
            continue
        found += [m for m in modules if m.split(".")[0] in FORBIDDEN]
    return found


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert "chip_smoke.py" in names
    assert "src/repro_torch/kernels/cache_sim/ops.py" in names
    assert "src/repro_torch/workloads/generators.py" in names
    assert len(names) >= 17


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_imports_no_jax_and_no_repro(path):
    assert forbidden_imports(path.read_text()) == []


@pytest.mark.parametrize(
    "source,found",
    [
        ("import jax", ["jax"]),
        ("import jax.numpy as jnp", ["jax.numpy"]),
        ("from jax import lax", ["jax"]),
        ("from jax.experimental import pallas", ["jax.experimental"]),
        ("import repro", ["repro"]),
        ("from repro.core import zipf", ["repro.core"]),
        ("def f():\n    import repro.core.registry\n", ["repro.core.registry"]),
        ("import numpy, jax", ["jax"]),
        ("import repro_torch", []),
        ("from repro_torch.core import zipf", []),
        ("from . import zipf", []),
        ("import jaxlib_like_name_but_not_jax", []),
    ],
)
def test_checker_flags_only_jax_and_repro(source, found):
    assert forbidden_imports(source) == found
