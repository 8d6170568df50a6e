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
    # the serving slice: the flash kernel's wrapper and entry point, the model,
    # the engine and its launcher
    for entry in ("kernels/flash_attention/ops.py", "kernels/flash_attention/flash_attention.py",
                  "models/model.py", "models/moe.py", "models/ssm.py", "models/convert.py", "serving/engine.py",
                  "serving/content_cache.py",
                  "serving/scheduler.py", "core/policies.py", "configs/__init__.py", "launch/serve.py"):
        assert f"src/repro_torch/{entry}" in names, entry
    assert (ROOT / "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu").is_file()
    # the fleet slice: device traces, the router, the fleet engine and its host copies, the
    # measurement modules
    for entry in ("workloads/device.py", "cdn/__init__.py", "cdn/router.py", "fleet/__init__.py",
                  "fleet/placement.py", "fleet/topology.py", "fleet/sim.py", "fleet/reference.py",
                  "fleet/report.py", "telemetry/latency.py", "telemetry/oracle.py", "telemetry/export.py",
                  "telemetry/dashboard.py", "core/simulate.py", "core/energy.py"):
        assert f"src/repro_torch/{entry}" in names, entry
    # the placed engine's slice: the two-tier hierarchy, its oracle and report, the serving fleet front
    for entry in ("cdn/hierarchy.py", "cdn/reference.py", "cdn/report.py", "serving/fleet_cache.py"):
        assert f"src/repro_torch/{entry}" in names, entry
    # the streaming engine and the multi-device fleet
    for entry in ("fleet/stream.py", "fleet/shard.py"):
        assert f"src/repro_torch/{entry}" in names, entry
    # the encoder-decoder
    assert "src/repro_torch/models/whisper.py" in names
    # training: the data stream, the optimizer, compression, the train step, checkpoints, the trainer
    # and its launcher
    for entry in ("train/__init__.py", "train/data.py", "train/optimizer.py", "train/compression.py",
                  "train/train_step.py", "train/checkpoint.py", "train/trainer.py", "launch/train.py"):
        assert f"src/repro_torch/{entry}" in names, entry
    assert len(names) >= 67


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
