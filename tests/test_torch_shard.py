"""The port's multi-device fleet runs on torch.distributed against the reference package's single-device runs.

The mirror of the sharded tests of tests/test_fleet.py and tests/test_placement.py.
A world of 4 ranks (gloo, ``init_method="file://..."``, no port to pick) is
spawned once for the module, each rank a process on the CPU, under a hard
timeout that kills the world, so a hung collective fails these tests and
not the suite. The ranks run the reference tests' configurations through
``repro_torch.fleet.simulate_fleet_sharded`` (edge-sharded, level-major and
placed) and ``simulate_fleet_device`` (sample-sharded), and write every
rank's whole result to disk; here each rank's result is held to the
reference's **single-device** ``simulate_fleet`` (or ``simulate_fleet_batch``
fed the port's generated traces and assignments), exactly: every key, value,
dtype and shape. A one-rank world checks the fallback, and the worlds also
record the divisibility and refusal errors.
"""
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import fleet as ref_fleet
from repro import workloads as ref_workloads
from repro_torch import fleet

from test_torch_fleet import _assert_same

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT_S = 240

TREE3 = dict(n_objects=160, widths=(8, 2, 1), capacities=(5, 12, 28))
PLACED = (("plfu", "lcd"), ("plfu", "prob(0.5)"), ("plfu", "admit"), ("tinylfu", "lcd"), ("plfua_dyn", "prob(0.5)"))
EDGE_CASES = {"plfu lce": dict(TREE3, kinds="plfu", trace=("churn", 1_500, 5))}
EDGE_CASES.update({f"{k} {p}": dict(TREE3, kinds=k, placements=p, trace=("churn", 1_200, 5)) for k, p in PLACED})
DEVICE_CASES = {
    "plfu lce": dict(TREE3, kinds="plfu", dspec=("stationary", 160, 4, 1_500, 2)),
    "plfu lcd": dict(n_objects=160, widths=(4, 1), kinds="plfu", capacities=(6, 24), placements="lcd",
                     dspec=("stationary", 160, 4, 1_000, 2)),
}

WORKER = r'''
import pickle, sys
sys.path.insert(0, sys.argv[6])
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
from repro_torch import fleet
from repro_torch.core.torch_cache import PolicySpec
from repro_torch.fleet import sim, shard
from repro_torch.workloads.device import DeviceTraceSpec

rank, world, init, out_dir, case_file = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
mesh = fleet.fleet_mesh(device="cpu")
assert fleet.mesh_size(mesh) == world
cases = pickle.load(open(case_file, "rb"))
np_tree = lambda t: sim._map(lambda v: v.numpy(), t)
tree_kw = lambda c: {k: v for k, v in c.items() if k not in ("trace", "dspec", "data")}
out = {"edge": {}, "device": {}, "errors": {}}
for name, c in cases["edge"].items():
    topo = fleet.tree(**tree_kw(c))
    trace, assignment = c["data"]
    out["edge"][name] = np_tree(fleet.simulate_fleet_sharded(topo, trace, assignment, mesh=mesh, device="cpu"))
for name, c in cases["device"].items():
    topo = fleet.tree(**tree_kw(c))
    res, tr, asg = fleet.simulate_fleet_device(topo, DeviceTraceSpec(*c["dspec"]), mesh=mesh, device="cpu")
    out["device"][name] = (np_tree(res), tr.numpy(), asg.numpy())

def error(name, fn):
    try:
        fn()
        out["errors"][name] = None
    except Exception as e:  # recorded for the test to check
        out["errors"][name] = (type(e).__name__, str(e))

trace = np.arange(200, dtype=np.int32) % 160
if world > 1:
    six = fleet.tree(n_objects=160, widths=(6, 1), kinds="lru", capacities=(5, 12))
    error("edges", lambda: fleet.simulate_fleet_sharded(six, trace, six.assignment(trace), mesh=mesh, device="cpu"))
    error("samples", lambda: fleet.simulate_fleet_device(six, DeviceTraceSpec("stationary", 160, world + 2, 100, 1),
                                                         mesh=mesh, device="cpu"))
    sized = fleet.tree(n_objects=160, widths=(world, 1), kinds="lru", capacities=(5, 12), capacity_bytes=(20, 50),
                       placements="lcd")
    error("bytes", lambda: fleet.simulate_fleet_sharded(sized, trace, sized.assignment(trace), mesh=mesh,
                                                        device="cpu"))
    topo = fleet.tree(n_objects=160, widths=(world, 1), kinds="lru", capacities=(5, 12), placements="lcd")
    grp = shard._Group(mesh)
    specs = topo.levels[0][rank: rank + 1]
    level0 = {k: v[0] for k, v in sim.stack_level_state(specs, 1, torch.device("cpu")).items()}
    error("telemetry", lambda: sim._placed_prelude(topo, 1, "cpu", instrument=True, level0_states=level0,
                                                   level0_caps=[5], edge_group=grp))
pickle.dump(out, open(f"{out_dir}/rank{rank}.pkl", "wb"))
dist.destroy_process_group()
'''


def _spawn(world: int, tmp: Path, case_file: Path) -> list:
    """Start a gloo world of ``world`` ranks; returns the processes."""
    init = f"file://{tmp}/init_{world}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(world), init, str(tmp), str(case_file),
                              str(ROOT / "src")], cwd=tmp, env=env, stdout=open(tmp / f"rank{r}.log", "w"),
                             stderr=subprocess.STDOUT)
            for r in range(world)]


def _wait(procs: list, deadline: float, tmp: Path) -> None:
    """Wait for every rank until ``deadline`` (``time.monotonic()``); as soon as a rank exits
    non-zero, or at the deadline, kill the ranks still running."""
    try:
        while any(p.poll() is None for p in procs) and all(p.returncode in (None, 0) for p in procs):
            if time.monotonic() > deadline:
                pytest.fail(f"the gloo world did not finish within {TIMEOUT_S} s")
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (r, (tmp / f"rank{r}.log").read_text()[-3000:])


def _reference_inputs():
    """Each edge case's (trace, assignment) from the reference's host generator and the port's router."""
    for c in EDGE_CASES.values():
        scenario, t_n, seed = c["trace"]
        trace = ref_workloads.make_traces(scenario, c["n_objects"], 1, t_n, seed=seed)[0]
        topo = fleet.tree(**{k: v for k, v in c.items() if k not in ("trace", "data")})
        c["data"] = (trace, topo.assignment(trace))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Run the 4-rank world and the 1-rank world side by side; every rank's output, by world size."""
    tmp = tmp_path_factory.mktemp("gloo")
    _reference_inputs()
    out = {}
    procs = {}
    for world in (WORLD, 1):
        d = tmp / f"world{world}"
        d.mkdir()
        case_file = d / "cases.pkl"
        case_file.write_bytes(pickle.dumps({"edge": EDGE_CASES, "device": DEVICE_CASES}))
        procs[world] = (d, _spawn(world, d, case_file))
    deadline = time.monotonic() + TIMEOUT_S
    for world, (d, ps) in procs.items():
        _wait(ps, deadline, d)
        out[world] = [pickle.loads((d / f"rank{r}.pkl").read_bytes()) for r in range(world)]
    return out


def _ref_topo(c):
    return ref_fleet.tree(**{k: v for k, v in c.items() if k not in ("trace", "dspec", "data")})


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_as_torch(v) for v in tree)
    return torch.as_tensor(tree)


@pytest.mark.parametrize("world", [WORLD, 1])
@pytest.mark.parametrize("name", list(EDGE_CASES))
def test_edge_sharded_matches_single_device_reference(worlds, name, world):
    """Every rank's edge-sharded result == the reference's single-device simulate_fleet."""
    c = EDGE_CASES[name]
    trace, assignment = c["data"]
    want = dict(ref_fleet.simulate_fleet(_ref_topo(c), trace, assignment))
    for r, rank_out in enumerate(worlds[world]):
        _assert_same(want, _as_torch(rank_out["edge"][name]), f"rank {r}")


@pytest.mark.parametrize("world", [WORLD, 1])
@pytest.mark.parametrize("name", list(DEVICE_CASES))
def test_sample_sharded_matches_single_device_reference(worlds, name, world):
    """Every rank returns all samples' traces and assignments (the same on every rank and in both
    worlds), and the result == the reference's simulate_fleet_batch fed them."""
    c = DEVICE_CASES[name]
    base_traces, base_assign = worlds[1][0]["device"][name][1:]
    assert base_traces.shape == (c["dspec"][2], c["dspec"][3])
    for r, rank_out in enumerate(worlds[world]):
        res, traces, assignments = rank_out["device"][name]
        np.testing.assert_array_equal(traces, base_traces, err_msg=f"rank {r} traces")
        np.testing.assert_array_equal(assignments, base_assign, err_msg=f"rank {r} assignments")
        want = dict(ref_fleet.simulate_fleet_batch(_ref_topo(c), traces, assignments))
        _assert_same(want, _as_torch(res), f"rank {r}")


@pytest.mark.parametrize("name, kind, match", [
    ("edges", "ValueError", "edge count 6 must divide over the 4-device mesh"),
    ("samples", "ValueError", "n_samples 6 must divide over the 4-device mesh"),
    ("bytes", "NotImplementedError", "byte-capacity placement is single-device"),
    ("telemetry", "NotImplementedError", "telemetry is single-device"),
])
def test_sharded_errors(worlds, name, kind, match):
    for r, rank_out in enumerate(worlds[WORLD]):
        got = rank_out["errors"][name]
        assert got is not None and got[0] == kind and match in got[1], (r, got)


def test_no_mesh_fallback():
    """mesh=None runs the single-process engine."""
    topo = fleet.tree(n_objects=100, widths=(2, 1), kinds="lru", capacities=(4, 12))
    trace = ref_workloads.make_traces("stationary", 100, 1, 400, seed=1)[0]
    assignment = topo.assignment(trace)
    base = fleet.simulate_fleet(topo, trace, assignment, device="cpu")
    out = fleet.simulate_fleet_sharded(topo, trace, assignment, mesh=None, device="cpu")
    for l in range(2):
        assert torch.equal(base["hit"][l], out["hit"][l])
    assert fleet.mesh_size(None) == 1
    from repro_torch.workloads.device import DeviceTraceSpec

    dspec = DeviceTraceSpec("flash_crowd", 100, n_samples=2, trace_len=300, seed=3)
    res, traces, assignments = fleet.simulate_fleet_device(topo, dspec, device="cpu")
    again = fleet.simulate_fleet_batch(topo, traces, assignments, device="cpu")
    for l in range(2):
        assert torch.equal(res["hit"][l], again["hit"][l])


def test_device_run_refuses_a_missing_card():
    """Without device="cpu" the sample-sharded entry point runs on the card, and raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from repro_torch.workloads.device import DeviceTraceSpec

    topo = fleet.tree(n_objects=100, widths=(2, 1), kinds="lru", capacities=(4, 12))
    with pytest.raises(RuntimeError, match="CUDA"):
        fleet.simulate_fleet_device(topo, DeviceTraceSpec("stationary", 100, n_samples=2, trace_len=50))
    with pytest.raises(RuntimeError, match="CUDA"):
        fleet.simulate_fleet_sharded(topo, np.zeros(50, np.int32), np.zeros(50, np.int32))


def test_fleet_mesh_needs_a_process_group():
    import torch.distributed as dist

    if dist.is_initialized():
        pytest.skip("a default process group exists in this process")
    with pytest.raises(RuntimeError, match="process group"):
        fleet.fleet_mesh(device="cpu")
