#!/usr/bin/env python3
"""Print the evictions of ``chip_smoke.py``'s CPU-side checks at their cut depth.

    python3 experiments/check_depths.py [--workers 6]

Runs the plain version on the CPU (seed 0, 12 samples) at the depths the
script gives the checks whose plain version runs in its CPU workers and were
cut: the sized checks at N = 10,000 (gdsf on the lognormal catalogue, the six
byte programs under each catalogue's budget, and gdsf's max_victims=2 case,
which must differ from the default bound), arc's Zipf and scan checks at
N = 10,000, and every telemetry program's kind on the small telemetry case's
Zipf and multi_tenant traces. Prints each case's least evictions a sample.
CPU only; about 4 minutes with 6 workers.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import multiprocessing
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def run(case: tuple) -> tuple:
    torch.set_num_threads(1)
    import chip_smoke as cs
    from repro_torch.core import simulate, zipf
    from repro_torch.workloads import generators

    label, kind, n, cap, trace_len, dist, budget, extra, traces = case
    if traces == "scan":
        tr = generators.scan(n, cs.SAMPLES, trace_len, seed=cs.SCAN_SEED, **cs.SCAN_KW)
    elif traces == "multi_tenant":
        tr = generators.multi_tenant(n, cs.SAMPLES, trace_len, seed=0, n_tenants=cs.TEL_GROUPS)
    else:
        tr = zipf.sample_traces(n, cs.SAMPLES, trace_len, seed=0)
    kw = dict(kind=kind, n_objects=n, capacity=cap, **extra)
    if dist:
        sizes = cs.catalogue(dist, n)
        kw["sizes"] = torch.as_tensor(sizes)
        if budget:
            kw["capacity_bytes"] = simulate.bytes_budget(sizes, cap)
    out = cs.plain(torch.as_tensor(tr), **kw)
    evictions = out["inserts"].long() - out["in_cache"].long().sum(dim=1)
    return label, int(evictions.min()), out


def cases() -> list[tuple]:
    import chip_smoke as cs

    n, cap, gdsf_len, bytes_len = cs.SIZED_CHECK_CASES[0]
    out = [("gdsf lognormal", "gdsf", n, cap, gdsf_len, "lognormal", False, {}, "zipf")]
    for dist in ("lognormal", "pareto"):
        for kind in cs.BYTE_KINDS:
            out.append((f"{kind}+bytes {dist}", kind, n, cap, bytes_len, dist, True, {}, "zipf"))
    out.append(("gdsf+bytes pareto max_victims=2", "gdsf", n, cap, cs.SIZED_CHECK_LEN, "pareto", True,
                {"max_victims": 2}, "zipf"))
    n, cap, zipf_len, scan_len = cs.ARC_CHECK_CASES[1]
    out += [("arc", "arc", n, cap, zipf_len, None, False, {}, "zipf"),
            ("arc scan", "arc", n, cap, scan_len, None, False, {}, "scan")]
    n, cap, tel_len = cs.TEL_CHECK_CASES[0]
    for program, (kind, extra) in cs.tel_kinds().items():
        for traces in ("zipf", "multi_tenant"):
            out.append((f"telemetry {program} {traces}", kind, n, cap, tel_len, extra.get("sizes_dist"),
                        bool(extra.get("budget")), cs.grid_options(kind), traces))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workers", type=int, default=6)
    workers = parser.parse_args().workers
    ctx = multiprocessing.get_context("spawn")
    outs = {}
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx) as ex:
        for label, least, out in ex.map(run, cases()):
            outs[label] = out
            print(f"[depth] {label}: least evictions a sample {least}", flush=True)
    capped, default = outs["gdsf+bytes pareto max_victims=2"], outs["gdsf+bytes pareto"]
    differs = any(not torch.equal(capped[k], default[k]) for k in ("hits", "in_cache", "inserts"))
    print(f"[depth] max_victims=2 differs from the default bound: {differs}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
