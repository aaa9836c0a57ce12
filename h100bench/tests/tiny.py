"""Runs of the benchmark's cells on the CPU at tiny sizes, for its tests:
a few hundred training rows of a tenth of a second, requests of 4-16 rows.
On the CPU every kernel wrapper of the program runs its plain twin, and the
fused epoch's twin (`epoch_backend="fused"`) stands in for K3."""

import time
import types

import torch

from h100bench import harness


def tweak(run):
    c, tr = run.config, run.traffic
    if tr["generator"] == "fit_resident":
        c["corpus"] = {"train": 300, "val": 70}
        c["frontend"]["width"] = 2205
        c["batch_size"] = 64
        c["epochs"] = c["patience"] = 2
        tr["warm_epochs"] = 1
        tr["epoch_backend"] = "fused"
    else:
        tr.update(rows_lo=4, rows_hi=16, block=8, pool_rows=64,
                  calibration_rows=64, warm_buckets=[4, 16], buckets=[4, 16],
                  sample_requests=3, trace_seconds=0.3)


def manifest() -> dict:
    """BENCHMARK.json with the cells held out of it (`held/<cell>.json`), so
    that their generators, readers and checks stay tested until a later
    benchmark lists them."""
    m = harness.load_manifest()
    for f in sorted((harness.HERE / "held").glob("*.json")):
        held = harness.load_json(f)
        for key in ("workloads", "end_to_end", "per_layer"):
            m[key] = m[key] + held[key]
    return m


def make_run(cell: str, seed: int = 2 ** 31 + 17, trace: int = 0,
             seconds: float = 0.3) -> harness.Run:
    torch.set_num_threads(2)
    entries = harness.cell_entries(manifest(), cell)
    args = types.SimpleNamespace(workload=cell, seed=seed, seconds=seconds,
                                 trace=trace)
    run = harness.Run(args, entries, torch.device("cpu"), time.perf_counter())
    tweak(run)
    return run
