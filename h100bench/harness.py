"""The benchmark's frame: it finds a cell's configuration, traffic mix,
per-layer metrics, kernel tables and limits by name, runs the traffic's
traffic's generator (set-up, the measured window, the traced part, the check against the
plain reference) and prints the result line.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A run measures the PyTorch/CUDA port `asr_using_robust_nn_tpu_torch`. It
exits non-zero, printing no result, where there is no CUDA device (or fewer
than the cell asks for), where the program is missing, and where JAX or the
JAX package is loaded in its process once the window has closed.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import json
import os
import sys
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"
# top-level module names that may not be loaded in a run's process, compared
# whole: the port `asr_using_robust_nn_tpu_torch` is not the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "asr_using_robust_nn_tpu")
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
              "torch_extensions", "CUDA_CACHE_PATH": "cuda"}


def set_run_env() -> None:
    """Before torch is imported: point every build and kernel cache at a
    fixed directory inside the checkout (the port's own nvcc libraries live
    in its `_build/`) and keep libraries from loading JAX by themselves.
    The program keeps the process's default threads, as its CLI runs."""
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(HERE / "_cache" / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names among the loaded modules."""
    names = {m.split(".")[0] for m in (modules if modules is not None
                                       else list(sys.modules))}
    return sorted(names.intersection(FORBIDDEN))


def load_manifest(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_entries(manifest: dict, workload: str) -> dict:
    """The cell's entries: the workload, its configuration, and its
    end-to-end and per-layer metrics (those that list it, or list none)."""
    cell = next((w for w in manifest["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"unknown workload {workload!r} (BENCHMARK.json "
                         f"names {[w['name'] for w in manifest['workloads']]})")
    config = next(c for c in manifest["configs"] if c["name"] == cell["config"])

    def mine(metrics):
        return [m for m in metrics
                if workload in m.get("workloads", [workload])]

    return {"cell": cell, "config": config,
            "end_to_end": mine(manifest["end_to_end"]),
            "per_layer": mine(manifest["per_layer"])}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_metric_reader(name: str):
    """`metrics/<name>.py`'s `read(run) -> float | None`."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "h100bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Run:
    """One run's inputs and what it measured: the cell's files, the seed,
    the device, the generator's facts and the trace's summary."""

    def __init__(self, args, entries: dict, device, t_start: float):
        self.args = args
        self.seed = int(args.seed)
        self.entries = entries
        self.cell = entries["cell"]
        self.config = load_json(ROOT / entries["config"]["file"])
        self.traffic = load_json(HERE / "traffic" / f"{self.cell['traffic']}"
                                 ".json")
        self.limits = load_json(HERE / "limits" / f"{self.cell['name']}"
                                ".json")["limits"]
        self.device = device
        self.t_start = t_start
        self.facts: dict = {}
        self.trace = None
        self.tracing = False

    def kernels(self, name: str) -> dict:
        """`kernels/<name>.json`: {"name", "match": [fragments], "exclude":
        [fragments]} - the device kernels that make up one hand-written
        kernel, by name fragment."""
        return load_json(HERE / "kernels" / f"{name}.json")

    def span(self, name: str):
        """A span of the benchmark's own, recorded in the traced part."""
        if not self.tracing:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)


def device_info(device) -> dict:
    """The device's name and the process's peak of allocated memory on it.
    (`main` runs only on a CUDA device; the harness's own tests drive
    `execute` on the CPU, which reports itself as such.)"""
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def parse_args(argv):
    ap = argparse.ArgumentParser(description="The port's H100 benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def check_lines(checks: dict) -> list[str]:
    return [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
            for k, v in checks.items()]


def judge(values: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for every number that has a limit."""
    return {k: {"value": values.get(k, float("inf")), "limit": lim}
            for k, lim in limits.items()}


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse_args(argv)
    entries = cell_entries(load_manifest(), args.workload)
    import torch

    chips = int(entries["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"h100bench: no CUDA device (the cell {args.workload} needs "
              f"{chips}); nothing is measured on the CPU", file=sys.stderr)
        return 1
    try:
        importlib.import_module("asr_using_robust_nn_tpu_torch")
    except ImportError as e:
        print(f"h100bench: the program is missing: {e}", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    run = Run(args, entries, device, t_start)
    try:
        return execute(run)
    except Exception:  # the run's boundary: report the fault, print no result
        traceback.print_exc()
        return 1


def execute(run: Run) -> int:
    """Set-up, window, traced part, check; prints the result line."""
    traffic = importlib.import_module(
        f"h100bench.generators.{run.traffic['generator']}").Traffic(run)
    traffic.setup()
    run.facts["setup_s"] = time.perf_counter() - run.t_start
    run.facts.update(traffic.window(float(run.args.seconds)))
    if run.args.trace:
        from .trace import traced

        run.tracing = True
        part, run.trace = traced(traffic.traced_part)
        run.tracing = False
        run.facts["traced"] = part
    dev = device_info(run.device)
    hit = forbidden_loaded()
    if hit:
        print(f"h100bench: forbidden modules loaded: {hit}", file=sys.stderr)
        return 3
    traffic.release()
    values = traffic.check()
    checks = judge(values, run.limits)
    attempted, failed = run.facts["attempted"], run.facts["failed"]
    correct = failed == 0 and attempted > 0 and all(
        c["value"] < c["limit"] or (c["limit"] == 0 and c["value"] == 0)
        for c in checks.values())
    metrics = {}
    if run.args.trace:
        for m in run.entries["per_layer"]:
            v = load_metric_reader(m["name"])(run)
            if v is None:
                continue
            if m["unit"] == "%" and v > 100.0:
                raise RuntimeError(f"{m['name']} reads {v} % (> 100): the "
                                   f"counts or the times are wrong")
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in run.entries["end_to_end"]:
            metrics[m["name"]] = {"value": traffic.end_to_end(m["name"]),
                                  "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        out["breakdown"] = run.trace["breakdown"]
    out["checks"] = checks
    hit = forbidden_loaded()
    if hit:
        print(f"h100bench: forbidden modules loaded: {hit}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    for line in check_lines(checks):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0
