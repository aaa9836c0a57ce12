"""The readings a cell's limits are set from, in one process:

    python3 h100bench/control.py --workload <cell> --seeds 1 2 ... \
        --control-seeds 101 102 103 [--seconds 3] [--out FILE]

For each of `--seeds` the program's numbers (set-up runs the check's fit;
a serving cell also serves `--seconds` of its traffic), then for each of
`--control-seeds` the numbers of the reference put in the program's place:
its control, one precision below what the configuration states, and each
fault the cell can have. Every reading is printed as one JSON line (and
appended to `--out`). The benchmark's own runs never run this; it needs a
CUDA device, as they do.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from h100bench import harness  # noqa: E402

# what stands in the program's place, per generator: the control and the
# faults
STANDINS = {"fit_resident": ("control", "control_mfcc", "control_gemm",
                             "half_batch", "unchanged"),
            "serve_closed": ("control", "altered")}


def readings(workload: str, seeds, control_seeds, seconds: float, device,
             tweak=None, emit=print):
    """Yield {"seed", "kind", "numbers"} for the program on `seeds` and each
    stand-in on `control_seeds`. `tweak(run)` may resize the run (tests)."""
    entries = harness.cell_entries(harness.load_manifest(), workload)

    def traffic(seed):
        args = types.SimpleNamespace(workload=workload, seed=seed,
                                     seconds=seconds, trace=0)
        run = harness.Run(args, entries, device, time.perf_counter())
        if tweak is not None:
            tweak(run)
        d = importlib.import_module(
            f"h100bench.generators.{run.traffic['generator']}").Traffic(run)
        d.setup()
        if run.traffic["generator"] == "serve_closed":
            run.facts.update(d.window(seconds))
        return run, d

    out = []
    for seed in seeds:
        run, d = traffic(seed)
        d.release()
        r = {"seed": seed, "kind": "program", "numbers": d.check(),
             "detail": getattr(d, "detail", None)}
        emit(r)
        out.append(r)
    for seed in control_seeds:
        run, d = traffic(seed)
        d.release()
        for kind in STANDINS[run.traffic["generator"]]:
            r = {"seed": seed, "kind": kind, "numbers": d.standin(kind),
                 "detail": getattr(d, "detail", None)}
            emit(r)
            out.append(r)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    harness.set_run_env()
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 1

    def emit(r):
        line = json.dumps(r)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    readings(args.workload, args.seeds, args.control_seeds, args.seconds,
             torch.device("cuda", 0), emit=emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
