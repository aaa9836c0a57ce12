"""Run one of the JAX package's study scripts on the CPU and record the run.

The yardstick for the port's thesis studies is the JAX package as it stands,
run now: this wrapper starts an unchanged script from `examples/` under
`JAX_PLATFORMS=cpu` with XLA's CPU thread pool off (one process a core), and
writes a `run.json` beside its output with the command, the commit, the JAX
version, the CPU model and the wall seconds.

    python tools/jax_cpu_study.py --run-json OUT/run.json -- \\
        examples/robustness_study_synthetic.py --seed 0 --out OUT ...

Always pass the script's `--out`: the synthetic and speaker scripts default
into the archived `docs/results_*` folders. `--core N` pins the process to one
core (`taskset`), so several seeds can share a machine without contending.
`--bn-json PATH` also writes, for every fit the script makes, the best state's
BatchNorm running variances per layer: how many units sit under `bn_eps`, and
the least variance. It reads them by wrapping the JAX `Trainer.fit` in the
script's process (the script and the package are not changed).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu_model() -> str:
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True).stdout
    except OSError:
        return "unknown"
    for line in out.splitlines():
        if line.startswith("Model name:"):
            return line.split(":", 1)[1].strip()
    return "unknown"


def _commit() -> str:
    out = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True,
                         text=True, cwd=ROOT)
    return out.stdout.strip() or "unknown"


def _child(bn_json: str, script: list) -> None:
    """Run `script` here with `Trainer.fit` wrapped to record each fit's
    best-state BatchNorm variances into `bn_json`."""
    import atexit
    import runpy

    import numpy as np

    sys.path.insert(0, ROOT)
    from asr_using_robust_nn_tpu.train import trainer as jtrainer

    fits = []
    fit = jtrainer.Trainer.fit

    def recording_fit(self, *a, **kw):
        res = fit(self, *a, **kw)
        cfg = self.model_cfg
        rec = {"in_dim": cfg.in_dim, "n_classes": cfg.n_classes,
               "batch_norm": bool(cfg.batch_norm),
               "epochs_run": int(res.get("epochs_run", -1))}
        if cfg.batch_norm:
            var = [np.asarray(s["var"]) for s in res["best_state"]["layers"]
                   if "var" in s]
            rec["bn_units_under_eps"] = [int((v < cfg.bn_eps).sum())
                                         for v in var]
            rec["bn_units"] = [int(v.size) for v in var]
            rec["bn_min_var"] = [float(v.min()) for v in var]
        fits.append(rec)
        return res

    def dump():
        with open(bn_json, "w") as fh:
            json.dump(fits, fh, indent=2)

    jtrainer.Trainer.fit = recording_fit
    atexit.register(dump)
    sys.argv = script
    runpy.run_path(os.path.join(ROOT, script[0]), run_name="__main__")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "--child":
        _child(argv[1], argv[2:])
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run-json", required=True)
    ap.add_argument("--core", type=int, default=None)
    ap.add_argument("--bn-json", default=None)
    ap.add_argument("script", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    script = [a for a in args.script if a != "--"]
    if "--out" not in script:
        ap.error("pass the study script's --out")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1",
               OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    cmd = [sys.executable] + script
    if args.bn_json:
        cmd = [sys.executable, os.path.abspath(__file__), "--child",
               os.path.abspath(args.bn_json)] + script
    if args.core is not None:
        cmd = ["taskset", "-c", str(args.core)] + cmd
    import jax  # the version the child imports; no device is touched here

    t0 = time.time()
    rc = subprocess.run(cmd, cwd=ROOT, env=env).returncode
    wall = time.time() - t0
    rec = {
        "command": "JAX_PLATFORMS=cpu python " + " ".join(script),
        "returncode": rc,
        "commit": _commit(),
        "jax": jax.__version__,
        "cpu": _cpu_model(),
        "pinned_core": args.core,
        "xla_flags": env["XLA_FLAGS"],
        "wall_s": wall,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.run_json)), exist_ok=True)
    with open(args.run_json, "w") as fh:
        json.dump(rec, fh, indent=2)
    return rc


if __name__ == "__main__":
    sys.exit(main())
