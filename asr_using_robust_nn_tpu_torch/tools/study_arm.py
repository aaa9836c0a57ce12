"""The thesis studies as one arm of the port, at the archived settings.

`--backend plain` (the default) is the port's like-for-like arm against the
JAX package run on a CPU (whose trainer runs the f32 XLA epoch there): each
study module's `main` with `epoch_backend="plain"` for the unconstrained and
the constrained fit. `--backend auto` runs the modules as they stand (K3 on
the card). The settings:

  synthetic  robustness_study_synthetic --epochs 2500 --constrained-epochs
             12000 --files-per-class 100 --rho 0.3 (docs/results_synthetic/)
  speaker    robustness_study_speaker at its defaults (800 / 2000, rho 1)
  hardness   hardness_sweep on cell 0 of
             docs/results_synthetic/hardness/grid_calibrated.jsonl at its
             defaults (800 / 4000)

    python -m asr_using_robust_nn_tpu_torch.tools.study_arm all \\
        [--backend plain|auto] [--seeds 0,1,2] [--studies synthetic,speaker,
        hardness] [--jobs 8] [--out-root docs]
    python -m asr_using_robust_nn_tpu_torch.tools.study_arm synthetic \\
        --seed 0 --out DIR [--backend plain]

`all` runs every (study, seed) as its own process, `--jobs` at a time (the
fits are launch-bound, so processes sharing one card overlap), into
`<out-root>/results_synthetic_torch_plain/seed<s>/`,
`<out-root>/results_speaker_torch_plain/seed<s>/` and
`<out-root>/results_synthetic_torch_plain/hardness/
grid_calibrated_cell0_seed<s>.jsonl` (`_torch` for `--backend auto`); each
run's `run.json` (hardness: `.run.json` beside its line) carries the card's
name and power limit; the run logs go to `<out-root>/logs/`.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

PLAIN = {"unconstrained": {"epoch_backend": "plain"},
         "constrained": {"epoch_backend": "plain"}}
ARGS = {
    "synthetic": ["--epochs", "2500", "--constrained-epochs", "12000",
                  "--files-per-class", "100", "--rho", "0.3"],
    "speaker": [],
    "hardness": [],
}
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GRID = os.path.join(_ROOT, "docs", "results_synthetic", "hardness",
                    "grid_calibrated.jsonl")


def cell0() -> str:
    """Cell 0 of the archived calibrated grid, as `--cells` takes it."""
    with open(GRID) as fh:
        line = json.loads(fh.readline())
    return json.dumps([{k: line[k] for k in ("hard", "label_noise", "rho")}])


def run_one(study: str, argv: list) -> int:
    import torch

    torch.set_num_threads(1)
    backend = "plain"
    if "--backend" in argv:
        k = argv.index("--backend")
        backend = argv[k + 1]
        argv = argv[:k] + argv[k + 2:]
    overrides = PLAIN if backend == "plain" else None
    if study == "synthetic":
        from ..examples.robustness_study_synthetic import main
    elif study == "speaker":
        from ..examples.robustness_study_speaker import main
    else:
        from ..examples._study import device_line
        from ..examples.hardness_sweep import main
        from ..utils.device import resolve_device

        t0 = time.time()
        rc = main(argv, overrides=overrides)
        out = argv[argv.index("--out") + 1]
        dev = argv[argv.index("--device") + 1] if "--device" in argv else None
        with open(out[: -len(".jsonl")] + ".run.json", "w") as fh:
            json.dump({"argv": argv, "epoch_backend": backend,
                       "device": device_line(resolve_device(dev)),
                       "wall_s": time.time() - t0}, fh, indent=2)
        return rc
    return main(argv, overrides=overrides)


def run_all(seeds, jobs: int, out_root: str, backend: str = "plain",
            studies=("synthetic", "speaker", "hardness")) -> int:
    runs = []
    tail = "_torch_plain" if backend == "plain" else "_torch"
    syn = os.path.join(out_root, "results_synthetic" + tail)
    for s in seeds:
        argv = {
            "synthetic": ARGS["synthetic"] + [
                "--seed", str(s), "--out", os.path.join(syn, f"seed{s}")],
            "speaker": ["--seed", str(s), "--out", os.path.join(
                out_root, "results_speaker" + tail, f"seed{s}")],
            "hardness": ["--cells", cell0(), "--seed", str(s), "--out",
                         os.path.join(syn, "hardness",
                                      f"grid_calibrated_cell0_seed{s}.jsonl")],
        }
        runs += [(k, argv[k] + ["--backend", backend]) for k in studies]
    logs = os.path.join(out_root, "logs")
    os.makedirs(logs, exist_ok=True)
    pending, live, failed = list(runs), [], 0
    while pending or live:
        while pending and len(live) < jobs:
            study, argv = pending.pop(0)
            name = f"{study}_seed{argv[argv.index('--seed') + 1]}"
            fh = open(os.path.join(logs, name + ".log"), "w")
            p = subprocess.Popen(
                [sys.executable, "-m", __spec__.name, study, *argv],
                stdout=fh, stderr=subprocess.STDOUT, cwd=_ROOT)
            live.append((name, p, fh, time.time()))
        time.sleep(2)
        for item in list(live):
            name, p, fh, t0 = item
            if p.poll() is not None:
                fh.close()
                live.remove(item)
                failed += p.returncode != 0
                print(f"{name}: exit {p.returncode}, "
                      f"{time.time() - t0:.0f} s", flush=True)
    return 1 if failed else 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in ARGS:
        return run_one(argv[0], argv[1:])
    ap = argparse.ArgumentParser(prog="study_arm")
    ap.add_argument("mode", choices=["all"])
    ap.add_argument("--backend", choices=["plain", "auto"], default="plain")
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--studies", default="synthetic,speaker,hardness")
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--out-root", default="docs")
    args = ap.parse_args(argv)
    return run_all([int(s) for s in args.seeds.split(",")], args.jobs,
                   args.out_root, args.backend,
                   tuple(args.studies.split(",")))


if __name__ == "__main__":
    raise SystemExit(main())
