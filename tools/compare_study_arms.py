"""The thesis studies' four arms, scalar by scalar, under the F3 rule.

Arms: the archived JAX runs (`docs/results_synthetic/`, `docs/results_speaker/`,
cell 0 of `docs/results_synthetic/hardness/grid_calibrated.jsonl`), the JAX
package run on a CPU (`docs/results_*_jax_cpu/`, `tools/jax_cpu_study.py`),
the port's f32 plain epoch on a card (`docs/results_*_torch_plain/`,
`asr_using_robust_nn_tpu_torch/tools/study_arm.py`) and the port's K3 arm
(`docs/results_*_torch/`).

The rule, per scalar and pair of arms over their seeds:
|mean_a - mean_b| < max(4 s sqrt(1/n_a + 1/n_b), floor), s the pooled
per-seed standard deviation (an arm of one run adds no spread; the F3 rule
`4 s sqrt(2/n)` at n_a = n_b). Clean accuracy, sweep points and the median
margin on the values, floor 2 / n_test; the Lipschitz estimates and the
norms product on log10 of the values, floor log10(1.5).

    python tools/compare_study_arms.py [--study synthetic|speaker|hardness]
        [--md docs/STUDY_ARMS.md] [--summary] [--seeds 0,1,2]

Prints a markdown table a study (the arms' means, then one mark a pair:
"=" within the rule, "x" outside it, "." where an arm lacks the scalar) and
the count of scalars outside the rule a pair.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import re

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARMS = ("archive", "jax_cpu", "plain", "k3")
PAIRS = (("plain", "jax_cpu"), ("k3", "plain"), ("k3", "jax_cpu"),
         ("archive", "jax_cpu"))
N_TEST = {"synthetic": 100, "speaker": 120, "hardness": 150}
LOG_KEYS = ("lipschitz", "lipschitz_ref_formula", "lipschitz_sound",
            "norms_product")
NAMES = ("unconstrained", "constrained")


def _load(path):
    with open(os.path.join(ROOT, path)) as fh:
        return json.load(fh)


def _lines(path):
    with open(os.path.join(ROOT, path)) as fh:
        return [json.loads(x) for x in fh if x.strip()]


SEEDS = None  # None: every seed on disk; else the seeds to compare


def _seed_of(path: str) -> int:
    """The seed a result file holds: `seed<s>` in its path, else 0 (a
    study's plain `results.json`)."""
    m = re.findall(r"seed(\d+)", os.path.relpath(path, ROOT))
    return int(m[-1]) if m else 0


def _glob(pattern):
    return sorted(f for f in glob.glob(os.path.join(ROOT, pattern))
                  if SEEDS is None or _seed_of(f) in SEEDS)


def _study_scalars(res: dict) -> dict:
    """{scalar name: value} of one synthetic / speaker results.json."""
    out = {}
    for key in ("clean", "median_margin") + LOG_KEYS:
        for n in NAMES:
            if key in res and n in res[key]:
                out[f"{key} {n[0]}"] = float(res[key][n])
    for atk, cur in res["curves"].items():
        for side in ("constrained", "unconstrained"):
            for s, a in zip(cur["strengths"], cur[f"accuracy_{side}"]):
                out[f"{atk} {float(s):g} {side[0]}"] = float(a)
    return out


def _cell_scalars(line: dict) -> dict:
    out = {}
    for n in NAMES:
        m = line["models"][n]
        for key in ("clean", "lipschitz", "median_margin"):
            if key in m:
                out[f"{key} {n[0]}"] = float(m[key])
        for key in ("fgsm", "noise"):
            for i, a in enumerate(m[key]):
                out[f"{key}[{i}] {n[0]}"] = float(a)
    return out


def runs(study: str) -> dict:
    """{arm: [scalars of each run]} for one study (an arm without files is
    an empty list)."""
    if study == "synthetic":
        files = {
            "archive": ["docs/results_synthetic/results.json"],
            "jax_cpu": _glob("docs/results_synthetic_jax_cpu/seed*/results.json"),
            "plain": _glob("docs/results_synthetic_torch_plain/seed*/"
                           "results.json"),
            "k3": _glob("docs/results_synthetic_torch/results*.json"),
        }
        return {a: [_study_scalars(_load(f)) for f in fs]
                for a, fs in files.items()}
    if study == "speaker":
        files = {
            "archive": _glob("docs/results_speaker/results*.json"),
            "jax_cpu": _glob("docs/results_speaker_jax_cpu/seed*/results.json"),
            "plain": _glob("docs/results_speaker_torch_plain/seed*/"
                           "results.json"),
            "k3": _glob("docs/results_speaker_torch/results*.json"),
        }
        return {a: [_study_scalars(_load(f)) for f in fs]
                for a, fs in files.items()}
    lines = {
        "archive": _lines("docs/results_synthetic/hardness/"
                          "grid_calibrated.jsonl")[:1],
        "jax_cpu": [x for f in _glob("docs/results_synthetic_jax_cpu/hardness/"
                                     "grid_calibrated_cell0_seed*.jsonl")
                    for x in _lines(f)],
        "plain": [x for f in _glob("docs/results_synthetic_torch_plain/"
                                   "hardness/grid_calibrated_cell0_seed*"
                                   ".jsonl") for x in _lines(f)],
        "k3": [x for x in _lines("docs/results_synthetic_torch/hardness/"
                                 "grid_calibrated_cell0.jsonl")
               if SEEDS is None or x.get("seed", 0) in SEEDS],
    }
    return {a: [_cell_scalars(x) for x in ls] for a, ls in lines.items()}


def within(a: list, b: list, log: bool, n_test: int):
    """(gap, bar, ok) of two arms' per-seed values of one scalar."""
    fa, fb = np.asarray(a, float), np.asarray(b, float)
    floor = 2.0 / n_test
    if log:
        fa, fb = np.log10(np.abs(fa)), np.log10(np.abs(fb))
        floor = math.log10(1.5)
    na, nb = len(fa), len(fb)
    dof = (na - 1) + (nb - 1)
    ss = (np.sum((fa - fa.mean()) ** 2) + np.sum((fb - fb.mean()) ** 2))
    s = math.sqrt(ss / dof) if dof > 0 else 0.0
    gap = abs(float(fa.mean() - fb.mean()))
    bar = max(4.0 * s * math.sqrt(1.0 / na + 1.0 / nb), floor)
    return gap, bar, gap < bar


def compare(study: str) -> dict:
    arm_runs = runs(study)
    keys = []
    for rs in arm_runs.values():
        for r in rs:
            keys += [k for k in r if k not in keys]
    rows = []
    for k in keys:
        vals = {a: [r[k] for r in arm_runs[a] if k in r] for a in ARMS}
        log = k.split(" ")[0] in LOG_KEYS
        row = {"scalar": k, "log": log,
               "mean": {a: (float(np.mean(v)) if v else None)
                        for a, v in vals.items()},
               "n": {a: len(v) for a, v in vals.items()}, "pairs": {}}
        for x, y in PAIRS:
            if vals[x] and vals[y]:
                gap, bar, ok = within(vals[x], vals[y], log, N_TEST[study])
                row["pairs"][f"{x}~{y}"] = {"gap": gap, "bar": bar, "ok": ok}
        rows.append(row)
    outside = {f"{x}~{y}": [r["scalar"] for r in rows
                            if f"{x}~{y}" in r["pairs"]
                            and not r["pairs"][f"{x}~{y}"]["ok"]]
               for x, y in PAIRS}
    held = {p: sum(p in r["pairs"] for r in rows) for p in outside}
    return {"study": study, "n_test": N_TEST[study],
            "runs": {a: len(v) for a, v in arm_runs.items()}, "rows": rows,
            "outside": outside, "compared": held}


def markdown(res: dict) -> str:
    pairs = [f"{x}~{y}" for x, y in PAIRS]
    head = ("| scalar | " + " | ".join(f"{a} (n={res['runs'][a]})"
                                       for a in ARMS)
            + " | " + " | ".join(pairs) + " |")
    out = [f"### {res['study']} (n_test {res['n_test']})", "", head,
           "|" + "---|" * (1 + len(ARMS) + len(pairs))]
    for r in res["rows"]:
        means = [("" if r["mean"][a] is None else f"{r['mean'][a]:.4g}")
                 for a in ARMS]
        marks = [("." if p not in r["pairs"] else
                  ("=" if r["pairs"][p]["ok"] else "x")) for p in pairs]
        out.append(f"| {r['scalar']}{' (log)' if r['log'] else ''} | "
                   + " | ".join(means) + " | " + " | ".join(marks) + " |")
    out.append("")
    for p in pairs:
        out.append(f"- {p}: {len(res['outside'][p])} of "
                   f"{res['compared'][p]} outside: "
                   f"{', '.join(res['outside'][p]) or 'none'}")
    return "\n".join(out)


def summary(res: dict) -> str:
    """A compact table: the headline scalars (clean, Lipschitz-type, median
    margin) with their means and marks, then each sweep family's points as
    "within / compared" a pair."""
    pairs = [f"{x}~{y}" for x, y in PAIRS]
    head = ("| " + res["study"] + " | " + " | ".join(ARMS) + " | "
            + " | ".join(pairs) + " |")
    out = [head, "|" + "---|" * (1 + len(ARMS) + len(pairs))]
    families = {}
    for r in res["rows"]:
        key = r["scalar"].split(" ")[0]
        if key in ("clean", "median_margin") + LOG_KEYS:
            means = [("" if r["mean"][a] is None else f"{r['mean'][a]:.4g}")
                     for a in ARMS]
            marks = [("." if p not in r["pairs"] else
                      ("=" if r["pairs"][p]["ok"] else "x")) for p in pairs]
            out.append(f"| {r['scalar']} | " + " | ".join(means) + " | "
                       + " | ".join(marks) + " |")
            continue
        fam = f"{key.split('[')[0]} {r['scalar'].split(' ')[-1]}"
        tally = families.setdefault(fam, {p: [0, 0] for p in pairs})
        for p in pairs:
            if p in r["pairs"]:
                tally[p][0] += r["pairs"][p]["ok"]
                tally[p][1] += 1
    for fam, tally in families.items():
        out.append(f"| {fam} points | " + " | ".join("" for _ in ARMS) + " | "
                   + " | ".join(f"{a}/{n}" if n else "." for a, n in
                                (tally[p] for p in pairs)) + " |")
    return "\n".join(out)


def origins() -> str:
    """Where the live arms ran, from their run records."""
    seen = {"jax_cpu": set(), "plain": set(), "k3": set()}
    for arm, pattern, key in (
            ("jax_cpu", "docs/results_*_jax_cpu/**/*run.json", "cpu"),
            ("plain", "docs/results_*_torch_plain/**/*run.json", "device"),
            ("k3", "docs/results_*_torch/**/run*.json", "device")):
        for f in glob.glob(os.path.join(ROOT, pattern), recursive=True):
            rec = _load(f)
            if key in rec:
                seen[arm].add(rec[key])
    return "; ".join(f"{a}: {', '.join(sorted(v)) or 'none'}"
                     for a, v in seen.items())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--study", choices=sorted(N_TEST), action="append")
    ap.add_argument("--md", default=None)
    ap.add_argument("--summary", action="store_true",
                    help="print the compact tables only")
    ap.add_argument("--seeds", default=None,
                    help="compare only these seeds, e.g. 0,1,2 "
                         "(default: every seed on disk)")
    args = ap.parse_args(argv)
    global SEEDS
    SEEDS = None if args.seeds is None else {
        int(x) for x in args.seeds.split(",")}
    studies = args.study or ["synthetic", "speaker", "hardness"]
    results = [compare(s) for s in studies]
    text = "\n\n".join(markdown(r) for r in results)
    print("\n\n".join(summary(r) for r in results) if args.summary
          else text)
    if args.md:
        with open(args.md, "w") as fh:
            fh.write("# The thesis studies' four arms under the F3 rule\n\n"
                     "Written by `tools/compare_study_arms.py` (its docstring "
                     "states the rule). Arms: the archived JAX runs, the JAX "
                     "package on a CPU, the port's f32 plain epoch and its K3 "
                     f"epoch. Ran on: {origins()}. Seeds: "
                     f"{'all on disk' if SEEDS is None else sorted(SEEDS)}."
                     "\n\n" + text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
