"""System-level validation: the thesis's robustness claim on synthetic data.

The port's counterpart of `examples/robustness_study_synthetic.py`: it trains
the digit-task recipes at full width (880-dim MFCC features through the
port's frontend, K1 on the card; 880->1024->512->256->128->64->10,
unconstrained vs simple_norm-constrained, each a device-resident fit on K3)
on a synthetic 10-class formant corpus (`make_corpus`, `:43`), then runs
the black-box and white-box sweeps and writes the accuracy curves
(`main`, `:72`). The thesis's acceptance criterion is that the constrained
model's accuracy degrades more gracefully with attack strength.

    python -m asr_using_robust_nn_tpu_torch.examples.robustness_study_synthetic \\
        [--out docs/results_synthetic_torch] [--device cpu]

`results.json` has the JAX script's keys; `run.json` beside it records the
device (name and power limit), the wall seconds and each fit's epochs and
epoch backend.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from ..attacks.sweeps import blackbox_sweep, whitebox_sweep
from ..data.pipeline import build_dataset, standardize_fit_all
from ..utils import audio_io
from ..utils.device import resolve_device
from ._study import (RECIPES, analyze, device_line, fit_info, fit_recipe,
                     model_fns, save_plot)

__all__ = ["SWEEPS", "make_corpus", "run_study", "main"]

# the script's sweep matrix (`robustness_study_synthetic.py:181-186`)
SWEEPS = (
    ("white_mfcc", (0.0, 0.5, 1.0, 2.0, 4.0, 8.0)),
    ("mixture_mfcc", (0.0, 2.0, 5.0, 10.0, 20.0)),
    ("fgsm", (0.02, 0.05, 0.1, 0.2, 0.4)),
    ("pgd", (0.05, 0.1, 0.2)),
)


def make_corpus(root, n_classes=10, files_per_class=60, seed=0):
    """Word-like synthetic utterances: each class is a formant pattern
    (2-3 harmonic bands with class-specific sweeps), speaker-varied pitch,
    amplitude envelope and noise floor; the JAX script's corpus, byte for
    byte."""
    rng = np.random.default_rng(seed)
    sr = 16000
    t = np.arange(sr) / sr
    words = ["zero", "one", "two", "three", "four",
             "five", "six", "seven", "eight", "nine"][:n_classes]
    for wi, w in enumerate(words):
        d = os.path.join(root, "data", w)
        os.makedirs(d, exist_ok=True)
        f1 = 250 + 90 * wi
        f2 = 900 + 140 * (wi % 5)
        sweep = (-1) ** wi * (30 + 10 * wi)
        for i in range(files_per_class):
            pitch = rng.uniform(0.9, 1.15)
            env = np.minimum(1.0, 10 * t) * np.minimum(1.0, 10 * (1 - t))
            y = 0.5 * np.sin(2 * np.pi * (f1 * pitch + sweep * t) * t)
            y += 0.3 * np.sin(2 * np.pi * f2 * pitch * t)
            y += 0.15 * np.sin(2 * np.pi * 2 * f1 * pitch * t)
            y = y * env + 0.08 * rng.standard_normal(sr)
            y *= rng.uniform(0.5, 1.0)
            audio_io.write_wav(os.path.join(d, f"{i}.wav"),
                               y.astype(np.float32), sr)
    return os.path.join(root, "data")


def run_study(splits, *, rho=0.1, epochs=150, constrained_epochs=None,
              seed=0, device=None, out=None, sweeps=SWEEPS, overrides=None,
              log=print):
    """Both digit recipes on `splits` (a `DatasetSplits`), the analysis and
    the sweeps, in the JAX script's order. -> (results, models): results has
    the script's `results.json` keys; models maps each recipe's name to its
    fit (`_study.fit_recipe`) and analysis. `overrides` maps a recipe name
    to keyword arguments of `fit_recipe` (model_cfg, train_cfg, init). With
    `out`, each sweep's plot goes there where matplotlib is installed."""
    dev = resolve_device(device)
    tr, dv, te, _, _ = standardize_fit_all(
        splits.train_data, splits.dev_data, splits.test_data)
    yte = splits.test_label
    models = {}
    for recipe in RECIPES["digit"]:
        n_ep = (constrained_epochs
                if (recipe.constrained and constrained_epochs) else epochs)
        t0 = time.time()
        fit = fit_recipe(recipe, tr, splits.train_label, dv, splits.dev_label,
                         epochs=n_ep, rho=rho, seed=seed, device=dev,
                         **(overrides or {}).get(recipe.name, {}))
        _, acc = fit["trainer"].evaluate(fit["params"], fit["state"], te, yte)
        a = analyze(fit["cfg"], fit["params"], fit["state"], te, yte, dev)
        log(f"{recipe.name}: {time.time() - t0:.1f}s, clean acc {acc:.3f}, "
            f"Lipschitz {a['lipschitz']:.3f} (naive upper "
            f"{a['norms_product']:.2f}), median margin "
            f"{a['median_margin']:.3f}, certified L2 radius margin/(2L) = "
            f"{a['certified_radius']:.3f}")
        models[recipe.name] = dict(fit, clean_acc=float(acc), **a)

    lc, pc = model_fns(models["constrained"]["cfg"],
                       models["constrained"]["params"],
                       models["constrained"]["state"], dev)
    lu, pu = model_fns(models["unconstrained"]["cfg"],
                       models["unconstrained"]["params"],
                       models["unconstrained"]["state"], dev)
    results = {k: {n: models[n][m] for n in models} for k, m in (
        ("clean", "clean_acc"), ("lipschitz", "lipschitz"),
        ("median_margin", "median_margin"),
        ("certified_radius", "certified_radius"))}
    results["curves"] = {}
    for atk, strengths in sweeps:
        t0 = time.time()
        if atk in ("white_mfcc", "mixture_mfcc"):
            res = blackbox_sweep(atk, pc, pu, yte, test_features=te,
                                 seed=seed, strengths=list(strengths),
                                 device=dev)
        else:
            res = whitebox_sweep(atk, lc, lu, pc, pu, te, yte, seed=seed,
                                 strengths=list(strengths), device=dev)
        results["curves"][atk] = res.as_dict()
        log(f"{atk} ({time.time() - t0:.1f}s):")
        for s, a, b in zip(res.strengths, res.accuracy_constrained,
                           res.accuracy_unconstrained):
            log(f"  {s:7.3f}: constrained {a:.3f}  unconstrained {b:.3f}")
        if out is not None:
            save_plot(res, os.path.join(out, f"{atk}.png"), log)
    return results, models


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="robustness_study_synthetic")
    ap.add_argument("--out", default="docs/results_synthetic_torch")
    ap.add_argument("--files-per-class", type=int, default=60)
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--constrained-epochs", type=int, default=None,
                    help="override epochs for the constrained recipe (it "
                         "needs far more steps to redistribute weight under "
                         "the projection; the reference runs 10000)")
    ap.add_argument("--rho", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' for the tests")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    print("device:", device_line(dev))
    t_all = time.time()
    root = tempfile.mkdtemp(prefix="robust_study_")
    try:
        t0 = time.time()
        corpus = make_corpus(root, files_per_class=args.files_per_class,
                             seed=args.seed)
        splits = build_dataset(corpus, "digit", seed=args.seed, device=dev)
        t_data = time.time() - t0
        print(f"corpus+features: {t_data:.1f}s; train "
              f"{splits.train_data.shape}")
        results, models = run_study(
            splits, rho=args.rho, epochs=args.epochs,
            constrained_epochs=args.constrained_epochs, seed=args.seed,
            device=dev, out=args.out)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    path = os.path.join(args.out, "results.json")
    with open(path, "w") as f:
        json.dump(results, f, indent=2)
    with open(os.path.join(args.out, "run.json"), "w") as f:
        json.dump({"argv": sys.argv[1:] if argv is None else list(argv),
                   "device": device_line(dev),
                   "corpus_features_s": t_data,
                   "wall_s": time.time() - t_all,
                   "fits": {n: fit_info(m) for n, m in models.items()}},
                  f, indent=2)
    print("wrote", path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
