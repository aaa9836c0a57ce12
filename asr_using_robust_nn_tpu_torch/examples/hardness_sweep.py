"""Exploration harness for the thesis-crossover regime.

The port's counterpart of `examples/hardness_sweep.py`: grids over corpus
hardness (formant jitter/gap ratio, noise floor, label noise, corpus size)
and constraint strength rho, trains BOTH recipes of a task on each cell
(`train_recipe` `:47`, `eval_cell` `:85`) and records clean accuracy, the
Lipschitz estimate, the median margin and FGSM / white-noise robustness
curves as JSON lines (`main` `:184`). Corpora and features are made once per
(task, corpus knobs, seed) (`_cached_splits` `:67`). The archived grids of
the JAX package live in `docs/results_synthetic/hardness/`.

    python -m asr_using_robust_nn_tpu_torch.examples.hardness_sweep \\
        --out /tmp/hardness/results.jsonl [--cells '[...]'] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import tempfile
import time

import torch

from ..attacks import whitebox
from ..attacks.sweeps import accuracy, point_generator
from ..data.pipeline import build_dataset, standardize_fit_all
from ..utils.device import resolve_device
from ._study import RECIPES, analyze, device_line, fit_recipe, model_fns
from .hard_corpus import flip_labels, make_hard_corpus, make_speaker_corpus

__all__ = ["FGSM_EPS", "NOISE_SIGMAS", "default_cells", "train_recipe",
           "eval_cell", "main"]

FGSM_EPS = [0.05, 0.1, 0.2, 0.4, 0.8]
NOISE_SIGMAS = [1.0, 2.0, 4.0, 8.0]


def train_recipe(recipe, tr, ytr, dv, ydv, epochs, patience, rho, seed,
                 device=None, **overrides) -> dict:
    """One recipe, device-resident with 25 epochs a dispatch; -> the fit
    (`_study.fit_recipe`)."""
    return fit_recipe(recipe, tr, ytr, dv, ydv, epochs=epochs, rho=rho,
                      seed=seed, device=device, patience=patience,
                      epochs_per_dispatch=25, **overrides)


_SPLITS_CACHE: dict = {}


def _cached_splits(task, hard_kw, seed, device):
    """Corpus generation + featurization depend only on (task, hard_kw,
    seed): the rho and label-noise axes of a sweep reuse them."""
    key = (task, tuple(sorted(hard_kw.items())), seed, str(device))
    if key not in _SPLITS_CACHE:
        root = tempfile.mkdtemp(prefix="hard_")
        try:
            corpus = (make_hard_corpus(root, seed=seed, **hard_kw)
                      if task == "digit"
                      else make_speaker_corpus(root, seed=seed, **hard_kw))
            _SPLITS_CACHE[key] = build_dataset(corpus, task, seed=seed,
                                               device=device)
        finally:
            shutil.rmtree(root, ignore_errors=True)
    return _SPLITS_CACHE[key]


def eval_cell(hard_kw, label_noise, rho, epochs_u, epochs_c, seed,
              fgsm_eps, noise_sigmas, task="digit", device=None,
              overrides=None) -> dict:
    """Train both recipes of `task` on one cell and probe them; -> the
    JSON-lines record (the JAX function's keys). `overrides` maps a recipe
    name to keyword arguments of `fit_recipe`."""
    dev = resolve_device(device)
    recipes = RECIPES[task]
    if task == "digit":
        # BN + dropout(0.4) everywhere: the reference's digit pairing
        # regularizes BOTH recipes (`VD/train_no_constraints.py:52-75`)
        n_classes = 10
        cfgs = {r.name: r.model_cfg() for r in recipes}
    else:
        # the reference's speaker pairing: a completely unregularized plain
        # MLP against NonNeg + BN + simple_norm rho
        n_classes = hard_kw.get("n_speakers", 20)
        cfgs = {r.name: dataclasses.replace(r.model_cfg(),
                                            n_classes=n_classes)
                for r in recipes}
    epochs = {"unconstrained": epochs_u, "constrained": epochs_c}
    splits = _cached_splits(task, hard_kw, seed, dev)
    tr, dv, te, _, _ = standardize_fit_all(
        splits.train_data, splits.dev_data, splits.test_data)
    ytr = flip_labels(splits.train_label, label_noise, n_classes, seed)
    ydv = flip_labels(splits.dev_label, label_noise, n_classes, seed + 7)
    yte = splits.test_label  # test labels stay clean

    out = {"task": task, "hard": hard_kw, "label_noise": label_noise,
           "rho": rho, "n_train": int(len(tr)), "models": {}}
    # patience == epochs: never stop early (the interpolation regime is the
    # point); the best-on-dev checkpoint is what gets evaluated, as the
    # reference's ModelCheckpoint(save_best_only=True)
    xte = torch.as_tensor(te, dtype=torch.float32, device=dev)
    for recipe in recipes:
        n_ep = epochs[recipe.name]
        t0 = time.time()
        kw = {"model_cfg": cfgs[recipe.name],
              **(overrides or {}).get(recipe.name, {})}
        fit = train_recipe(recipe, tr, ytr, dv, ydv, n_ep, n_ep, rho, seed,
                           device=dev, **kw)
        cfg, params, state = fit["cfg"], fit["params"], fit["state"]
        _, clean = fit["trainer"].evaluate(params, state, te, yte)
        _, fitted = fit["trainer"].evaluate(params, state, tr, ytr)
        a = analyze(cfg, params, state, te, yte, dev)
        logits_fn, predict = model_fns(cfg, params, state, dev)
        with torch.no_grad():
            y_att = torch.argmax(logits_fn(xte), -1)
        fgsm_acc = [accuracy(predict(whitebox.fgsm(
            logits_fn, xte, y_att, float(eps)).cpu().numpy()), yte)
            for eps in fgsm_eps]
        noise_acc = []
        for i, sg in enumerate(noise_sigmas):
            g = point_generator(seed, i, dev)
            pert = xte + float(sg) * torch.randn(xte.shape, generator=g,
                                                 device=dev)
            noise_acc.append(accuracy(predict(pert.cpu().numpy()), yte))
        out["models"][recipe.name] = {
            "clean": float(clean), "train_fit": float(fitted),
            "lipschitz": a["lipschitz"],
            "median_margin": a["median_margin"],
            "fgsm": fgsm_acc, "noise": noise_acc,
            "train_s": round(time.time() - t0, 1),
        }
    u, c = out["models"]["unconstrained"], out["models"]["constrained"]
    out["crossover"] = {
        "clean_gap": round(c["clean"] - u["clean"], 4),
        "fgsm_c_minus_u": [round(a - b, 4)
                           for a, b in zip(c["fgsm"], u["fgsm"])],
        "noise_c_minus_u": [round(a - b, 4)
                            for a, b in zip(c["noise"], u["noise"])],
    }
    return out


def default_cells(task: str) -> list:
    """The built-in grids (`hardness_sweep.py:206-232`)."""
    cells = []
    if task == "speaker":
        for noise_hi, fj in [(0.12, 0.04), (0.2, 0.06), (0.3, 0.08)]:
            cells.append(dict(
                hard=dict(n_speakers=20, recordings=30, noise_hi=noise_hi,
                          formant_jitter=fj, sr=22050),
                label_noise=0.0, rho=1.0))
        return cells
    for jr, nf, ln in [(0.7, 0.18, 0.0), (0.7, 0.18, 0.15),
                       (1.0, 0.22, 0.15), (1.0, 0.22, 0.25)]:
        for rho in (0.05, 0.1, 0.3):
            cells.append(dict(
                hard=dict(f1_gap=25.0, f1_jitter=25.0 * jr, f2_gap=45.0,
                          f2_jitter=45.0 * jr, noise_floor=nf,
                          files_per_class=40),
                label_noise=ln, rho=rho))
    return cells


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="hardness_sweep")
    ap.add_argument("--out", default=os.path.join(
        tempfile.gettempdir(), "hardness", "results.jsonl"))
    ap.add_argument("--task", default="digit", choices=["digit", "speaker"])
    ap.add_argument("--epochs-u", type=int, default=800)
    ap.add_argument("--epochs-c", type=int, default=4000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cells", default=None,
                    help="JSON list of cell dicts (or @file); "
                         "default = built-in grid")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' for the tests")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    if args.cells:
        if args.cells.startswith("@"):
            with open(args.cells[1:]) as fh:
                cells = json.load(fh)
        else:
            cells = json.loads(args.cells)
    else:
        cells = default_cells(args.task)

    print("device:", device_line(dev), "cells:", len(cells))
    with open(args.out, "a") as f:
        for i, cell in enumerate(cells):
            t0 = time.time()
            r = eval_cell(cell["hard"], cell["label_noise"], cell["rho"],
                          args.epochs_u, args.epochs_c, args.seed,
                          FGSM_EPS, NOISE_SIGMAS,
                          task=cell.get("task", args.task), device=dev)
            r["cell"] = i
            f.write(json.dumps(r) + "\n")
            f.flush()
            c = r["crossover"]
            print(f"[{i + 1}/{len(cells)}] {time.time() - t0:.0f}s "
                  f"ln={cell['label_noise']} rho={cell['rho']} "
                  f"clean_gap={c['clean_gap']} "
                  f"fgsm_delta={c['fgsm_c_minus_u']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
