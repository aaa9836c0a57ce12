"""Self-contained demo on synthetic audio; no corpora needed.

The port's counterpart of `examples/demo_synthetic.py`: it writes a tiny
Speech-Commands-style corpus of synthetic tones (`make_corpus`, `:32`), runs
the whole pipeline through the port's API (decode -> MFCC, K1 on the card
-> constrained and unconstrained training, `train_pair` `:49` -> Lipschitz
estimate -> a black-box and a white-box sweep) and prints the comparison
the reference plots (`Voice digit recogniton/attacks.py`).

    python -m asr_using_robust_nn_tpu_torch.examples.demo_synthetic \\
        [--workdir DIR] [--device cpu]

Both models train streaming (one batch a step, K2 once a constrained step;
no fused epoch), as the JAX demo does.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from ..attacks.sweeps import blackbox_sweep, whitebox_sweep
from ..constraints import get_lipschitz_constrained, make_simple_norm_constraint
from ..data.pipeline import build_dataset, standardize_fit_all
from ..models.mlp import MLPConfig, init_mlp
from ..train import TrainConfig, Trainer
from ..train.trainer import _tree_map
from ..utils import audio_io
from ..utils.device import resolve_device
from ._study import model_fns

__all__ = ["make_corpus", "train_pair", "main"]


def make_corpus(root, n_classes=4, files_per_class=20, seed=0):
    """Rising tones, one pitch a class, with a little noise: the JAX demo's
    corpus, byte for byte."""
    rng = np.random.default_rng(seed)
    sr = 16000
    words = ["zero", "one", "two", "three"][:n_classes]
    for wi, w in enumerate(words):
        d = os.path.join(root, "data", w)
        os.makedirs(d, exist_ok=True)
        for i in range(files_per_class):
            t = np.arange(sr) / sr
            f0 = 220 + 170 * wi + rng.normal(0, 8)
            y = 0.4 * np.sin(2 * np.pi * f0 * t * (1 + 0.1 * t))
            y += 0.05 * rng.standard_normal(sr)
            audio_io.write_wav(os.path.join(d, f"{i}.wav"),
                               y.astype(np.float32), sr)
    return os.path.join(root, "data")


def train_pair(splits, seed=0, device=None):
    """Both recipes at hidden (128, 64), batch 16, 60 epochs; the
    constrained one NonNeg + simple_norm rho 0.5 with 16 rounds. -> ({name:
    (cfg, params, state, trainer)}, (tr, dv, te, mean, scale))."""
    dev = resolve_device(device)
    tr, dv, te, mean, scale = standardize_fit_all(
        splits.train_data, splits.dev_data, splits.test_data)
    n_classes = int(splits.train_label.max()) + 1
    results = {}
    for name, nonneg, constraint in [
        ("unconstrained", False, None),
        ("constrained", True, make_simple_norm_constraint(0.5, n_iter=16)),
    ]:
        cfg = MLPConfig(in_dim=880, n_classes=n_classes, hidden=(128, 64),
                        dropout=(0.1, 0.0), nonneg=nonneg)
        kw = {}
        if constraint is not None:
            p0, _ = init_mlp(cfg, torch.Generator(device=dev).manual_seed(
                seed), device=dev)
            kw = dict(constraint=constraint.apply,
                      constraint_state=constraint.init(p0))
        trainer = Trainer(
            cfg, TrainConfig(batch_size=16, epochs=60, patience=60,
                             seed=seed), device=dev, **kw)
        res = trainer.fit(tr, splits.train_label, dv, splits.dev_label)
        params, state = _tree_map(lambda t: t.to(dev),
                                  (res["best_params"], res["best_state"]))
        _, acc = trainer.evaluate(params, state, te, splits.test_label)
        lip = float(get_lipschitz_constrained(cfg, params, state))
        print(f"{name}: clean test acc {acc:.3f}, Lipschitz {lip:.3f}")
        results[name] = (cfg, params, state, trainer)
    return results, (tr, dv, te, mean, scale)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="demo_synthetic")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' for the tests")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    root = args.workdir or tempfile.mkdtemp(prefix="asrtpu_demo_")
    print("workdir:", root)

    corpus = make_corpus(root)
    splits = build_dataset(corpus, "digit", seed=0, device=dev)
    results, (tr, dv, te, mean, scale) = train_pair(splits, device=dev)

    lc, pc = model_fns(*results["constrained"][:3], device=dev)
    lu, pu = model_fns(*results["unconstrained"][:3], device=dev)

    print("\nwhite noise on MFCC (accuracy constrained vs unconstrained):")
    res = blackbox_sweep("white_mfcc", pc, pu, splits.test_label,
                         strengths=[0.0, 0.5, 1.0, 2.0], test_features=te,
                         device=dev)
    for s, a, b in zip(res.strengths, res.accuracy_constrained,
                       res.accuracy_unconstrained):
        print(f"  sigma={s:5.2f}: {a:.3f} vs {b:.3f}")

    print("\nFGSM (accuracy constrained vs unconstrained):")
    res = whitebox_sweep("fgsm", lc, lu, pc, pu, te, splits.test_label,
                         strengths=[0.05, 0.2, 0.5], device=dev)
    for s, a, b in zip(res.strengths, res.accuracy_constrained,
                       res.accuracy_unconstrained):
        print(f"  eps={s:5.2f}: {a:.3f} vs {b:.3f}")
    print("\ndemo complete")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
