"""The thesis's robustness claim on the speaker pairing.

The port's counterpart of `examples/robustness_study_speaker.py` (`main`,
`:53`). The reference's speaker task pairs a completely unregularized plain
MLP (`Speaker recognition/train_no_constraints.py:52-75`: no BatchNorm, no
dropout) against the NonNeg + BN simple_norm(rho=1) recipe (`Speaker
recognition/train_constraints.py:41,97-105`); its headline plots are
accuracy-vs-strength curves of the black-box noise families (`Speaker
recognition/attacks.py:319-419`).

This script trains both recipes at full width (2020->1024->...->20, batch
64, device-resident fits on K3, 25 epochs a dispatch) on the synthetic
20-voice corpus (`hard_corpus.make_speaker_corpus`) and runs that sweep
matrix from `attacks/sweeps.py::GRIDS`: the audio-domain families noise the
full recording, then slice it into 1-s windows, featurize them (K1, one
launch a sweep point) and standardize after by a refit on [train; val;
attacked test] (`SR/attacks.py:348`); the raw-MFCC families standardize
after too; FGSM runs on the standardized features.

    python -m asr_using_robust_nn_tpu_torch.examples.robustness_study_speaker \\
        [--out docs/results_speaker_torch] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

from ..attacks.sweeps import GRIDS, blackbox_sweep, whitebox_sweep
from ..data.pipeline import build_dataset, standardize_fit_all
from ..ops.mfcc_torch import FrontendConfig
from ..utils import native
from ..utils.device import resolve_device
from ._study import (RECIPES, analyze, device_line, fit_info, fit_recipe,
                     model_fns, save_plot)
from .hard_corpus import make_speaker_corpus

__all__ = ["SWEEPS", "run_study", "main"]

# the reference's speaker sweep matrix (`SR/attacks.py:319-336`; the JAX
# script's `:181-190`)
SWEEPS = (
    ("white_audio", tuple(GRIDS["audio_sigmas_speaker"])),
    ("snr_audio", tuple(GRIDS["snrs_db_speaker"])),
    ("mixture_audio", tuple(GRIDS["audio_alphas_speaker"])),
    ("white_mfcc", tuple(GRIDS["mfcc_sigmas"])),
    ("mixture_mfcc", tuple(GRIDS["mfcc_alphas"])),
    ("fgsm", (0.02, 0.05, 0.1, 0.2, 0.4)),
)


def run_study(splits, *, rho=1.0, epochs=800, constrained_epochs=2000,
              seed=0, device=None, out=None, sweeps=SWEEPS, overrides=None,
              log=print):
    """Both speaker recipes on `splits` (a speaker-task `DatasetSplits` whose
    test files still exist: the audio sweeps decode them), the analysis and
    the sweeps, in the JAX script's order. -> (results, models) as in
    `robustness_study_synthetic.run_study`, whose `overrides` this takes
    too."""
    dev = resolve_device(device)
    tr, dv, te, _, _ = standardize_fit_all(
        splits.train_data, splits.dev_data, splits.test_data)
    yte = splits.test_label

    def std(feats):
        # the reference's standardize_dataset re-fits the scaler per sweep
        # point on [train; val; perturbed test] (`SR/attacks.py:348,437-438`)
        # with raw train/val in the standardize-after case
        _, _, out_, _, _ = standardize_fit_all(
            splits.train_data, splits.dev_data, feats)
        return out_

    models = {}
    for recipe in RECIPES["speaker"]:
        n_ep = constrained_epochs if recipe.constrained else epochs
        t0 = time.time()
        fit = fit_recipe(recipe, tr, splits.train_label, dv, splits.dev_label,
                         epochs=n_ep, rho=rho, seed=seed, device=dev,
                         epochs_per_dispatch=25,
                         **(overrides or {}).get(recipe.name, {}))
        tnr = fit["trainer"]
        _, acc = tnr.evaluate(fit["params"], fit["state"], te, yte)
        _, fit_acc = tnr.evaluate(fit["params"], fit["state"], tr,
                                  splits.train_label)
        a = analyze(fit["cfg"], fit["params"], fit["state"], te, yte, dev)
        log(f"{recipe.name}: {time.time() - t0:.1f}s, clean {acc:.3f} "
            f"(train fit {fit_acc:.3f}), Lipschitz ref-formula "
            f"{a['lipschitz']:.3f} / sound {a['lipschitz_sound']:.3f} (naive "
            f"norms-product {a['norms_product']:.2f}), median margin "
            f"{a['median_margin']:.2f}")
        models[recipe.name] = dict(fit, clean_acc=float(acc),
                                   train_fit=float(fit_acc), **a)

    lc, pc = model_fns(models["constrained"]["cfg"],
                       models["constrained"]["params"],
                       models["constrained"]["state"], dev)
    lu, pu = model_fns(models["unconstrained"]["cfg"],
                       models["unconstrained"]["params"],
                       models["unconstrained"]["state"], dev)
    results = {
        "task": "speaker",
        "corpus": None,
        "rho": rho,
        **{k: {n: models[n][m] for n in models} for k, m in (
            ("clean", "clean_acc"), ("train_fit", "train_fit"),
            ("lipschitz_ref_formula", "lipschitz"),
            ("lipschitz_sound", "lipschitz_sound"),
            ("norms_product", "norms_product"),
            ("median_margin", "median_margin"))},
        "curves": {},
    }

    fe_cfg = FrontendConfig.speaker()
    waves_list = native.decode_resample_batch(
        list(splits.test_filenames), fe_cfg.sr)
    audio_labels = splits.test_audio_label
    for atk, strengths in sweeps:
        t0 = time.time()
        kw = dict(strengths=list(strengths), seed=seed, device=dev)
        if atk.endswith("_audio"):
            # noise the full recording -> 1-s windows -> MFCC -> std-after
            res = blackbox_sweep(atk, pc, pu, audio_labels,
                                 test_waves_list=waves_list,
                                 frontend_cfg=fe_cfg, standardize=std, **kw)
        elif atk.endswith("_mfcc"):
            # raw-unit sigmas on un-standardized MFCCs, standardized after
            # the attack (the reference's default 'A' branch)
            res = blackbox_sweep(atk, pc, pu, yte,
                                 test_features=splits.test_data,
                                 standardize=std, **kw)
        else:
            res = whitebox_sweep(atk, lc, lu, pc, pu, te, yte, **kw)
        results["curves"][atk] = res.as_dict()
        log(f"{atk} ({time.time() - t0:.1f}s):")
        for s, a, b in zip(res.strengths, res.accuracy_constrained,
                           res.accuracy_unconstrained):
            log(f"  {float(s):8.4f}: constrained {a:.3f}  "
                f"unconstrained {b:.3f}")
        if out is not None:
            save_plot(res, os.path.join(out, f"{atk}.png"), log)
    return results, models


def main(argv=None, *, overrides=None) -> int:
    """The script; `overrides` goes to `run_study` (e.g. the plain epoch
    for both recipes: `tools/study_arm.py`)."""
    ap = argparse.ArgumentParser(prog="robustness_study_speaker")
    ap.add_argument("--out", default="docs/results_speaker_torch")
    ap.add_argument("--n-speakers", type=int, default=20)
    ap.add_argument("--recordings", type=int, default=30)
    ap.add_argument("--noise-hi", type=float, default=0.12)
    ap.add_argument("--formant-jitter", type=float, default=0.04)
    ap.add_argument("--epochs", type=int, default=800)
    ap.add_argument("--constrained-epochs", type=int, default=2000)
    ap.add_argument("--rho", type=float, default=1.0,
                    help="reference value: SR/train_constraints.py rho=1")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' for the tests")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    print("device:", device_line(dev))
    t_all = time.time()
    root = tempfile.mkdtemp(prefix="speaker_study_")
    try:
        t0 = time.time()
        corpus = make_speaker_corpus(
            root, n_speakers=args.n_speakers, recordings=args.recordings,
            noise_hi=args.noise_hi, formant_jitter=args.formant_jitter,
            seed=args.seed, sr=22050)
        splits = build_dataset(corpus, "speaker", seed=args.seed, device=dev)
        t_data = time.time() - t0
        print(f"corpus+features: {t_data:.1f}s; train "
              f"{splits.train_data.shape} test {splits.test_data.shape}")
        results, models = run_study(
            splits, rho=args.rho, epochs=args.epochs,
            constrained_epochs=args.constrained_epochs, seed=args.seed,
            device=dev, out=args.out, overrides=overrides)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    results["corpus"] = dict(n_speakers=args.n_speakers,
                             recordings=args.recordings,
                             noise_hi=args.noise_hi,
                             formant_jitter=args.formant_jitter,
                             seed=args.seed)
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
