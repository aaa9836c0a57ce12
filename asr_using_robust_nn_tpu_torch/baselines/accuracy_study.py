"""Same-data accuracy study: the port's framework arm beside the archived ones.

The port's counterpart of `baselines/accuracy_study.py`. It builds the same
synthetic corpora (`examples/hard_corpus.py` knobs, the same 70/20/10 file
split, fit-on-all standardizing), extracts the features twice (the f64
oracle `ops/frontend_ref.py`, per file, and the port's frontend, K1 on the
card) and records their largest gap, trains the framework arm on the port's
`fit_multi_run` (all K training seeds of a variant in one call) and probes
every model with shared noise draws and FGSM on its own gradients
(`evaluate_models`, `:436`).

The reference (Keras) arm and the same-weights cross-probe need TensorFlow,
which the card's machine does not have. Their per-seed rows, and those of
the JAX framework arm, come from the archived `baselines/accuracy_study.json`,
matched by task, corpus seed, training seeds and corpus fingerprint; where
nothing matches, the archived columns read "not run". The Speech Commands
fetch is not attempted (the port makes no network call): recorded as
"blocked", as in the archive.

The default arm is what the archive ran: `fit_multi_run` in f32 on the
plain backend (the runs as one batched program, K2 once a run a step).
`--bf16` trains `cfg.with_bf16()`; `run_task(..., epoch_backend="fused")`
trains each run on K3.

    python -m asr_using_robust_nn_tpu_torch.baselines.accuracy_study \\
        --seeds 6 --train-seeds 4 --tasks digit [--device cpu]

Writes `baselines/accuracy_study_torch.json` and `docs/ACCURACY_STUDY_TORCH.md`.
"""

from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import math
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

from ..attacks import whitebox
from ..data.corpus import DIGIT_WORDS, walk_corpus
from ..data.pipeline import (
    featurize_files,
    featurize_sliced_files,
    slice_seconds,
    split_files,
    standardize_fit_all,
)
from ..models.mlp import MLPConfig, apply_mlp
from ..ops.frontend_ref import mfcc_fixed_length_ref
from ..ops.mfcc_torch import FrontendConfig
from ..train import TrainConfig
from ..train.multi_run import fit_multi_run
from ..train.trainer import _tree_map
from ..utils import native
from ..utils.device import resolve_device

__all__ = ["NOISE_SIGMAS", "FGSM_EPS", "ARCHIVE_KNOBS", "corpus_fingerprint",
           "archive_fingerprint", "archived_arms", "make_task_corpus",
           "run_task",
           "run_framework_pipeline", "make_framework_eval", "evaluate_models",
           "summarize", "summarize_port", "f3_margin", "to_markdown", "main"]

# robustness probe grids on standardized features (`accuracy_study.py:64-65`)
NOISE_SIGMAS = [0.5, 1.0]
FGSM_EPS = [0.1, 0.3]

# the corpus knobs of the archived invocations: the JAX script's argparse
# defaults (`accuracy_study.py:1095-1108`); the archive's protocol block
# stores files_per_class and leaves the rest at these
ARCHIVE_KNOBS = dict(files_per_class=240, recordings=24, f1_gap=60.0,
                     f1_jitter=10.0, f2_gap=100.0, f2_jitter=15.0,
                     noise_floor=0.10, shortcut_amp=0.006)

NOT_RUN = "not run"


# --------------------------------------------------------------------------
# shared corpus + features
# --------------------------------------------------------------------------

_BLAS_ENV = ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS", "MKL_NUM_THREADS")


def _oracle(wave, cfg: FrontendConfig) -> np.ndarray:
    return mfcc_fixed_length_ref(
        np.asarray(wave, np.float64), sr=cfg.sr, n_mfcc=cfg.n_mfcc,
        n_fft=cfg.n_fft, hop_length=cfg.hop_length,
        win_length=cfg.win_length,
        utterance_length=cfg.utterance_length).reshape(-1)


def _oracle_rows(waves, cfg: FrontendConfig) -> list:
    """The oracle MFCC of each wave, in order. Its products are small (128 x
    1025 x 44 at the digit preset): a multithreaded BLAS spends far longer
    waking its threads than computing them. So a long list goes to spawned
    worker processes with one BLAS thread each; a short one runs here. The
    arithmetic is the same either way."""
    if len(waves) < 64:
        return [_oracle(w, cfg) for w in waves]
    saved = {k: os.environ.get(k) for k in _BLAS_ENV}
    os.environ.update({k: "1" for k in _BLAS_ENV})
    try:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(min(8, os.cpu_count() or 1),
                                 mp_context=ctx) as pool:
            return list(pool.map(_oracle, waves, itertools.repeat(cfg),
                                 chunksize=32))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def reference_features_digit(files, cfg: FrontendConfig) -> np.ndarray:
    """The reference's per-file loop (`VD/...py:144-150`) on the f64 oracle;
    -> (N, 880) float64."""
    waves = native.decode_resample_batch(list(files), cfg.sr)
    return np.stack(_oracle_rows(waves, cfg))


def reference_features_speaker(files, labels, cfg: FrontendConfig):
    """Per recording: slice into seconds, then one oracle MFCC a window
    (`SR/extract_features_construct_dataset.py:203-233`)."""
    waves = native.decode_resample_batch(list(files), cfg.sr)
    wins, labs = [], []
    for w, lab in zip(waves, np.asarray(labels)):
        for win in slice_seconds(np.asarray(w), cfg.sr):
            wins.append(win)
            labs.append(lab)
    return np.stack(_oracle_rows(wins, cfg)), np.asarray(labs, np.int64)


def framework_features(files, labels, task, cfg, device):
    """The port's frontend (K1 on the card) over the same files."""
    if task == "digit":
        return (featurize_files(files, cfg, device=device),
                np.asarray(labels, np.int64))
    return featurize_sliced_files(files, labels, cfg, device=device)


# --------------------------------------------------------------------------
# framework recipe
# --------------------------------------------------------------------------

def make_framework_eval(cfg, params, state, device=None):
    """(predict, fgsm) closures over the port's forward and attack."""
    dev = resolve_device(device)

    def logits_fn(xx):
        return apply_mlp(cfg, params, state, xx, train=False)[0]

    def predict(x):
        probs = []
        with torch.no_grad():
            for i in range(0, len(x), 2048):
                xt = torch.as_tensor(np.asarray(x[i:i + 2048], np.float32),
                                     device=dev)
                probs.append(torch.softmax(logits_fn(xt), -1).cpu().numpy())
        return np.concatenate(probs, 0)

    def fgsm(x, y, eps):
        return whitebox.fgsm(
            logits_fn, torch.as_tensor(np.asarray(x, np.float32), device=dev),
            torch.as_tensor(np.asarray(y), dtype=torch.int64, device=dev),
            eps).cpu().numpy()

    return predict, fgsm


def _cfgs(task):
    if task == "digit":
        return {"unconstrained": MLPConfig.digit_unconstrained(),
                "constrained": MLPConfig.digit_constrained()}
    return {"unconstrained": MLPConfig.speaker_unconstrained(),
            "constrained": MLPConfig.speaker_constrained()}


def run_framework_pipeline(task, feats, epochs, patience, rho, tseeds,
                           bf16=False, device=None, epoch_backend="plain",
                           cfgs=None):
    """Train the framework arm on `fit_multi_run`: all len(tseeds) training
    seeds of a variant in one call, early stopping and best-val tracking
    every epoch. -> ({variant: [(predict, fgsm, val_loss) per seed]},
    {variant: epochs each run trained}). `cfgs` (variant -> MLPConfig)
    replaces the task's presets."""
    from ..constraints import make_simple_norm_constraint

    dev = resolve_device(device)
    tr, ltr, dv, ldv, _, _ = feats
    batch = {"digit": {"unconstrained": 256, "constrained": 512},
             "speaker": {"unconstrained": 64, "constrained": 64}}[task]
    out, epochs_run = {}, {}
    for variant, cfg in (cfgs or _cfgs(task)).items():
        if bf16:
            cfg = cfg.with_bf16()
        constraint = constraint_init = None
        if variant == "constrained":
            con = make_simple_norm_constraint(rho)
            constraint, constraint_init = con.apply, con.init
        tcfg = TrainConfig(batch_size=batch[variant], epochs=epochs,
                           patience=patience, device_resident=True,
                           epochs_per_dispatch=1)
        res = fit_multi_run(
            cfg, tcfg, np.asarray(tr, np.float32), ltr,
            np.asarray(dv, np.float32), ldv, list(tseeds),
            constraint=constraint, constraint_init=constraint_init,
            epoch_backend=epoch_backend, device=dev)
        runs = []
        for r in range(len(tseeds)):
            params, state = _tree_map(lambda t: t[r].to(dev),
                                      (res["best_params"], res["best_state"]))
            predict, fgsm = make_framework_eval(cfg, params, state, dev)
            runs.append((predict, fgsm, float(res["best_val_loss"][r])))
        out[variant] = runs
        epochs_run[variant] = [int(e) for e in res["epochs_run"]]
    return out, epochs_run


# --------------------------------------------------------------------------
# evaluation protocol (shared)
# --------------------------------------------------------------------------

def evaluate_models(models, te, lte, noise_draws):
    """-> {variant: [per-run {probe: accuracy, val_loss}]} with SHARED noise
    draws. `models` maps variant -> list of (predict, fgsm, val_loss), one
    entry per training seed."""
    rows = {}
    for variant, runs in models.items():
        if not isinstance(runs, list):
            runs = [runs]
        vrows = []
        for (predict, fgsm, val_loss) in runs:
            r = {"clean": float(np.mean(
                np.argmax(predict(te), -1) == lte))}
            for s, eps_noise in noise_draws.items():
                r[f"noise@{s}"] = float(np.mean(
                    np.argmax(predict(te + s * eps_noise), -1) == lte))
            for eps in FGSM_EPS:
                adv = fgsm(te, lte, eps)
                r[f"fgsm@{eps}"] = float(np.mean(
                    np.argmax(predict(adv), -1) == lte))
            r["val_loss"] = float(val_loss)
            vrows.append(r)
        rows[variant] = vrows
    return rows


def corpus_fingerprint(task, args) -> str:
    """Short hash of every knob that shapes the generated corpus
    (`accuracy_study.py:474`); it names the corpus directory and matches
    runs against the archive."""
    if task == "digit":
        knobs = (args.files_per_class, args.f1_gap, args.f1_jitter,
                 args.f2_gap, args.f2_jitter, args.noise_floor,
                 args.shortcut_amp)
    else:
        knobs = (args.recordings,)
    return hashlib.md5(repr(knobs).encode()).hexdigest()[:10]


def archive_fingerprint(task, archive) -> str:
    """The corpus fingerprint of the archived runs of `task`."""
    knobs = dict(ARCHIVE_KNOBS)
    knobs["files_per_class"] = archive["protocol"]["files_per_class"]
    return corpus_fingerprint(task, argparse.Namespace(**knobs))


def archived_arms(archive, task, seed, tseeds, fingerprint):
    """The archived run of (task, corpus seed, training seeds) when its
    corpus fingerprint is `fingerprint`: {"reference", "framework",
    "cross"}; None where nothing matches."""
    if archive is None or task not in archive.get("tasks", {}):
        return None
    if archive_fingerprint(task, archive) != fingerprint:
        return None
    for r in archive["tasks"][task]["runs"]:
        if r["seed"] == seed and list(r.get("train_seeds", [])) == list(
                tseeds):
            return {k: r[k] for k in ("reference", "framework", "cross")
                    if k in r}
    return None


def make_task_corpus(task, args, seed) -> str:
    """Write the corpus of (task, corpus seed) under args.workdir, in a
    directory named by its fingerprint, and return its data directory. A
    directory whose corpus was completed before is reused as it is."""
    from ..examples import hard_corpus as hc

    root = os.path.join(args.workdir,
                        f"{task}_s{seed}_{corpus_fingerprint(task, args)}")
    done = os.path.join(root, "corpus_complete")
    if not os.path.exists(done):
        if task == "digit":
            hc.make_hard_corpus(
                root, files_per_class=args.files_per_class, seed=seed,
                sr=22050, f1_gap=args.f1_gap, f1_jitter=args.f1_jitter,
                f2_gap=args.f2_gap, f2_jitter=args.f2_jitter,
                noise_floor=args.noise_floor, shortcut_amp=args.shortcut_amp)
        else:
            hc.make_speaker_corpus(root, n_speakers=20,
                                   recordings=args.recordings, seed=seed,
                                   sr=22050)
        open(done, "w").close()
    return os.path.join(root, "data")


def run_task(task, args, seed, archive=None, device=None,
             epoch_backend="plain"):
    """One corpus seed of `task`: corpus, both feature sets, the port's arm
    trained on `fit_multi_run`'s `epoch_backend` and probed; the archived
    arms beside it where they match."""
    dev = resolve_device(device)
    t0 = time.time()
    fp = corpus_fingerprint(task, args)
    corpus = make_task_corpus(task, args, seed)
    if task == "digit":
        cfg, class_names, rho = FrontendConfig.digit(), DIGIT_WORDS, 0.1
    else:
        cfg, class_names, rho = FrontendConfig.speaker(), None, 1.0
    files, labels, _ = walk_corpus(corpus, class_names)
    splits = split_files(files, labels, seed)

    # features for BOTH pipelines on the SAME file splits
    t_feat = time.time()
    ref, fw = [], []
    for f, lab in splits:
        if task == "digit":
            ref += [reference_features_digit(f, cfg), np.asarray(lab)]
        else:
            ref += list(reference_features_speaker(f, lab, cfg))
        fw += list(framework_features(f, lab, task, cfg, dev))
    t_ref = time.time() - t_feat
    feat_gap = 0.0
    for i, split in ((0, "train"), (2, "dev"), (4, "test")):
        assert ref[i].shape == fw[i].shape, (split, ref[i].shape,
                                             fw[i].shape)
        np.testing.assert_array_equal(
            np.asarray(ref[i + 1]), np.asarray(fw[i + 1]),
            err_msg=f"{split} label mismatch between feature pipelines")
        feat_gap = max(feat_gap, float(np.abs(ref[i] - fw[i]).max()))

    # standardize fit-on-all (the reference's protocol,
    # `VD/train_google_dataset.py:27-33`)
    f_std = standardize_fit_all(fw[0], fw[2], fw[4])
    fw_feats = (f_std[0], fw[1], f_std[1], fw[3], f_std[2], fw[5])

    # SHARED noise draws per sigma: the archived arms drew these too
    nrng = np.random.default_rng(10_000 + seed)
    noise_draws = {s: nrng.standard_normal(fw_feats[4].shape)
                   for s in NOISE_SIGMAS}
    k = args.train_seeds
    tseeds = [seed] if k == 1 else [1000 * (seed + 1) + j for j in range(k)]
    epochs = args.digit_epochs if task == "digit" else args.speaker_epochs

    t_fw0 = time.time()
    fw_models, epochs_run = run_framework_pipeline(
        task, fw_feats, epochs, args.patience, rho, tseeds, bf16=args.bf16,
        device=dev, epoch_backend=epoch_backend)
    port_rows = evaluate_models(fw_models, fw_feats[4], fw_feats[5],
                                noise_draws)
    t_fw = time.time() - t_fw0
    arch = archived_arms(archive, task, seed, tseeds, fp) or {}
    return {
        "seed": seed,
        "train_seeds": tseeds,
        "n_train": int(len(fw_feats[0])),
        "n_test": int(len(fw_feats[4])),
        "corpus_fingerprint": fp,
        "feature_max_abs_gap": feat_gap,
        "port": port_rows,
        "framework": arch.get("framework", NOT_RUN),
        "reference": arch.get("reference", NOT_RUN),
        "cross": arch.get("cross", NOT_RUN),
        "port_epochs_run": epochs_run,
        "features_s": round(t_ref, 1),
        "port_train_s": round(t_fw, 1),
        "total_s": round(time.time() - t0, 1),
    }


# --------------------------------------------------------------------------
# the archive's summary (`accuracy_study.py:612-777`)
# --------------------------------------------------------------------------

def _basin_threshold(pooled, min_gap=0.10):
    """Split point of a bimodal sample: the midpoint of the largest internal
    gap, or None when the largest gap is < min_gap."""
    v = np.sort(np.asarray(pooled, np.float64))
    if v.size < 4:
        return None
    gaps = np.diff(v)
    i = int(np.argmax(gaps))
    if gaps[i] < min_gap:
        return None
    return float((v[i] + v[i + 1]) / 2)


def _selection_analysis(ref_runs, fw_runs, probe, n_boot=20000, seed=0):
    """Is a best-of-K delta's excess over the mean-of-K delta explained by
    selection noise (val-loss selection uninformative about `probe`)? A
    resampling null that randomizes only the selection within each corpus
    seed, and the pooled within-seed Spearman rho between val-loss rank and
    probe-accuracy rank."""
    rng = np.random.default_rng(seed)
    n = len(ref_runs)
    k = len(ref_runs[0])
    ref_mat = np.array([[run[probe] for run in rr] for rr in ref_runs])
    fw_mat = np.array([[run[probe] for run in rr] for rr in fw_runs])
    rows = np.arange(n)
    ri = rng.integers(0, k, size=(n_boot, n))
    fi = rng.integers(0, k, size=(n_boot, n))
    null = (fw_mat[rows, fi] - ref_mat[rows, ri]).mean(axis=1) * 100
    ref_bok = [int(np.argmin([run["val_loss"] for run in rr]))
               for rr in ref_runs]
    fw_bok = [int(np.argmin([run["val_loss"] for run in rr]))
              for rr in fw_runs]
    obs = float(np.mean([fw_mat[s, fw_bok[s]] - ref_mat[s, ref_bok[s]]
                         for s in range(n)]) * 100)
    center = float(null.mean())
    p_two = float(np.mean(np.abs(null - center) >= abs(obs - center)))
    rank_pairs = []
    for runs_ in (ref_runs, fw_runs):
        for rr in runs_:
            vl = np.array([run["val_loss"] for run in rr])
            acc = np.array([run[probe] for run in rr])
            rank_pairs.append((np.argsort(np.argsort(vl)),
                               np.argsort(np.argsort(acc))))
    a = np.concatenate([p[0] for p in rank_pairs]).astype(np.float64)
    b = np.concatenate([p[1] for p in rank_pairs]).astype(np.float64)
    a -= a.mean()
    b -= b.mean()
    denom = float(np.sqrt((a * a).sum() * (b * b).sum()))
    rho = float((a * b).sum() / denom) if denom else 0.0
    return {"bok_null_mean_pts": round(center, 2),
            "bok_null_sd_pts": round(float(null.std(ddof=1)), 2),
            "bok_null_p": round(p_two, 4),
            "val_probe_spearman": round(rho, 3),
            "n_boot": n_boot}


def summarize(task_runs, ref_key="reference", fw_key="framework"):
    """Per (variant, probe): seed-averaged mean-of-K deltas fw - ref,
    best-of-K deltas (each arm's val-loss-selected run per corpus seed),
    the cross-probe where the runs carry one, and, where the pooled clean
    accuracies are bimodal, a per-basin breakdown. With the default keys
    this is the archive's `summary` block; the port's table passes
    ref_key="framework", fw_key="port"."""
    first = task_runs[0][ref_key]["unconstrained"][0]
    probes = [p for p in first.keys() if p != "val_loss"]
    summary = {}
    for variant in ("unconstrained", "constrained"):
        v = {}
        ref_runs = [r[ref_key][variant] for r in task_runs]
        fw_runs = [r[fw_key][variant] for r in task_runs]
        ref_bok = [int(np.argmin([run["val_loss"] for run in rr]))
                   for rr in ref_runs]
        fw_bok = [int(np.argmin([run["val_loss"] for run in rr]))
                  for rr in fw_runs]
        pooled_clean = np.array(
            [run["clean"] for rr in ref_runs for run in rr]
            + [run["clean"] for rr in fw_runs for run in rr])
        thr = _basin_threshold(pooled_clean)
        for p in probes:
            refs = np.array([np.mean([run[p] for run in rr])
                             for rr in ref_runs])
            fws = np.array([np.mean([run[p] for run in rr])
                            for rr in fw_runs])
            deltas = (fws - refs) * 100
            n = len(deltas)
            stderr = (float(np.std(deltas, ddof=1) / np.sqrt(n)) if n > 1
                      else 0.0)
            v[p] = {"reference": round(float(refs.mean()), 4),
                    "framework": round(float(fws.mean()), 4),
                    "delta_pts": round(float(deltas.mean()), 2),
                    "delta_stderr_pts": round(stderr, 2)}
            refs_b = np.array([rr[i][p] for rr, i in zip(ref_runs, ref_bok)])
            fws_b = np.array([rr[i][p] for rr, i in zip(fw_runs, fw_bok)])
            bd = (fws_b - refs_b) * 100
            bse = float(np.std(bd, ddof=1) / np.sqrt(n)) if n > 1 else 0.0
            v[p]["reference_bok"] = round(float(refs_b.mean()), 4)
            v[p]["framework_bok"] = round(float(fws_b.mean()), 4)
            v[p]["bok_delta_pts"] = round(float(bd.mean()), 2)
            v[p]["bok_delta_stderr_pts"] = round(bse, 2)
            if all(len(rr) > 1 for rr in ref_runs) and n > 1:
                v[p]["selection"] = _selection_analysis(ref_runs, fw_runs, p)
            if ref_key == "reference" and isinstance(
                    task_runs[0].get("cross"), dict):
                crosses = np.array([r["cross"][variant][0][p]
                                    for r in task_runs])
                cdeltas = (crosses - refs_b) * 100
                cse = (float(np.std(cdeltas, ddof=1) / np.sqrt(n))
                       if n > 1 else 0.0)
                v[p]["cross"] = round(float(crosses.mean()), 4)
                v[p]["cross_delta_pts"] = round(float(cdeltas.mean()), 2)
                v[p]["cross_delta_stderr_pts"] = round(cse, 2)
        if thr is not None:
            ref_clean = np.array([run["clean"] for rr in ref_runs
                                  for run in rr])
            fw_clean = np.array([run["clean"] for rr in fw_runs
                                 for run in rr])
            basin = {"clean_threshold": round(thr, 4),
                     "reference_upper_frac": round(
                         float((ref_clean > thr).mean()), 3),
                     "framework_upper_frac": round(
                         float((fw_clean > thr).mean()), 3),
                     "n_runs_per_pipeline": int(ref_clean.size),
                     "per_probe": {}}
            for p in probes:
                ref_all = np.array([run[p] for rr in ref_runs for run in rr])
                fw_all = np.array([run[p] for rr in fw_runs for run in rr])
                row = {}
                for name, mask_r, mask_f in (
                        ("upper", ref_clean > thr, fw_clean > thr),
                        ("lower", ref_clean <= thr, fw_clean <= thr)):
                    if mask_r.any() and mask_f.any():
                        rm = float(ref_all[mask_r].mean())
                        fm = float(fw_all[mask_f].mean())
                        row[name] = {
                            "reference": round(rm, 4),
                            "framework": round(fm, 4),
                            "delta_pts": round((fm - rm) * 100, 2),
                            "n_ref": int(mask_r.sum()),
                            "n_fw": int(mask_f.sum()),
                        }
                basin["per_probe"][p] = row
            v["basin"] = basin
        summary[variant] = v
    return summary


def f3_margin(jax_accs, port_accs, n_test) -> dict:
    """The F3 rule (`tests/test_torch_train_multi.py::
    test_dropout_seed_mean_accuracy_vs_jax`) on two arms' per-seed
    accuracies: margin = max(4 s sqrt(2 / n), 2 / n_test), s the pooled
    per-seed spread, n the seeds; -> {jax, port, gap, margin, ok}."""
    ja = np.asarray(jax_accs, np.float64)
    pa = np.asarray(port_accs, np.float64)
    n = len(pa)
    s = float(np.sqrt((ja.var(ddof=1) + pa.var(ddof=1)) / 2)) if n > 1 \
        else 0.0
    margin = max(4 * s * math.sqrt(2 / n), 2 / n_test)
    gap = abs(float(ja.mean()) - float(pa.mean()))
    return {"jax": float(ja.mean()), "port": float(pa.mean()), "gap": gap,
            "margin": margin, "ok": bool(gap <= margin)}


def summarize_port(task_runs) -> dict:
    """The port's arm against the archived arms: per (variant, probe), the
    port's seed mean, paired per-seed deltas against the JAX framework arm
    and against the reference arm (mean-of-K and best-of-K, points, with
    their stderr), and per run the F3 margin on clean accuracy. Runs with no
    archived match give only the port's means."""
    probes = [p for p in task_runs[0]["port"]["unconstrained"][0]
              if p != "val_loss"]
    matched = [r for r in task_runs if isinstance(r["framework"], dict)]
    out = {"n_runs": len(task_runs), "n_matched": len(matched)}
    for variant in ("unconstrained", "constrained"):
        v = {}
        for p in probes:
            v[p] = {"port": round(float(np.mean(
                [np.mean([run[p] for run in r["port"][variant]])
                 for r in task_runs])), 4)}
        if matched:
            for other, key in (("framework", "jax"), ("reference", "ref")):
                if not all(isinstance(r[other], dict) for r in matched):
                    continue
                s = summarize(matched, ref_key=other, fw_key="port")[variant]
                for p in probes:
                    v[p][key] = s[p]["reference"]
                    v[p][f"port_minus_{key}_pts"] = s[p]["delta_pts"]
                    v[p][f"port_minus_{key}_stderr_pts"] = s[p][
                        "delta_stderr_pts"]
                    v[p][f"port_minus_{key}_bok_pts"] = s[p]["bok_delta_pts"]
                    v[p][f"port_minus_{key}_bok_stderr_pts"] = s[p][
                        "bok_delta_stderr_pts"]
            v["f3_clean"] = [dict(seed=r["seed"], **f3_margin(
                [run["clean"] for run in r["framework"][variant]],
                [run["clean"] for run in r["port"][variant]], r["n_test"]))
                for r in matched]
        out[variant] = v
    return out


def _cell(v, key):
    if key not in v:
        return NOT_RUN
    return f"{v[key]:.4f}"


def _delta(v, key):
    d = v.get(f"port_minus_{key}_pts")
    if d is None:
        return NOT_RUN
    se = v[f"port_minus_{key}_stderr_pts"]
    flag = "" if abs(d) <= max(0.5, 2 * se) else " ⚠"
    return f"{d:+.2f} ± {se:.2f}{flag}"


def to_markdown(results) -> str:
    """The study as Markdown: per task, each probe's archived reference
    (Keras) and JAX framework means beside the port's, and the port's
    delta against each in points with the stderr of the paired per-seed
    deltas, mean-of-K and, against the JAX arm, best-of-K (the archive's
    two estimators; ⚠ where |delta| > max(0.5, 2 stderr)), then the F3
    check of clean accuracy per corpus seed."""
    lines = [
        "# Accuracy study: the port's framework arm beside the archived arms",
        "",
        "Same synthetic corpora, same seeded splits, same standardizer, "
        "same probes (shared noise draws) as `baselines/accuracy_study.py`. "
        "The reference (Keras) and JAX framework columns are the archived "
        "`baselines/accuracy_study.json` runs matched by task, corpus seed, "
        "training seeds and corpus fingerprint (\"not run\" where none "
        "matches); the port column is this run. Seed-averaged; delta = port "
        "- archived arm in accuracy points ± the standard error of the "
        "paired per-seed deltas; best-of-K compares each arm's "
        "val-loss-selected run per corpus seed; ⚠ where |delta| > "
        "max(0.5, 2 stderr), per estimator (the archive's rule passes a cell "
        "when either estimator is within its band).",
        "",
        f"Device: {results.get('device', 'not recorded')}. Framework arm: "
        f"`fit_multi_run` (epoch backend "
        f"{results['protocol'].get('epoch_backend', 'plain')}, bf16 "
        f"{results['protocol'].get('framework_bf16', False)}).",
        "",
        f"Speech Commands v0.02 fetch: {results['speech_commands_fetch']}",
        "",
    ]
    for task, t in results["tasks"].items():
        runs, s = t["runs"], t["summary"]
        lines.append(
            f"## {task} task ({runs[0]['n_train']} train / "
            f"{runs[0]['n_test']} test rows, {len(runs)} corpus seed(s) "
            f"{[r['seed'] for r in runs]}, K={len(runs[0]['train_seeds'])}; "
            f"feature gap to the f64 oracle "
            f"{max(r['feature_max_abs_gap'] for r in runs):.1e}; "
            f"{s['n_matched']} of {len(runs)} matched in the archive)")
        lines.append("")
        lines.append("| variant | probe | reference (Keras, archived) | "
                     "JAX framework (archived) | port | port - JAX (pts) | "
                     "best-of-K port - JAX (pts) | port - reference (pts) |")
        lines.append("|---|---|---|---|---|---|---|---|")
        for variant in ("unconstrained", "constrained"):
            for probe, v in s[variant].items():
                if probe == "f3_clean":
                    continue
                lines.append(
                    f"| {variant} | {probe} | {_cell(v, 'ref')} | "
                    f"{_cell(v, 'jax')} | {v['port']:.4f} | "
                    f"{_delta(v, 'jax')} | {_delta(v, 'jax_bok')} | "
                    f"{_delta(v, 'ref')} |")
        lines.append("")
        f3 = [(variant, f) for variant in ("unconstrained", "constrained")
              for f in s[variant].get("f3_clean", [])]
        if f3:
            lines.append("Clean accuracy, port against the JAX framework arm "
                         "per corpus seed (the F3 rule: |mean gap| <= "
                         "max(4 s sqrt(2/K), 2/n_test)):")
            lines.append("")
            for variant, f in f3:
                lines.append(
                    f"- {variant}, seed {f['seed']}: JAX {f['jax']:.4f}, "
                    f"port {f['port']:.4f}, gap {f['gap']:.4f}, margin "
                    f"{f['margin']:.4f}: {'within' if f['ok'] else 'OUTSIDE'}")
            lines.append("")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="accuracy_study")
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--train-seeds", type=int, default=1,
                    help="training seeds PER corpus seed (K), all K trained "
                         "by one fit_multi_run call a variant")
    ap.add_argument("--merge", action="store_true",
                    help="load an existing --out JSON and only overwrite the "
                         "tasks run this invocation; resumes a task from its "
                         "completed seeds when their (seed, K) match")
    ap.add_argument("--md-only", action="store_true",
                    help="skip all training: load the existing --out JSON, "
                         "recompute summaries, rewrite --md")
    ap.add_argument("--tasks", default="digit,speaker")
    ap.add_argument("--files-per-class", type=int, default=240)
    ap.add_argument("--recordings", type=int, default=24)
    ap.add_argument("--digit-epochs", type=int, default=300)
    ap.add_argument("--speaker-epochs", type=int, default=150)
    ap.add_argument("--patience", type=int, default=60)
    ap.add_argument("--f1-gap", type=float, default=60.0)
    ap.add_argument("--f1-jitter", type=float, default=10.0)
    ap.add_argument("--f2-gap", type=float, default=100.0)
    ap.add_argument("--f2-jitter", type=float, default=15.0)
    ap.add_argument("--noise-floor", type=float, default=0.10)
    ap.add_argument("--shortcut-amp", type=float, default=0.006)
    ap.add_argument("--bf16", action="store_true",
                    help="train the framework arm in bf16 mixed precision "
                         "(cfg.with_bf16())")
    ap.add_argument("--archive", default="baselines/accuracy_study.json",
                    help="the archived JAX study whose arms stand beside "
                         "the port's")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--out", default="baselines/accuracy_study_torch.json")
    ap.add_argument("--md", default="docs/ACCURACY_STUDY_TORCH.md")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' for the tests")
    args = ap.parse_args(argv)
    if args.md_only:
        with open(args.out) as f:
            prev = json.load(f)
        for t in prev.get("tasks", {}).values():
            t["summary"] = summarize_port(t["runs"])
        with open(args.out, "w") as f:
            json.dump(prev, f, indent=2)
        md = to_markdown(prev)
        with open(args.md, "w") as f:
            f.write(md)
        print(md)
        return 0
    from ..examples._study import device_line

    dev = resolve_device(args.device)
    if args.workdir is None:
        import tempfile

        args.workdir = tempfile.mkdtemp(prefix="accuracy_study_")
    archive = None
    if args.archive and os.path.exists(args.archive):
        with open(args.archive) as f:
            archive = json.load(f)
    results = {
        "protocol": {
            "noise_sigmas": NOISE_SIGMAS, "fgsm_eps": FGSM_EPS,
            "files_per_class": args.files_per_class,
            "recordings": args.recordings,
            "digit_epochs": args.digit_epochs,
            "speaker_epochs": args.speaker_epochs,
            "patience": args.patience, "seeds": args.seeds,
            "train_seeds": args.train_seeds,
            "framework_bf16": bool(args.bf16),
            "epoch_backend": "plain",
        },
        "device": device_line(dev),
        "speech_commands_fetch": "blocked: not attempted (no network)",
        "tasks": {},
    }
    tasks = [t.strip() for t in args.tasks.split(",") if t.strip()]
    unknown = [t for t in tasks if t not in ("digit", "speaker")]
    if unknown:
        raise SystemExit(f"unknown task(s) {unknown}; valid: digit, speaker")
    if args.merge and os.path.exists(args.out):
        with open(args.out) as f:
            prev = json.load(f)
        results["tasks"].update(prev.get("tasks", {}))
        results["protocol"]["train_seeds_by_invocation"] = (
            prev.get("protocol", {}).get("train_seeds_by_invocation", [])
            + [{"tasks": args.tasks, "train_seeds": args.train_seeds,
                "seeds": args.seeds}])

    def persist():
        # write after every completed seed, not once at the end
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)

    for task in tasks:
        runs = []
        if args.merge:
            for r in results["tasks"].get(task, {}).get("runs", []):
                if r.get("seed") == len(runs) and len(
                        r["train_seeds"]) == args.train_seeds:
                    runs.append(r)
                else:
                    break
            if runs:
                print(f"[{task}] resuming: reusing completed seeds "
                      f"0..{len(runs) - 1} from {args.out}", flush=True)
        for seed in range(len(runs), args.seeds):
            print(f"[{task} seed {seed}] running...", flush=True)
            r = run_task(task, args, seed, archive=archive, device=dev)
            runs.append(r)
            print(f"[{task} seed {seed}] done in {r['total_s']}s (features "
                  f"{r['features_s']}s, port {r['port_train_s']}s, feature "
                  f"gap {r['feature_max_abs_gap']:.2e})", flush=True)
            results["tasks"][task] = {"runs": runs,
                                      "summary": summarize_port(runs)}
            persist()
    md = to_markdown(results)
    with open(args.md, "w") as f:
        f.write(md)
    print(md)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
