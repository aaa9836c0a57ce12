"""Bisect the speaker study's pipeline between the JAX package and the port.

The two steps that follow a study scalar outside the F3 rule between the
port's f32 plain arm and the JAX package run on a CPU (`tools/
compare_study_arms.py`), on the CPU, at the speaker widths:

1. Training: both packages' `Trainer.fit` (device-resident; the JAX XLA
   epoch and the port's plain epoch, both f32) of `speaker_constrained` at
   dropout 0, shuffle off, simple_norm(rho 1, 8 rounds), from one initial
   state carried over from the JAX package (weights, BN state, the power
   iteration's u), on the study corpus (seed 0, the JAX pipeline's features,
   standardized), for each length in `--epochs`: the largest gaps of the
   final parameters, BN running statistics and the epochs' losses; beside
   them the same gaps between two JAX fits whose initial weights differ by
   1e-6 relative (how far the recipe's own trajectory carries a last-bit
   difference in that many epochs).
2. Analysis and sweeps: the JAX-trained model of the longest fit carried into
   the port (`models/convert.py`): the reference and sound Lipschitz
   estimates, the norms product and the median margin, and every MFCC-domain
   and FGSM sweep point of the speaker study (the unconstrained side: a JAX
   `speaker_unconstrained` fitted alongside), held as the CPU tests hold
   them: FGSM within one test row, the clean point exactly, noisy points
   within 4 sqrt(2 p (1 - p) / n) plus one row (the draws differ: threefry
   against torch's generator).

    JAX_PLATFORMS=cpu python tools/bisect_study_pipeline.py \\
        --epochs 5,20 --out docs/results_speaker_jax_cpu/bisect.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _leaves(tree):
    import jax

    return [np.asarray(x, np.float64) for x in jax.tree_util.tree_leaves(tree)]


def _gap(a, b):
    return max((float(np.max(np.abs(x - y))) for x, y in
                zip(_leaves(a), _leaves(b))), default=0.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", default="5,20")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    import jax
    import torch

    from asr_using_robust_nn_tpu.attacks import sweeps as jsweeps
    from asr_using_robust_nn_tpu.constraints import make_simple_norm_constraint
    from asr_using_robust_nn_tpu.data import build_dataset, standardize_fit_all
    from asr_using_robust_nn_tpu.models import mlp as jmlp
    from asr_using_robust_nn_tpu.train import TrainConfig as JTrainConfig
    from asr_using_robust_nn_tpu.train import Trainer as JTrainer
    from asr_using_robust_nn_tpu_torch.attacks.sweeps import (
        blackbox_sweep, whitebox_sweep)
    from asr_using_robust_nn_tpu_torch.data.pipeline import (
        standardize_fit_all as pstd)
    from asr_using_robust_nn_tpu_torch.examples import _study
    from asr_using_robust_nn_tpu_torch.examples.robustness_study_speaker import (
        SWEEPS)
    from asr_using_robust_nn_tpu_torch.models.convert import (
        cstate_from_numpy, params_from_numpy, params_to_numpy)
    from asr_using_robust_nn_tpu_torch.models.mlp import MLPConfig
    from asr_using_robust_nn_tpu_torch.train import TrainConfig, Trainer
    from examples.hard_corpus import make_speaker_corpus

    torch.set_num_threads(1)
    t0 = time.time()
    root = tempfile.mkdtemp(prefix="bisect_")
    try:
        corpus = make_speaker_corpus(root, n_speakers=20, recordings=30,
                                     noise_hi=0.12, formant_jitter=0.04,
                                     seed=args.seed, sr=22050)
        sp = build_dataset(corpus, "speaker", seed=args.seed)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    tr, dv, te, _, _ = standardize_fit_all(sp.train_data, sp.dev_data,
                                           sp.test_data)
    ytr, ydv, yte = sp.train_label, sp.dev_label, sp.test_label
    out = {"corpus_features_s": time.time() - t0, "fits": [], "cpu_threads": 1}

    def configs(name):
        jcfg = getattr(jmlp.MLPConfig, f"speaker_{name}")()
        jcfg = dataclasses.replace(jcfg, dropout=(0.0,) * len(jcfg.dropout))
        cfg = getattr(MLPConfig, f"speaker_{name}")()
        return jcfg, dataclasses.replace(cfg, dropout=(0.0,) * len(cfg.dropout))

    def fit_both(name, epochs):
        jcfg, cfg = configs(name)
        p0, s0 = jax.tree_util.tree_map(
            np.asarray, jmlp.init_mlp(jcfg, jax.random.PRNGKey(args.seed)))
        jkw, pkw = {}, {}
        if name == "constrained":
            jcon = make_simple_norm_constraint(1.0, n_iter=8)
            u0 = jax.tree_util.tree_map(np.asarray, jcon.init(p0))
            jkw = dict(constraint=jcon.apply, constraint_state=u0)
            from asr_using_robust_nn_tpu_torch.constraints import (
                make_simple_norm_constraint as pmake)

            pkw = dict(constraint=pmake(1.0, n_iter=8).apply,
                       constraint_state=cstate_from_numpy(u0, device="cpu"))
        common = dict(batch_size=64, epochs=epochs, patience=epochs,
                      seed=args.seed, device_resident=True,
                      epochs_per_dispatch=1, shuffle=False)
        jt = JTrainer(jcfg, JTrainConfig(**common), **jkw)
        jr = jt.fit(tr, ytr, dv, ydv, params=p0, state=s0)
        pt = Trainer(cfg, TrainConfig(**common, epoch_backend="plain"),
                     device="cpu", **pkw)
        tp, ts = params_from_numpy(p0, s0, device="cpu")
        pr = pt.fit(tr, ytr, dv, ydv, params=tp, state=ts)
        pp, ps = params_to_numpy(pr["params"], pr["state"])
        jl, pl = jr["history"]["loss"], pr["history"]["loss"]
        rng = np.random.default_rng(5)
        moved = jax.tree_util.tree_map(
            lambda a: (a * (1 + 1e-6 * rng.standard_normal(a.shape))).astype(
                np.float32), p0)
        jr2 = JTrainer(jcfg, JTrainConfig(**common), **jkw).fit(
            tr, ytr, dv, ydv, params=moved, state=s0)
        rec = {"recipe": name, "epochs": epochs,
               "max_param_gap": _gap(jr["params"], pp),
               "max_bn_state_gap": _gap(jr["state"], ps),
               "max_loss_gap": float(np.max(np.abs(np.subtract(jl, pl)))),
               "loss_last": [float(jl[-1]), float(pl[-1])],
               "jax_moved_init": {
                   "max_param_gap": _gap(jr["params"], jr2["params"]),
                   "max_bn_state_gap": _gap(jr["state"], jr2["state"]),
                   "max_loss_gap": float(np.max(np.abs(np.subtract(
                       jl, jr2["history"]["loss"]))))}}
        out["fits"].append(rec)
        print(json.dumps(rec), flush=True)
        return jcfg, cfg, jr

    epochs = [int(e) for e in args.epochs.split(",")]
    for e in epochs[:-1]:
        fit_both("constrained", e)
    jcfg_c, cfg_c, jr_c = fit_both("constrained", epochs[-1])
    jcfg_u, cfg_u, jr_u = fit_both("unconstrained", epochs[-1])

    # step 2: the JAX-trained models carried into the port
    from asr_using_robust_nn_tpu.constraints import (
        get_lipschitz_constrained as jlip, get_lipschitz_sound as jsound,
        get_norms as jnorms, get_upper_lipschitz as jupper)

    models, ana = {}, {}
    for name, jcfg, cfg, jr in (("constrained", jcfg_c, cfg_c, jr_c),
                                ("unconstrained", jcfg_u, cfg_u, jr_u)):
        p = jax.tree_util.tree_map(np.asarray, jr["params"])
        s = jax.tree_util.tree_map(np.asarray, jr["state"])
        tp, ts = params_from_numpy(p, s, device="cpu")
        got = _study.analyze(cfg, tp, ts, te, yte, device="cpu")
        lg = np.asarray(jmlp.apply_mlp(jcfg, p, s, jax.numpy.asarray(
            te, jax.numpy.float32), train=False)[0])
        rows = np.arange(len(yte))
        masked = lg.copy()
        masked[rows, yte] = -np.inf
        want = {"lipschitz": float(jlip(jcfg, p, s)),
                "lipschitz_sound": float(jsound(jcfg, p, s)),
                "norms_product": float(jupper(np.asarray(jnorms(p)))),
                "median_margin": float(np.median(lg[rows, yte]
                                                 - masked.max(1)))}
        ana[name] = {k: [got[k], want[k]] for k in want}

        def jlogits(x, jcfg=jcfg, p=p, s=s):
            return jmlp.apply_mlp(jcfg, p, s, x, train=False)[0]

        def jpredict(x, f=jlogits):
            return np.asarray(jax.nn.softmax(f(jax.numpy.asarray(
                x, jax.numpy.float32)), -1))

        models[name] = (_study.model_fns(cfg, tp, ts, "cpu"),
                        (jlogits, jpredict))
    out["analysis"] = ana
    print(json.dumps({"analysis": ana}), flush=True)

    def std(feats):
        return pstd(sp.train_data, sp.dev_data, feats)[2]

    def jstd(feats):
        return standardize_fit_all(sp.train_data, sp.dev_data, feats)[2]

    (plc, ppc), (jlc, jpc) = models["constrained"]
    (plu, ppu), (jlu, jpu) = models["unconstrained"]
    n = len(yte)
    row = 1.0 / n + 1e-9
    out["sweeps"], worst = {}, 0.0
    for atk, strengths in SWEEPS:
        if atk.endswith("_audio"):
            continue
        kw = dict(strengths=list(strengths), seed=args.seed)
        if atk == "fgsm":
            got = whitebox_sweep(atk, plc, plu, ppc, ppu, te, yte,
                                 device="cpu", **kw).as_dict()
            want = jsweeps.whitebox_sweep(atk, jlc, jlu, jpc, jpu, te, yte,
                                          **kw).as_dict()
        else:
            got = blackbox_sweep(atk, ppc, ppu, yte,
                                 test_features=sp.test_data, standardize=std,
                                 device="cpu", **kw).as_dict()
            want = jsweeps.blackbox_sweep(atk, jpc, jpu, yte,
                                          test_features=sp.test_data,
                                          standardize=jstd, **kw).as_dict()
        pts = []
        for side in ("accuracy_constrained", "accuracy_unconstrained"):
            for s_, a, b in zip(want["strengths"], got[side], want[side]):
                if atk == "fgsm":
                    tol = row
                elif s_ == 0:
                    tol = 1e-9
                else:
                    q = (a + b) / 2
                    tol = 4 * np.sqrt(2 * q * (1 - q) / n) + row
                pts.append({"side": side[9:], "strength": float(s_),
                            "port": float(a), "jax": float(b),
                            "tol": float(tol), "ok": bool(abs(a - b) <= tol)})
                worst = max(worst, abs(a - b) / tol)
        out["sweeps"][atk] = pts
        print(f"{atk}: {sum(p['ok'] for p in pts)} of {len(pts)} points "
              f"within", flush=True)
    out["worst_point_over_tol"] = worst
    out["wall_s"] = time.time() - t0
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
