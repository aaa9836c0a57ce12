"""Command line of the PyTorch port, the counterpart of the JAX package's
`asrtpu`:

  python -m asr_using_robust_nn_tpu_torch.cli.main prepare-data \
      --task digit --data-dir data/ --out-dir processed/
  ... train --task digit --variant constrained --data processed/ \
      --constraint simple --rho 0.1 --ckpt runs/digit_c
  ... evaluate --task digit --variant constrained --data processed/ \
      --ckpt runs/digit_c
  ... infer --task digit --variant constrained --ckpt runs/digit_c \
      --data processed/ --audio some_dir/
  ... certify --data processed/ --constrained runs/digit_c \
      --unconstrained runs/digit_u
  ... attack --type fgsm --data processed/ --constrained runs/digit_c \
      --unconstrained runs/digit_u --standardize before
  ... dolphin --voice seven.wav --out attack.wav
  ... train-multi --task digit --variant constrained --data processed/ \
      --ckpt runs/study --seeds 0,1,2,3 --rhos 0.05,0.1
  ... profile --task digit --out traces/

(also `python -m asr_using_robust_nn_tpu_torch ...`). Every subcommand but
`dolphin` (numpy and scipy on the host) runs on `--device` (default `cuda`,
an error where there is none; `--device cpu` for the CPU). A checkpoint is a
store dir written by `train --ckpt` (`best.npz` + `meta.json`,
train/checkpoints.py) or a Keras layout `.h5` (read and written everywhere
by the port's own HDF5 codec, utils/hdf5.py, without h5py). `--plot` needs
matplotlib. Not ported yet: `bench`
(ROADMAP.md queue 1).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from ..frontend.mfcc import Frontend

__all__ = ["main", "model_cfg_for", "load_model"]

_ATTACKS = ("white_mfcc", "mixture_mfcc", "white_audio", "mixture_audio",
            "snr_audio", "fgsm", "pgd", "jsma", "cw_l2", "cw_linf")
_AUDIO_ATTACKS = ("white_audio", "mixture_audio", "snr_audio")
_FRONTENDS = ["auto", *sorted(Frontend._BACKENDS)]


def _add_device(p):
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda, an error where there "
                        "is none; 'cpu' for the CPU)")


def _add_prepare(sub):
    p = sub.add_parser("prepare-data", help="corpus -> .npy artifacts")
    p.add_argument("--task", choices=["digit", "speaker"], required=True)
    p.add_argument("--data-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backend", default="auto", choices=_FRONTENDS,
                   help="frontend backend (frontend/mfcc.py; default auto)")
    _add_device(p)


def _add_train(sub):
    p = sub.add_parser("train", help="train a model variant")
    p.add_argument("--config", default=None,
                   help="JSON config (see configs/) providing defaults for "
                        "the flags below; explicit flags win")
    # merge-relevant flags default to None so that only explicit flags
    # override `--config`; hard defaults resolve in cmd_train after the merge
    p.add_argument("--task", choices=["digit", "speaker"], required=False)
    p.add_argument("--variant", choices=["unconstrained", "constrained"],
                   default=None)
    p.add_argument("--data", required=True,
                   help="artifact dir from prepare-data")
    p.add_argument("--ckpt", required=True, help="checkpoint dir")
    p.add_argument("--constraint",
                   choices=["simple", "norm", "fista", "custom", "none"],
                   default=None,
                   help="projection algorithm for --variant constrained "
                        "(reference known-good: simple)")
    p.add_argument("--rho", type=float, default=None,
                   help="Lipschitz target (defaults: digit 0.1, speaker 1.0)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--patience", type=int, default=None,
                   help="early-stopping patience (reference per-script values "
                        "by default)")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--data-parallel", action="store_true",
                   help="train over the ranks of a process group (launch "
                        "with torchrun, one rank a card; as one process a "
                        "one-rank mesh): every rank trains on its rows of "
                        "each batch, rank 0 alone prints and writes")
    _add_dist_backend(p)
    p.add_argument("--device-resident", action="store_true",
                   help="keep the whole split on the device and run each "
                        "epoch as one program (train/epoch_scan.py, or the "
                        "fused epoch K3)")
    p.add_argument("--epochs-per-dispatch", type=int, default=None,
                   help="device-resident only: E epochs per call (history "
                        "and early stopping move in steps of E)")
    p.add_argument("--epoch-backend", choices=["auto", "plain", "fused"],
                   default=None,
                   help="device-resident epoch: 'fused' = K3, the fused "
                        "epoch (one CUDA graph of hand-written kernels, "
                        "held against the plain epoch once per process); "
                        "'plain' = autograd; 'auto' = fused on a CUDA device "
                        "for a fresh run of the full simple_norm or no "
                        "constraint (default); a refused parity check "
                        "stops the fit under 'fused' and 'auto' alike")
    p.add_argument("--no-standardize", action="store_true")
    p.add_argument("--log-every", type=int, default=None)
    p.add_argument("--monitor-lipschitz", action="store_true")
    p.add_argument("--export-h5", default=None,
                   help="also export the best weights to a Keras layout "
                        ".h5")
    p.add_argument("--resume", action="store_true",
                   help="start from the best checkpoint already in --ckpt, "
                        "continuing its Adam state and best val_loss")
    p.add_argument("--metrics-dir", default=None,
                   help="write per-epoch scalars here (metrics.jsonl, and "
                        "TensorBoard events where it imports)")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 operands in every Dense GEMM, fp32 sums and "
                        "master weights (models/mlp.py MLPConfig.with_bf16)")
    _add_device(p)


def _add_train_multi(sub):
    p = sub.add_parser(
        "train-multi",
        help="train a seeds x rhos grid of runs on one device-resident split "
             "(train/multi_run.py: the plain backend trains the runs as one "
             "batched program, the fused one replays K3 per run)")
    p.add_argument("--task", choices=["digit", "speaker"], required=True)
    p.add_argument("--variant", choices=["unconstrained", "constrained"],
                   default="unconstrained")
    p.add_argument("--data", required=True,
                   help="artifact dir from prepare-data")
    p.add_argument("--ckpt", required=True,
                   help="checkpoint root; run r saves under "
                        "<ckpt>/run<r>_seed<s>[_rho<rho>]/")
    p.add_argument("--seeds", required=True,
                   help="comma-separated seed list, one training run each")
    p.add_argument("--rhos", default=None,
                   help="comma-separated Lipschitz targets; forms the full "
                        "seeds x rhos grid (constrained only)")
    p.add_argument("--constraint",
                   choices=["simple", "norm", "fista", "custom", "none"],
                   default="simple")
    p.add_argument("--epochs", type=int, default=10000)
    p.add_argument("--patience", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--epochs-per-dispatch", type=int, default=8,
                   help="epochs a call (early-stopping granularity)")
    p.add_argument("--epoch-backend", choices=["plain", "fused"],
                   default="plain",
                   help="'plain' = the runs as one batched autograd program "
                        "(any constraint); 'fused' = K3 a run (no constraint "
                        "or the full simple_norm at one rho); dropout draws "
                        "differ between them, so keep one backend across a "
                        "merged study")
    p.add_argument("--runs-mesh", action="store_true",
                   help="split the runs over the ranks of a process group "
                        "(launch with torchrun; plain backend): each rank "
                        "trains its share, rank 0 alone prints and writes")
    _add_dist_backend(p)
    p.add_argument("--no-standardize", action="store_true")
    p.add_argument("--bf16", action="store_true")
    _add_device(p)


def _add_dist_backend(p):
    p.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                   help="the process group's backend under torchrun "
                        "(default: nccl on a CUDA device, one card a rank; "
                        "gloo on the CPU). gloo also runs ranks that share "
                        "one card")


def _add_profile(sub):
    p = sub.add_parser(
        "profile",
        help="torch.profiler trace of the training step and the frontend on "
             "synthetic data (trace.json: Perfetto or chrome://tracing)")
    p.add_argument("--task", choices=["digit", "speaker"], default="digit")
    p.add_argument("--variant", choices=["unconstrained", "constrained"],
                   default="constrained")
    p.add_argument("--out", required=True, help="trace output directory")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=512)
    _add_device(p)


def _add_certify(sub):
    p = sub.add_parser(
        "certify",
        help="certified-accuracy curves from the sound Lipschitz bound "
             "(constraints/certify.py): a provable lower bound on accuracy "
             "under any attack in the norm ball")
    p.add_argument("--task", choices=["digit", "speaker"], default="digit")
    p.add_argument("--data", required=True)
    p.add_argument("--constrained", required=True, help="ckpt dir or .h5")
    p.add_argument("--unconstrained", required=True, help="ckpt dir or .h5")
    p.add_argument("--norm", choices=["l2", "linf"], default="l2",
                   help="perturbation ball; linf uses the sqrt(d) "
                        "containment")
    p.add_argument("--strengths", default=None,
                   help="comma-separated eps grid (default: the fgsm "
                        "standardized grid for linf, 10 points to the "
                        "90th-percentile certified radius for l2)")
    p.add_argument("--out", default=None, help="write curves JSON here")
    p.add_argument("--plot", default=None, help="write comparison plot PNG")
    _add_device(p)


def _add_attack(sub):
    p = sub.add_parser("attack", help="robustness sweep on a model pair")
    p.add_argument("--type", required=True, choices=_ATTACKS)
    p.add_argument("--task", choices=["digit", "speaker"], default="digit")
    p.add_argument("--data", required=True)
    p.add_argument("--constrained", required=True, help="ckpt dir or .h5")
    p.add_argument("--unconstrained", required=True, help="ckpt dir or .h5")
    p.add_argument("--standardize", choices=["before", "after"],
                   default="before",
                   help="standardize data before or after the attack "
                        "(attacks.py:325)")
    p.add_argument("--strengths", default=None,
                   help="comma-separated override of the sweep grid")
    p.add_argument("--out", default=None, help="write curves JSON here")
    p.add_argument("--plot", default=None,
                   help="write comparison plot PNG here (needs matplotlib)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-samples", type=int, default=None)
    _add_device(p)


def _add_dolphin(sub):
    p = sub.add_parser("dolphin", help="generate ultrasound attack WAV")
    p.add_argument("--voice", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--carrier-khz", type=float, default=30.0)


def _add_infer(sub):
    p = sub.add_parser(
        "infer",
        help="classify WAV files end to end (decode -> MFCC (K1 on the "
             "card) -> standardize -> predict, padded to a bucket ladder; "
             "serve/engine.py)")
    p.add_argument("--task", choices=["digit", "speaker"], default="digit")
    p.add_argument("--variant", choices=["unconstrained", "constrained"],
                   default="unconstrained")
    p.add_argument("--ckpt", required=True,
                   help="checkpoint store dir (train --ckpt) or Keras .h5")
    p.add_argument("--data", default=None,
                   help="prepare-data artifact dir, used to re-derive the "
                        "train-time scaler moments (required unless "
                        "--no-standardize)")
    p.add_argument("--no-standardize", action="store_true")
    p.add_argument("--audio", required=True, nargs="+",
                   help="WAV file(s) and/or directories of WAVs")
    p.add_argument("--agg", choices=["none", "vote", "mean"], default=None,
                   help="long-recording aggregation: slice into 1-s windows "
                        "and majority-vote or mean-probability per file; "
                        "default vote for --task speaker, none for digit")
    p.add_argument("--warmup", action="store_true",
                   help="run every padding bucket once first and report "
                        "warm serving latency percentiles")
    p.add_argument("--buckets", default=None,
                   help="comma-separated ascending batch-padding ladder "
                        "(default 16,64,256,1024)")
    p.add_argument("--backend", default="auto", choices=_FRONTENDS,
                   help="frontend backend (frontend/mfcc.py; default auto: "
                        "K1 on the card)")
    _add_device(p)


def _add_eval(sub):
    p = sub.add_parser("evaluate", help="clean test eval + confusion matrix")
    p.add_argument("--task", choices=["digit", "speaker"], default="digit")
    p.add_argument("--data", required=True)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--variant", choices=["unconstrained", "constrained"],
                   default="unconstrained")
    p.add_argument("--no-standardize", action="store_true")
    p.add_argument("--plot", default=None,
                   help="write a confusion-matrix heatmap PNG")
    _add_device(p)


def model_cfg_for(task: str, variant: str):
    from ..models.mlp import MLPConfig

    return {
        ("digit", "unconstrained"): MLPConfig.digit_unconstrained,
        ("digit", "constrained"): MLPConfig.digit_constrained,
        ("speaker", "unconstrained"): MLPConfig.speaker_unconstrained,
        ("speaker", "constrained"): MLPConfig.speaker_constrained,
    }[(task, variant)]()


def load_model(path, cfg):
    """(params, state) as numpy trees from a checkpoint store dir or a
    Keras-layout .h5 (`serve/engine.py::load_checkpoint`); a missing or
    mismatched checkpoint exits with its message."""
    from ..serve.engine import load_checkpoint

    try:
        return load_checkpoint(path, cfg)
    except (ValueError, RuntimeError) as e:
        raise SystemExit(f"error: {e}")


def _need_artifacts(data) -> bool:
    if os.path.exists(os.path.join(data, "train_data.npy")):
        return True
    print(f"error: {data!r} has no train_data.npy — run `prepare-data` "
          f"first", file=sys.stderr)
    return False


def cmd_prepare(args):
    from ..data.corpus import DIGIT_WORDS, walk_corpus
    from ..data.pipeline import build_dataset

    if not os.path.isdir(args.data_dir):
        print(f"error: --data-dir {args.data_dir!r} does not exist",
              file=sys.stderr)
        return 2
    # check the corpus yields files before build_dataset writes anything:
    # an empty run would leave zero-row .npy artifacts in --out-dir that a
    # later training run accepts and then fails on with an opaque error
    class_names = DIGIT_WORDS if args.task == "digit" else None
    filenames, _, _ = walk_corpus(args.data_dir, class_names)
    if len(filenames) == 0:
        print(f"error: no audio found under {args.data_dir!r} "
              f"(expected <dir>/<class>/*.wav)", file=sys.stderr)
        return 2
    splits = build_dataset(args.data_dir, args.task, out_dir=args.out_dir,
                           seed=args.seed, backend=args.backend,
                           device=args.device)
    print(json.dumps({
        "train": list(splits.train_data.shape),
        "dev": list(splits.dev_data.shape),
        "test": list(splits.test_data.shape),
        "out_dir": args.out_dir,
    }))
    return 0


# reference per-script defaults (batch size, early-stopping patience)
_REF_DEFAULTS = {
    ("digit", "unconstrained"): dict(batch=256, patience=200),
    ("digit", "constrained"): dict(batch=512, patience=6000),
    ("speaker", "unconstrained"): dict(batch=64, patience=10),
    ("speaker", "constrained"): dict(batch=64, patience=2000),
}
_REF_RHO = {"digit": 0.1, "speaker": 1.0}

_TRAIN_CONF_KEYS = {
    "task": ("digit", "speaker"),
    "variant": ("unconstrained", "constrained"),
    "constraint": ("simple", "norm", "fista", "custom", "none"),
    "rho": None, "epochs": None, "patience": None, "batch_size": None,
    "seed": None, "log_every": None, "data_parallel": None,
    "device_resident": None, "monitor_lipschitz": None,
    "no_standardize": None, "epochs_per_dispatch": None, "bf16": None,
    "epoch_backend": ("auto", "plain", "fused"),
}


def _merge_config(args) -> int:
    """Fill unset flags from `--config`; -> 0, or 2 after printing why the
    config was refused."""
    with open(args.config) as f:
        conf = {k.replace("-", "_"): v for k, v in json.load(f).items()
                if not k.startswith("_")}
    unknown = set(conf) - set(_TRAIN_CONF_KEYS)
    if unknown:
        print(f"error: unknown config keys {sorted(unknown)} in "
              f"{args.config!r} (known: {sorted(_TRAIN_CONF_KEYS)})",
              file=sys.stderr)
        return 2
    for k, v in conf.items():
        allowed = _TRAIN_CONF_KEYS[k]
        if allowed is not None and v not in allowed:
            print(f"error: config {k}={v!r} not in {allowed}",
                  file=sys.stderr)
            return 2
        # explicit flags win; the config fills None sentinels and False
        # store_true flags. Identity checks, not ==: 0 == False, and an
        # explicit --seed 0 must not be replaced by the config's.
        cur = getattr(args, k, None)
        if cur is None or cur is False:
            setattr(args, k, v)
    return 0


def cmd_train(args):
    if args.config and _merge_config(args):
        return 2
    if not args.task:
        print("error: --task required (or provide it via --config)",
              file=sys.stderr)
        return 2
    for k, v in (("variant", "unconstrained"), ("constraint", "simple"),
                 ("epochs", 10000), ("seed", 0), ("log_every", 1),
                 ("epoch_backend", "auto")):
        if getattr(args, k) is None:
            setattr(args, k, v)
    return _in_process_group(args.data_parallel, args,
                             lambda mesh: _train(args, mesh))


def _in_process_group(wanted: bool, args, fn):
    """-> fn(mesh): with `wanted`, inside the process group the launcher's
    environment names (`torchrun` sets it; none: a one-rank mesh) on a
    'data' mesh of its ranks, the group closed after; else fn(None)."""
    if not wanted:
        return fn(None)
    import torch.distributed as dist

    from ..parallel.mesh import data_mesh, maybe_init_distributed

    started = maybe_init_distributed(backend=args.dist_backend,
                                     device=args.device)
    try:
        return fn(data_mesh())
    finally:
        if started:
            dist.destroy_process_group()


def _train(args, mesh):
    import torch

    from ..constraints import (lipschitz_monitor, make_custom_constraint,
                               make_fista_constraint, make_norm_constraint,
                               make_simple_norm_constraint)
    from ..data.pipeline import load_artifacts, standardize_fit_all
    from ..models.convert import adam_state_from_numpy, params_from_numpy
    from ..models.mlp import init_mlp
    from ..train.checkpoints import (CheckpointManager, export_h5,
                                     validate_model_tree)
    from ..train.trainer import FusedEpochRefused, TrainConfig, Trainer
    from ..utils.device import resolve_device

    if not _need_artifacts(args.data):
        return 2
    store = os.path.join(args.ckpt, "best.npz")
    if args.resume and not os.path.exists(store):
        # an explicit resume that cannot be honored must not fall through
        # to a from-scratch run
        print(f"error: --resume requested but {args.ckpt!r} has no "
              f"'best.npz' checkpoint (wrong --ckpt, or nothing saved yet?)",
              file=sys.stderr)
        return 2
    dev = resolve_device(args.device)
    d = load_artifacts(args.data)
    if args.no_standardize:
        tr, dv, te = d.train_data, d.dev_data, d.test_data
    else:
        tr, dv, te, _, _ = standardize_fit_all(d.train_data, d.dev_data,
                                               d.test_data)

    cfg = model_cfg_for(args.task, args.variant)
    if args.bf16:
        cfg = cfg.with_bf16()
    defaults = _REF_DEFAULTS[(args.task, args.variant)]
    batch = args.batch_size or defaults["batch"]
    patience = (args.patience if args.patience is not None
                else defaults["patience"])

    constraint = cstate = None
    if args.variant == "constrained" and args.constraint != "none":
        rho = args.rho if args.rho is not None else _REF_RHO[args.task]
        con = {
            "simple": lambda: make_simple_norm_constraint(rho),
            "norm": lambda: make_norm_constraint(rho),
            "fista": lambda: make_fista_constraint(rho, nit=2),
            "custom": lambda: make_custom_constraint(rho),
        }[args.constraint]()
        # every constraint's state depends on the kernels' shapes only
        p0, _ = init_mlp(cfg, torch.Generator(device=dev).manual_seed(
            args.seed), device=dev)
        constraint, cstate = con.apply, con.init(p0)

    tcfg = TrainConfig(batch_size=batch, epochs=args.epochs,
                       patience=patience, seed=args.seed,
                       log_every=args.log_every,
                       device_resident=bool(args.device_resident),
                       epochs_per_dispatch=args.epochs_per_dispatch or 1,
                       epoch_backend=args.epoch_backend)
    callbacks = (lipschitz_monitor(cfg),) if args.monitor_lipschitz else ()
    kw = dict(constraint=constraint, constraint_state=cstate,
              epoch_callbacks=callbacks, device=dev)
    if args.data_parallel:
        from ..parallel import DataParallelTrainer

        trainer = DataParallelTrainer(cfg, mesh, tcfg, **kw)
    else:
        trainer = Trainer(cfg, tcfg, **kw)
    say = print if trainer.writes_files else (lambda *a, **k: None)
    init_params = init_state = init_opt = best0 = None
    if args.resume:
        tree, meta = CheckpointManager(args.ckpt).load_best()
        try:
            validate_model_tree(tree["params"], tree["state"], cfg)
        except ValueError as e:
            raise SystemExit(f"error: --resume checkpoint mismatch: {e}")
        init_params, init_state = params_from_numpy(tree["params"],
                                                    tree["state"], dev)
        # continue the Adam trajectory, and seed best-val tracking with the
        # stored val_loss so a worse resumed epoch cannot replace the best
        o = tree["opt_state"]
        init_opt = adam_state_from_numpy(
            o["count"], o["mu"], o["nu"], device=dev,
            moments_dtype=trainer.optimizer.moments_dtype)
        best0 = meta.get("val_loss")
        say(f"resumed from {args.ckpt} (epoch {meta.get('epoch')}, "
            f"val_loss {best0})")
    try:
        res = trainer.fit(tr, d.train_label, dv, d.dev_label,
                          params=init_params, state=init_state,
                          opt_state=init_opt, initial_best_val=best0,
                          checkpoint_dir=args.ckpt,
                          metrics_dir=args.metrics_dir)
    except FusedEpochRefused as e:
        # the verdict, for scripts, on the JSON line a fit would print
        print(f"error: {e}", file=sys.stderr)
        if trainer.writes_files:
            print(json.dumps({"epoch_backend": None,
                              "epoch_gate_why": e.gate["why"],
                              "ckpt": args.ckpt}))
        return 1
    say(f"epoch backend: {res['epoch_backend']}")
    test_loss, test_acc = trainer.evaluate(
        *params_from_numpy(res["best_params"], res["best_state"], dev),
        te, d.test_label)
    if not trainer.writes_files:
        return 0
    print(f"Test loss: {test_loss} / Test accuracy: {test_acc}")
    if args.export_h5:
        export_h5(args.export_h5, res["best_params"], res["best_state"])
    print(json.dumps({
        "epochs_run": res["epochs_run"],
        "best_val_loss": res["best_val_loss"],
        "test_loss": test_loss,
        "test_accuracy": test_acc,
        "examples_per_sec": res["examples_per_sec"],
        "epoch_backend": res["epoch_backend"],
        "epoch_gate_why": None,
        "fit_seconds": res["seconds"],
        "checkpoint_writes": res["checkpoint_writes"],
        "checkpoint_seconds": res["checkpoint_seconds"],
        "ckpt": args.ckpt,
    }))
    return 0


def cmd_train_multi(args):
    try:
        seeds = [int(v) for v in args.seeds.split(",") if v.strip()]
    except ValueError:
        print(f"error: --seeds must be comma-separated ints, got "
              f"{args.seeds!r}", file=sys.stderr)
        return 2
    if not seeds:
        print("error: --seeds is empty", file=sys.stderr)
        return 2
    rhos = None
    if args.rhos is not None:
        try:
            rhos = [float(r) for r in args.rhos.split(",") if r.strip()]
        except ValueError:
            print(f"error: --rhos must be comma-separated floats, got "
                  f"{args.rhos!r}", file=sys.stderr)
            return 2
        if args.variant != "constrained" or args.constraint == "none":
            print("error: --rhos needs --variant constrained and a "
                  "--constraint algorithm", file=sys.stderr)
            return 2
    if args.runs_mesh and args.epoch_backend == "fused":
        print("error: --runs-mesh runs the plain backend (the fused epoch "
              "is single-device); use --epoch-backend plain",
              file=sys.stderr)
        return 2
    if not _need_artifacts(args.data):
        return 2
    return _in_process_group(
        args.runs_mesh, args,
        lambda mesh: _train_multi(args, seeds, rhos, mesh))


def _train_multi(args, seeds, rhos, mesh):
    import torch

    from ..constraints import (make_custom_constraint, make_fista_constraint,
                               make_norm_constraint,
                               make_simple_norm_constraint)
    from ..data.pipeline import load_artifacts, standardize_fit_all
    from ..parallel.mesh import pad_to_multiple
    from ..train.checkpoints import CheckpointManager
    from ..train.multi_run import build_multi_run_eval_fn, fit_multi_run
    from ..train.trainer import TrainConfig, _tree_map
    from ..utils.device import resolve_device

    d = load_artifacts(args.data)
    if args.no_standardize:
        tr, dv, te = d.train_data, d.dev_data, d.test_data
    else:
        tr, dv, te, _, _ = standardize_fit_all(d.train_data, d.dev_data,
                                               d.test_data)
    cfg = model_cfg_for(args.task, args.variant)
    if args.bf16:
        cfg = cfg.with_bf16()
    defaults = _REF_DEFAULTS[(args.task, args.variant)]
    tcfg = TrainConfig(
        batch_size=args.batch_size or defaults["batch"], epochs=args.epochs,
        patience=(args.patience if args.patience is not None
                  else defaults["patience"]),
        device_resident=True, epochs_per_dispatch=args.epochs_per_dispatch)

    kw = {}
    if args.variant == "constrained" and args.constraint != "none":
        factory = {
            "simple": make_simple_norm_constraint,
            "norm": make_norm_constraint,
            "fista": lambda rho: make_fista_constraint(rho, nit=2),
            "custom": make_custom_constraint,
        }[args.constraint]
        rhos = rhos or [_REF_RHO[args.task]]
        # the full seeds x rhos grid, paired elementwise for fit_multi_run
        grid = [(s, r) for s in seeds for r in rhos]
        if len(set(rhos)) == 1:
            # one rho: a fixed constraint (the same projection every run),
            # which the fused backend takes when it is the full simple_norm
            con = factory(rhos[0])
            kw = dict(constraint=con.apply, constraint_init=con.init)
        else:
            kw = dict(constraint_factory=factory, rhos=[r for _, r in grid])
    else:
        grid = [(s, None) for s in seeds]
    if args.epoch_backend == "fused" and (
            "constraint_factory" in kw
            or (kw and args.constraint != "simple")):
        print("error: --epoch-backend fused takes no constraint or "
              "--constraint simple at one rho (the fused epoch's "
              "configurations); use --epoch-backend plain", file=sys.stderr)
        return 2
    if mesh is not None and len(grid) % mesh.size:
        print(f"error: --runs-mesh needs the run count ({len(grid)}) to "
              f"divide across {mesh.size} devices — adjust --seeds/--rhos",
              file=sys.stderr)
        return 2
    dev = resolve_device(args.device)
    res = fit_multi_run(cfg, tcfg, tr, d.train_label, dv, d.dev_label,
                        [s for s, _ in grid], epoch_backend=args.epoch_backend,
                        mesh=mesh, device=dev, **kw)
    if mesh is not None and mesh.rank != 0:
        return 0  # rank 0 evaluates, writes the stores and prints

    # one test evaluation of every run's best snapshot, then a store a run
    vb = 1024 if len(te) >= 1024 else max(8, len(te))
    te_p, _ = pad_to_multiple(np.asarray(te, np.float32), vb)
    tl_p, _ = pad_to_multiple(np.asarray(d.test_label, np.int64), vb)
    on_dev = lambda t: t.to(dev)  # noqa: E731
    t_loss, t_acc = build_multi_run_eval_fn(cfg, batch_size=vb)(
        _tree_map(on_dev, res["best_params"]),
        _tree_map(on_dev, res["best_state"]),
        torch.from_numpy(te_p).to(dev), torch.from_numpy(tl_p).to(dev),
        len(te))
    t_loss, t_acc = t_loss.cpu().numpy(), t_acc.cpu().numpy()
    take = lambda tree, r: _tree_map(lambda t: t[r], tree)  # noqa: E731
    runs = []
    for r, (seed, rho) in enumerate(grid):
        sub = (f"run{r}_seed{seed}" if rho is None
               else f"run{r}_seed{seed}_rho{rho:g}")
        ck_dir = os.path.join(args.ckpt, sub)
        CheckpointManager(ck_dir).save_best(
            take(res["best_params"], r), take(res["best_state"], r),
            take(res["best_opt_state"], r),
            epoch=int(res["best_epoch"][r]),
            val_loss=float(res["best_val_loss"][r]))
        runs.append({
            "seed": seed, "rho": rho,
            "best_val_loss": float(res["best_val_loss"][r]),
            "epochs_run": int(res["epochs_run"][r]),
            "test_loss": float(t_loss[r]),
            "test_accuracy": float(t_acc[r]),
            "ckpt": ck_dir,
        })
        print(f"run {r} seed={seed} rho={rho}: val_loss="
              f"{res['best_val_loss'][r]:.4f} test_acc={t_acc[r]:.4f} "
              f"({res['epochs_run'][r]} epochs) -> {ck_dir}")
    print(json.dumps({"runs": runs, "n_runs": len(grid),
                      "fused_dispatches": len(res["history"]["val_loss"])}))
    return 0


def cmd_profile(args):
    """A synthetic-data trace of the training step and the frontend
    (`utils/profiling.py::trace`): one warm-up step outside the trace, then
    `--steps` `Trainer.train_step`s and one `Frontend` call on 128
    one-second waves inside it."""
    if args.steps < 1:
        print("error: --steps must be >= 1", file=sys.stderr)
        return 2
    import torch

    from ..constraints import make_simple_norm_constraint
    from ..models.mlp import init_mlp
    from ..ops.mfcc_torch import FrontendConfig
    from ..train.trainer import Trainer, TrainConfig, _tree_map
    from ..utils.device import resolve_device
    from ..utils.profiling import trace

    dev = resolve_device(args.device)
    cfg = model_cfg_for(args.task, args.variant)
    fe_cfg = getattr(FrontendConfig, args.task)()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (args.batch_size, cfg.in_dim)).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, cfg.n_classes, args.batch_size)
                         .astype(np.int64)).to(dev)
    waves = (rng.standard_normal((128, fe_cfg.sr)) * 0.1).astype(np.float32)

    kw = {}
    params, state = init_mlp(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    if args.variant == "constrained":
        con = make_simple_norm_constraint(_REF_RHO[args.task], n_iter=4)
        kw = dict(constraint=con.apply, constraint_state=con.init(params))
    trainer = Trainer(cfg, TrainConfig(batch_size=args.batch_size),
                      device=dev, **kw)
    fe = Frontend(fe_cfg, device=dev)
    opt_state = trainer.optimizer.init(params)
    cstate = _tree_map(lambda t: t.clone(), kw.get("constraint_state"))
    gen = torch.Generator(device=dev).manual_seed(1)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    # warm up outside the trace, so that it shows the steady state
    params, state, opt_state, cstate, loss, _ = trainer.train_step(
        params, state, opt_state, cstate, x, y, gen)
    fe(waves)
    sync()
    with trace(args.out):
        for _ in range(args.steps):
            params, state, opt_state, cstate, loss, _ = trainer.train_step(
                params, state, opt_state, cstate, x, y, gen)
        fe(waves)
        sync()
    print(json.dumps({"trace_dir": args.out, "steps": args.steps,
                      "final_loss": float(loss)}))
    return 0


def cmd_evaluate(args):
    from ..data.pipeline import load_artifacts, standardize_fit_all
    from ..models.convert import params_from_numpy
    from ..train.trainer import FusedEpochRefused, TrainConfig, Trainer
    from ..utils.device import resolve_device

    if not _need_artifacts(args.data):
        return 2
    d = load_artifacts(args.data)
    if args.no_standardize:
        te = d.test_data
    else:
        _, _, te, _, _ = standardize_fit_all(d.train_data, d.dev_data,
                                             d.test_data)
    cfg = model_cfg_for(args.task, args.variant)
    dev = resolve_device(args.device)
    params, state = params_from_numpy(*load_model(args.ckpt, cfg), dev)
    trainer = Trainer(cfg, TrainConfig(batch_size=256), device=dev)
    loss, acc = trainer.evaluate(params, state, te, d.test_label)
    pred = np.argmax(trainer.predict(params, state, te), axis=1)
    n = cfg.n_classes
    conf = np.zeros((n, n), dtype=np.int64)
    np.add.at(conf, (np.asarray(d.test_label, dtype=int), pred), 1)
    print(f"Test loss: {loss} / Test accuracy: {acc}")
    print(conf)
    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        im = ax.imshow(conf, cmap="viridis")
        fig.colorbar(im)
        ax.set_title("Confusion Matrix")
        ax.set_xlabel("predicted")
        ax.set_ylabel("true")
        fig.savefig(args.plot, dpi=120)
    print(json.dumps({"test_loss": loss, "test_accuracy": acc,
                      "confusion_matrix": conf.tolist()}))
    return 0


def cmd_infer(args):
    from ..serve.engine import InferenceEngine

    kw = {"backend": args.backend}
    if args.buckets is not None:
        try:
            kw["buckets"] = tuple(int(b) for b in args.buckets.split(","))
        except ValueError:
            print(f"error: --buckets must be comma-separated ints, got "
                  f"{args.buckets!r}", file=sys.stderr)
            return 2
    standardize = not args.no_standardize
    if standardize and args.data is None:
        print("error: --data (the training artifact dir) is required to "
              "re-derive the scaler; pass --no-standardize for models "
              "trained on raw features", file=sys.stderr)
        return 2
    paths = []
    for a in args.audio:
        if os.path.isdir(a):
            found = sorted(os.path.join(a, f) for f in os.listdir(a)
                           if f.lower().endswith(".wav"))
            if not found:
                print(f"error: no .wav files under {a!r}", file=sys.stderr)
                return 2
            paths.extend(found)
        elif os.path.exists(a):
            paths.append(a)
        else:
            print(f"error: {a!r} is neither a WAV file nor a directory",
                  file=sys.stderr)
            return 2
    try:
        engine = InferenceEngine.from_checkpoint(
            args.task, args.variant, args.ckpt, artifacts_dir=args.data,
            standardize=standardize, device=args.device, **kw)
    except (ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    agg = args.agg if args.agg is not None else (
        "vote" if args.task == "speaker" else "none")
    if args.warmup:
        engine.warmup()
    results = engine.classify_files(paths, agg=None if agg == "none" else agg)
    out = []
    for r in results:
        rec = {"path": r["path"],
               "label": None if r["label"] is None else int(r["label"])}
        if "n_windows" in r:
            rec["n_windows"] = r["n_windows"]
            rec["window_labels"] = [int(v) for v in r["window_labels"]]
        if r["label"] is not None:
            p = r["probs"]
            rec["confidence"] = float(
                p.mean(axis=0)[r["label"]] if p.ndim == 2 else p[r["label"]])
        print(f"{rec['path']}: label={rec['label']}"
              + (f" windows={rec['n_windows']}" if "n_windows" in rec
                 else ""))
        out.append(rec)
    print(json.dumps({
        "results": out, "n_files": len(out), "task": args.task,
        "variant": args.variant, "aggregation": agg,
        "frontend_backend": engine._fe.backend,
        "latency": engine.latency_stats(),
    }))
    return 0


def cmd_certify(args):
    from ..constraints.certify import certified_radii, certify_sweep
    from ..data.pipeline import load_artifacts, standardize_fit_all

    if not _need_artifacts(args.data):
        return 2
    d = load_artifacts(args.data)
    cfg_c = model_cfg_for(args.task, "constrained")
    cfg_u = model_cfg_for(args.task, "unconstrained")
    pc, sc = load_model(args.constrained, cfg_c)
    pu, su = load_model(args.unconstrained, cfg_u)
    # the certificate lives in the space the model consumes: standardized
    # features
    _, _, te, _, _ = standardize_fit_all(d.train_data, d.dev_data,
                                         d.test_data)
    if args.strengths:
        eps = [float(s) for s in args.strengths.split(",")]
    elif args.norm == "linf":
        from ..attacks.sweeps import GRIDS

        eps = [0.0] + list(GRIDS["fgsm_eps_std"])
    else:
        # scale the grid to where the certificates live, for both models, so
        # a degenerate one cannot collapse it
        tops = []
        for cfg_m, pm, sm in ((cfg_c, pc, sc), (cfg_u, pu, su)):
            rm, cm, _ = certified_radii(cfg_m, pm, sm, te, d.test_label,
                                        device=args.device)
            if cm.any():
                tops.append(float(np.percentile(rm[cm], 90)))
        eps = list(np.linspace(0.0, max(tops + [1e-6]), 10))
    res = certify_sweep(cfg_c, pc, sc, cfg_u, pu, su, te, d.test_label, eps,
                        norm=args.norm, device=args.device)
    for s, ac, au in zip(res.strengths, res.certified_constrained,
                         res.certified_unconstrained):
        print(f"eps={s:.6g}: certified constrained={ac * 100:.2f}% "
              f"unconstrained={au * 100:.2f}%")
    _write_curves(args, res)
    return 0


def _write_curves(args, res):
    """Print the curves, write --out / --plot, print the JSON line."""
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res.as_dict(), f, indent=2)
    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        ax = res.plot()
        ax.figure.savefig(args.plot, dpi=120)
    print(json.dumps(res.as_dict()))


def _pad_seconds(waves_list, sr):
    """Variable-length waves -> (B, whole seconds) zero-padded float32 and
    the true lengths."""
    cap = -(-max(len(w) for w in waves_list) // sr) * sr
    waves = np.zeros((len(waves_list), cap), np.float32)
    lengths = np.zeros((len(waves_list),), np.int64)
    for i, w in enumerate(waves_list):
        waves[i, :len(w)] = w
        lengths[i] = len(w)
    return waves, lengths


def cmd_attack(args):
    import torch

    from ..attacks.sweeps import (GRIDS, blackbox_sweep, fused_audio_sweep,
                                  whitebox_sweep)
    from ..data.pipeline import load_artifacts, standardize_fit_all
    from ..models.convert import params_from_numpy
    from ..models.mlp import apply_mlp
    from ..ops.mfcc_torch import FrontendConfig
    from ..utils import native
    from ..utils.device import resolve_device

    if not _need_artifacts(args.data):
        return 2
    d = load_artifacts(args.data)
    audio = args.type in _AUDIO_ATTACKS
    if audio and d.test_filenames is None:
        print("error: artifact dir has no test_dataset_to_add_noise/",
              file=sys.stderr)
        return 2
    dev = resolve_device(args.device)
    cfg_c = model_cfg_for(args.task, "constrained")
    cfg_u = model_cfg_for(args.task, "unconstrained")
    pc, sc = params_from_numpy(*load_model(args.constrained, cfg_c), dev)
    pu, su = params_from_numpy(*load_model(args.unconstrained, cfg_u), dev)

    std_before = args.standardize == "before"
    # the reference's standardize_dataset refits the scaler per sweep point
    # on [train; val; perturbed test] (`attacks.py:341-343,437-438`); with
    # standardize-before, train and val are already standardized when that
    # refit happens (`:327`, then `:342`). Both are replicated.
    tr_cur, dv_cur, te_cur = d.train_data, d.dev_data, d.test_data
    if std_before:
        tr_cur, dv_cur, te_cur, _, _ = standardize_fit_all(tr_cur, dv_cur,
                                                           te_cur)

    def std(feats):
        return standardize_fit_all(tr_cur, dv_cur, feats)[2]

    def logits_c(x):
        return apply_mlp(cfg_c, pc, sc, x, train=False)[0]

    def logits_u(x):
        return apply_mlp(cfg_u, pu, su, x, train=False)[0]

    def predictor(logits_fn):
        @torch.no_grad()
        def predict(x):
            x = torch.as_tensor(np.asarray(x, np.float32), device=dev)
            return torch.softmax(logits_fn(x), -1).cpu().numpy()
        return predict

    predict_c, predict_u = predictor(logits_c), predictor(logits_u)
    strengths = None
    if args.strengths:
        strengths = [float(s) for s in args.strengths.split(",")]
    elif args.task == "speaker" and audio:
        # `Speaker recognition/attacks.py:319-322,336`
        strengths = list(GRIDS[{"snr_audio": "snrs_db_speaker",
                                "mixture_audio": "audio_alphas_speaker",
                                "white_audio": "audio_sigmas_speaker",
                                }[args.type]])
    elif args.type == "fgsm" and not std_before:
        # attacks on raw dB-scale MFCCs take eps linspace(1, 30, 50)
        # (`Voice digit recogniton/attacks.py:497-499`)
        strengths = list(GRIDS["fgsm_eps_raw"])

    common = dict(strengths=strengths, seed=args.seed, device=dev)
    if audio:
        fe_cfg = getattr(FrontendConfig, args.task)()
        waves_list = native.decode_resample_batch(list(d.test_filenames),
                                                  fe_cfg.sr)
        if args.task == "speaker":
            # noise the full recording -> 1-s windows -> MFCC (K1)
            res = blackbox_sweep(
                args.type, predict_c, predict_u, d.test_audio_label,
                test_waves_list=waves_list, frontend_cfg=fe_cfg,
                standardize=std, **common)
        else:
            # per point noise -> MFCC (K1) -> refit -> both models on the
            # device; two accuracies per point reach the host
            waves, lengths = _pad_seconds(waves_list, fe_cfg.sr)
            res = fused_audio_sweep(
                args.type, logits_c, logits_u, d.test_audio_label,
                test_waves=waves, lengths=lengths, frontend_cfg=fe_cfg,
                refit_arrays=(tr_cur, dv_cur), **common)
    elif args.type in ("white_mfcc", "mixture_mfcc"):
        res = blackbox_sweep(
            args.type, predict_c, predict_u, d.test_label,
            test_features=te_cur, standardize=None if std_before else std,
            **common)
    else:
        res = whitebox_sweep(
            args.type, logits_c, logits_u, predict_c, predict_u, te_cur,
            d.test_label, standardize=None if std_before else std,
            max_samples=args.max_samples, **common)
    for s, ac, au in zip(res.strengths, res.accuracy_constrained,
                         res.accuracy_unconstrained):
        print(f"strength={s}: constrained={ac * 100:.2f}% "
              f"unconstrained={au * 100:.2f}%")
    _write_curves(args, res)
    return 0


def cmd_dolphin(args):
    from ..attacks.dolphin import generate_dolphin_wav

    if not os.path.isfile(args.voice):
        print(f"error: --voice {args.voice!r} is not a file",
              file=sys.stderr)
        return 2
    out = generate_dolphin_wav(args.voice, args.out,
                               carrier_freq=args.carrier_khz * 1000.0)
    print(json.dumps({"out": out}))
    return 0


# registration and dispatch in one table, so a subcommand cannot be parsed
# and then left undispatched
_SUBCOMMANDS = {
    "prepare-data": (_add_prepare, cmd_prepare),
    "train": (_add_train, cmd_train),
    "train-multi": (_add_train_multi, cmd_train_multi),
    "evaluate": (_add_eval, cmd_evaluate),
    "infer": (_add_infer, cmd_infer),
    "certify": (_add_certify, cmd_certify),
    "attack": (_add_attack, cmd_attack),
    "dolphin": (_add_dolphin, cmd_dolphin),
    "profile": (_add_profile, cmd_profile),
}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="asr_using_robust_nn_tpu_torch",
        description="PyTorch/CUDA port of the robust-ASR framework")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for add, _ in _SUBCOMMANDS.values():
        add(sub)
    args = parser.parse_args(argv)
    return _SUBCOMMANDS[args.cmd][1](args) or 0


if __name__ == "__main__":
    sys.exit(main())
