"""Command line of the PyTorch port. One subcommand so far, the
counterpart of the JAX package's `asrtpu prepare-data`:

  python -m asr_using_robust_nn_tpu_torch.cli.main prepare-data \
      --task digit --data-dir data/ --out-dir processed/

It walks `<data-dir>/<class>/*.wav`, splits 70/20/10 by `--seed`, featurizes
on `--device` (default `cuda`; there is no quiet step down to the CPU) with
the frontend `--backend`, writes the six .npy artifacts plus the audio attack
set, and prints one JSON line with the split shapes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..frontend.mfcc import Frontend

__all__ = ["main"]


def _add_prepare(sub):
    p = sub.add_parser("prepare-data", help="corpus -> .npy artifacts")
    p.add_argument("--task", choices=["digit", "speaker"], required=True)
    p.add_argument("--data-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backend", default="cuda",
                   choices=sorted(Frontend._BACKENDS))
    p.add_argument("--device", default=None,
                   help="torch device of the frontend (default: cuda, an "
                        "error where there is none; 'cpu' for the CPU)")


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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="asr_using_robust_nn_tpu_torch",
        description="PyTorch/CUDA port of the robust-ASR framework")
    sub = parser.add_subparsers(dest="cmd", required=True)
    _add_prepare(sub)
    args = parser.parse_args(argv)
    return {"prepare-data": cmd_prepare}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
