"""Where K4's time goes: the kernel as built, and build copies of its source
with one part cut out, timed on the same inputs in one process.

    python3 asr_using_robust_nn_tpu_torch/tools/k4_split.py [--root DIR]
        [--batch 1024] [--reps 5]

Run it as a script, not with -m: `--root` names the checkout whose package
is measured (default: the one this file lives in), so an earlier version of
K4 is measured by this same script from an unpacked copy of its checkout.
Each variant is a text substitution in a copy of that checkout's
`csrc/int8_dft_power_mel.cu`, built with the package's nvcc flags into its
`_build/variants/`; the package itself has no switch for them:

  full      the kernel as it is;
  no_fold   the mel fold's loop runs no iteration (the power tile is formed);
  no_mma    the products' loop runs no iteration (the operands are still
            staged, the fold runs on zero sums);
  no_loads  the operand staging loops (digit frames and constants) run no
            iteration: the products run on whatever shared memory holds;
  no_both   neither staging nor products: what is left is the step loop's
            barriers, the combine, the fold and the output.

It times each through the package's own wrapper (`mel_power_int8_cuda`,
digitizing included) at the digit preset with CUDA events, in the order
full, no_fold, no_mma, no_loads, no_both and back, and the digitizing alone
(center pad + `_wave_digits`), and prints one JSON line with the card's
name and power limit. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

import numpy as np

# A variant is a list of cuts; a cut lists alternative (what it replaces,
# with what): exactly one alternative of each cut must occur, exactly once.
# The first alternative is the PR 3 kernel's loop, the second the wgmma
# kernel's.
_FOLD = [("for (int f = 0; f < BN; ++f) {", "for (int f = 0; f < 0; ++f) {"),
         ("for (int idx = tid; idx < (hi - lo) * BM; idx += THREADS) {",
          "for (int idx = tid; idx < 0; idx += THREADS) {")]
_MMA = [("for (int kk = 0; kk < BK; kk += 16) {",
         "for (int kk = 0; kk < 0; kk += 16) {"),
        ("for (int kk = 0; kk < BK / 32; ++kk) {",
         "for (int kk = 0; kk < 0; ++kk) {")]
_LOAD_A = [("      for (int d = 0; d < 3; ++d)\n#pragma unroll\n"
            "        for (int i = 0; i < 4; ++i)",
            "      for (int d = 0; d < 0; ++d)\n#pragma unroll\n"
            "        for (int i = 0; i < 4; ++i)"),
           ("    for (int d = 0; d < 3; ++d) {\n#pragma unroll\n"
            "      for (int h = 0; h < 2; ++h) {",
            "    for (int d = 0; d < 0; ++d) {\n#pragma unroll\n"
            "      for (int h = 0; h < 2; ++h) {")]
_LOAD_B = [("      for (int m = 0; m < 6; ++m)\n",
            "      for (int m = 0; m < 0; ++m)\n"),
           ("    for (int m = 0; m < 6; ++m) {",
            "    for (int m = 0; m < 0; ++m) {")]
_CUTS = {"no_fold": [_FOLD], "no_mma": [_MMA],
         "no_loads": [_LOAD_A, _LOAD_B],
         "no_both": [_LOAD_A, _LOAD_B, _MMA]}


def _variant_source(src: str, variant: str) -> str:
    for cut in _CUTS[variant]:
        hits = [(a, b) for a, b in cut if src.count(a) == 1]
        if len(hits) != 1:
            raise RuntimeError(f"{variant}: the K4 source matches {len(hits)} "
                               f"of a cut's known loops, expected exactly one")
        src = src.replace(*hits[0])
    return src


def _build_variant(pkg_dir: str, variant: str, nvcc: str, flags) -> str:
    csrc = os.path.join(pkg_dir, "csrc")
    out = os.path.join(pkg_dir, "_build", "variants", variant)
    os.makedirs(out, exist_ok=True)
    for f in os.listdir(csrc):
        if f.endswith(".cuh"):
            shutil.copy(os.path.join(csrc, f), out)
    with open(os.path.join(csrc, "int8_dft_power_mel.cu")) as fh:
        src = _variant_source(fh.read(), variant)
    cu = os.path.join(out, "int8_dft_power_mel.cu")
    with open(cu, "w") as fh:
        fh.write(src)
    so = os.path.join(out, "libk4.so")
    res = subprocess.run([nvcc, *flags, "-o", so, cu], capture_output=True,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on the {variant} variant:\n"
                           f"{res.stderr}")
    return so


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("k4_split: no CUDA device", file=sys.stderr)
        return 1
    from asr_using_robust_nn_tpu_torch.ops import _build
    from asr_using_robust_nn_tpu_torch.ops import cuda_mfcc_int8 as k4
    from asr_using_robust_nn_tpu_torch.ops.mfcc_int8 import _wave_digits
    from asr_using_robust_nn_tpu_torch.ops.mfcc_torch import (
        FrontendConfig, center_pad)

    if not k4.__file__.startswith(root):
        raise RuntimeError(f"imported {k4.__file__}, not the package of "
                           f"{root}")
    pkg_dir = os.path.dirname(os.path.dirname(k4.__file__))
    real = k4._kernel()
    fns = {"full": real}
    for variant in _CUTS:
        lib = ctypes.CDLL(_build_variant(pkg_dir, variant, _build._nvcc(),
                                         _build.NVCC_FLAGS))
        fn = lib.asr_int8_dft_power_mel
        fn.argtypes, fn.restype = real.argtypes, real.restype
        fns[variant] = fn

    cfg = FrontendConfig.digit()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(7)
    t = np.arange(22050) / 22050.0
    w = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 3000, (args.batch, 1)) * t)
         + 0.02 * rng.standard_normal((args.batch, 22050))).astype(np.float32)
    w = torch.from_numpy(w).to(dev)

    def time_ms(call):
        call()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            call()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / args.reps

    def wrapper_with(fn):
        k4._kernel = lambda: fn
        return time_ms(lambda: k4.mel_power_int8_cuda(w, cfg))

    order = ("full", *_CUTS, *reversed(_CUTS), "full")
    runs = {v: [] for v in fns}
    try:
        for v in order:
            runs[v].append(wrapper_with(fns[v]))
    finally:
        k4._kernel = lambda: real
    digitize_ms = time_ms(lambda: _wave_digits(center_pad(w, cfg)))
    ms = {v: sum(r) / len(r) for v, r in runs.items()}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps({
        "root": root, "batch": args.batch, "preset": "digit", "ms": ms,
        "runs_ms": runs, "fold_ms": ms["full"] - ms["no_fold"],
        "mma_ms": ms["full"] - ms["no_mma"],
        "loads_ms": ms["full"] - ms["no_loads"], "digitize_ms": digitize_ms,
        "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
