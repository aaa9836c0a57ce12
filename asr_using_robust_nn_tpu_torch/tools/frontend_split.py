"""Where K4's or K5's time goes: the kernel as built, and build copies of its
source with one part cut out, timed on the same inputs in one process.

    python3 asr_using_robust_nn_tpu_torch/tools/frontend_split.py
        [--kernel k4|k5] [--root DIR] [--batch 1024] [--reps 5]

Run it as a script, not with -m: `--root` names the checkout whose package
is measured (default: the one this file lives in), so an earlier version of
a kernel is measured by this same script from an unpacked copy of its
checkout. Each variant is a text substitution in a copy of that checkout's
source (`csrc/int8_dft_power_mel.cu` for K4, `csrc/dft_power_mel_x3.cu` for
K5), built with the package's nvcc flags into its `_build/variants/`; the
package itself has no switch for them:

  full      the kernel as it is;
  no_fold   K4: the mel fold's loop runs no iteration (the power tile is
            formed); K5: the mel products' loop runs no iteration (the power
            is formed and split);
  no_mma    the rDFT products' loop runs no iteration (the operands are
            still staged, the power and mel run on zero sums);
  no_loads  the operand staging loops (frames and constants; K5's Mel tiles
            too, which the constants' loop copies) run no iteration: the
            products run on whatever shared memory holds;
  no_both   neither staging nor products: what is left is the step loop's
            barriers, the power, the mel step and the output;
  no_split  K5 only, where the source has it: the split pass writes
            nothing (the kernel runs on whatever the signal buffer holds).

It times each through the package's own wrapper (`mel_power_int8_cuda` at
the digit preset, digitizing included; `mel_power_bf16x3_cuda` at the
speaker preset) with CUDA events, in the order full, the variants and back,
and the wrapper's tensor-op preparation alone (K4: center pad +
`_wave_digits`; K5: center pad + the pad to whole frames that the wmma
kernel's wrapper made), and prints one JSON line with the card's name and
power limit. Needs a CUDA device and nvcc.
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
# with what): exactly one alternative of each cut must occur, exactly once,
# unless the cut lists None, which lets a source without any of them keep
# the variant uncut there. The first alternative is the older kernel's loop.
_K4_FOLD = [("for (int f = 0; f < BN; ++f) {",
             "for (int f = 0; f < 0; ++f) {"),
            ("for (int idx = tid; idx < (hi - lo) * BM; idx += THREADS) {",
             "for (int idx = tid; idx < 0; idx += THREADS) {")]
_K4_MMA = [("for (int kk = 0; kk < BK; kk += 16) {",
            "for (int kk = 0; kk < 0; kk += 16) {"),
           ("for (int kk = 0; kk < BK / 32; ++kk) {",
            "for (int kk = 0; kk < 0; ++kk) {")]
_K4_LOAD_A = [("      for (int d = 0; d < 3; ++d)\n#pragma unroll\n"
               "        for (int i = 0; i < 4; ++i)",
               "      for (int d = 0; d < 0; ++d)\n#pragma unroll\n"
               "        for (int i = 0; i < 4; ++i)"),
              ("    for (int d = 0; d < 3; ++d) {\n#pragma unroll\n"
               "      for (int h = 0; h < 2; ++h) {",
               "    for (int d = 0; d < 0; ++d) {\n#pragma unroll\n"
               "      for (int h = 0; h < 2; ++h) {")]
_K4_LOAD_B = [("      for (int m = 0; m < 6; ++m)\n",
               "      for (int m = 0; m < 0; ++m)\n"),
              ("    for (int m = 0; m < 6; ++m) {",
               "    for (int m = 0; m < 0; ++m) {")]

_K5_MEL = [("for (int kk = 0; kk < BN; kk += 16) {",
            "for (int kk = 0; kk < 0; kk += 16) {"),
           ("for (int t = 0; t < BC / 16; ++t) {",
            "for (int t = 0; t < 0; ++t) {")]
_K5_MMA = [("for (int kk = 0; kk < BK; kk += 16) {",
            "for (int kk = 0; kk < 0; kk += 16) {"),
           ("for (int kk = 0; kk < BK / 16; ++kk) {",
            "for (int kk = 0; kk < 0; ++kk) {")]
_K5_LOAD_A = [("      for (int i = 0; i < 16; ++i) {\n        bf16 hi, lo;\n"
               "        split(__ldg(",
               "      for (int i = 0; i < 0; ++i) {\n        bf16 hi, lo;\n"
               "        split(__ldg("),
              ("      for (int i = 0; i < NR; ++i) {\n"
               "        const int row = tid / PIECES",
               "      for (int i = 0; i < 0; ++i) {\n"
               "        const int row = tid / PIECES")]
_K5_LOAD_B = [("      for (int m = 0; m < 4; ++m)\n#pragma unroll\n"
               "        for (int h = 0; h < 2; ++h)\n"
               "          *reinterpret_cast<uint4*>(&s.st.b",
               "      for (int m = 0; m < 0; ++m)\n#pragma unroll\n"
               "        for (int h = 0; h < 2; ++h)\n"
               "          *reinterpret_cast<uint4*>(&s.st.b"),
              ("      for (int i = 0; i < 8; ++i) {\n"
               "        const int row = brow + 16 * i;",
               "      for (int i = 0; i < 0; ++i) {\n"
               "        const int row = brow + 16 * i;")]
_K5_SPLIT = [("  if (q >= quads) return;", "  if (q >= 0) return;"), None]

_KERNELS = {
    "k4": {"source": "int8_dft_power_mel", "entry": "asr_int8_dft_power_mel",
           "module": "cuda_mfcc_int8", "wrapper": "mel_power_int8_cuda",
           "preset": "digit",
           "cuts": {"no_fold": [_K4_FOLD], "no_mma": [_K4_MMA],
                    "no_loads": [_K4_LOAD_A, _K4_LOAD_B],
                    "no_both": [_K4_LOAD_A, _K4_LOAD_B, _K4_MMA]}},
    "k5": {"source": "dft_power_mel_x3", "entry": "asr_dft_power_mel_x3",
           "module": "cuda_mfcc_x3", "wrapper": "mel_power_bf16x3_cuda",
           "preset": "speaker",
           "cuts": {"no_fold": [_K5_MEL], "no_mma": [_K5_MMA],
                    "no_loads": [_K5_LOAD_A, _K5_LOAD_B],
                    "no_both": [_K5_LOAD_A, _K5_LOAD_B, _K5_MMA],
                    "no_split": [_K5_SPLIT]}},
}


def _variant_source(src: str, variant: str, cuts) -> str | None:
    """`src` with the variant's cuts made, or None where every cut of the
    variant may be absent and is."""
    made = 0
    for cut in cuts:
        hits = [alt for alt in cut
                if alt is not None and src.count(alt[0]) == 1]
        if not hits and None in cut:
            continue
        if len(hits) != 1:
            raise RuntimeError(f"{variant}: the source matches {len(hits)} "
                               f"of a cut's known loops, expected exactly one")
        src = src.replace(*hits[0])
        made += 1
    return src if made else None


def _build_variant(pkg_dir: str, name: str, variant: str, cuts, nvcc: str,
                   flags) -> str | None:
    csrc = os.path.join(pkg_dir, "csrc")
    with open(os.path.join(csrc, f"{name}.cu")) as fh:
        src = _variant_source(fh.read(), variant, cuts)
    if src is None:
        return None
    out = os.path.join(pkg_dir, "_build", "variants", name, variant)
    os.makedirs(out, exist_ok=True)
    for f in os.listdir(csrc):
        if f.endswith(".cuh"):
            shutil.copy(os.path.join(csrc, f), out)
    cu = os.path.join(out, f"{name}.cu")
    with open(cu, "w") as fh:
        fh.write(src)
    so = os.path.join(out, f"lib{name}.so")
    res = subprocess.run([nvcc, *flags, "-o", so, cu], capture_output=True,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on the {variant} variant:\n"
                           f"{res.stderr}")
    return so


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(_KERNELS), default="k4")
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    spec = _KERNELS[args.kernel]
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import importlib

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("frontend_split: no CUDA device", file=sys.stderr)
        return 1
    from asr_using_robust_nn_tpu_torch.ops import _build
    from asr_using_robust_nn_tpu_torch.ops.mfcc_torch import (
        FrontendConfig, center_pad)

    mod = importlib.import_module(
        f"asr_using_robust_nn_tpu_torch.ops.{spec['module']}")
    if not mod.__file__.startswith(root):
        raise RuntimeError(f"imported {mod.__file__}, not the package of "
                           f"{root}")
    pkg_dir = os.path.dirname(os.path.dirname(mod.__file__))
    real = mod._kernel()
    fns = {"full": real}
    for variant, cuts in spec["cuts"].items():
        so = _build_variant(pkg_dir, spec["source"], variant, cuts,
                            _build._nvcc(), _build.NVCC_FLAGS)
        if so is None:
            continue
        fn = getattr(ctypes.CDLL(so), spec["entry"])
        fn.argtypes, fn.restype = real.argtypes, real.restype
        fns[variant] = fn

    cfg = getattr(FrontendConfig, spec["preset"])()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(7)
    t = np.arange(22050) / 22050.0
    w = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 3000, (args.batch, 1)) * t)
         + 0.02 * rng.standard_normal((args.batch, 22050))).astype(np.float32)
    w = torch.from_numpy(w).to(dev)
    wrapper = getattr(mod, spec["wrapper"])

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
        mod._kernel = lambda: fn
        return time_ms(lambda: wrapper(w, cfg))

    variants = [v for v in fns if v != "full"]
    order = ("full", *variants, *reversed(variants), "full")
    runs = {v: [] for v in fns}
    try:
        for v in order:
            runs[v].append(wrapper_with(fns[v]))
    finally:
        mod._kernel = lambda: real
    if args.kernel == "k4":
        from asr_using_robust_nn_tpu_torch.ops.mfcc_int8 import _wave_digits

        prep_ms = time_ms(lambda: _wave_digits(center_pad(w, cfg)))
    else:
        need = (cfg.num_frames(w.shape[1]) - 1) * cfg.hop_length \
            + -(-cfg.n_fft // 64) * 64

        def pads():
            y = center_pad(w, cfg)
            return F.pad(y, (0, max(0, need - y.shape[1]))).contiguous()

        prep_ms = time_ms(pads)
    ms = {v: sum(r) / len(r) for v, r in runs.items()}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps({
        "kernel": args.kernel, "root": root, "batch": args.batch,
        "preset": spec["preset"], "ms": ms, "runs_ms": runs,
        "fold_ms": ms["full"] - ms["no_fold"],
        "mma_ms": ms["full"] - ms["no_mma"],
        "loads_ms": ms["full"] - ms["no_loads"],
        "split_ms": (ms["full"] - ms["no_split"]) if "no_split" in ms
        else None,
        "prep_ms": prep_ms, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
