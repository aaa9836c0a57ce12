#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on an NVIDIA GPU and check it.

    python3 chip_smoke.py

Needs one CUDA device and nvcc; imports nothing of JAX. Phases, each of
which raises on failure (the exit code is then non-zero):

  build    compile csrc/dft_power_mel.cu (K1) from the checkout, print the
           build time and the compiler's register/shared-memory report;
  kernel   K1 (`mel_power_cuda`) against its plain fp32 twin and an f64
           chain on the card, both presets, B in {1, 3} (ragged row counts)
           and every bucket {16, 64, 256, 1024}; the full K1 MFCC against
           the f64 oracle and tests/golden_mfcc.npz (5e-4);
  serve    the main path: a digit_constrained InferenceEngine (full width,
           seeded random weights) warms all four buckets and answers f32 and
           int16 requests of 5..1500 rows, checked against a plain on-card
           pipeline; int16 ingress must be bit-equal to f32 ingress; the K1
           launch count must equal the number of frontend calls. Then a
           speaker_constrained engine aggregates windows of a 6-s recording
           and classifies WAV files;
  timing   K1 against its plain twin at the 1024-row buckets (CUDA events),
           the engine's warm p50/p95 per bucket and ingress dtype, and
           beside each the request's host-to-device copy and K1 timed alone.

The last lines are the kernel summary (JSON), the card's name and power
limit as nvidia-smi gives them, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
REPLACES = "asr_using_robust_nn_tpu/ops/pallas_mfcc.py:51"
SEED = 0


def synth_waves(n, width=22050, seed=SEED, gap=True):
    """Seeded stand-in utterances: a tone (100..3000 Hz), noise, and a
    silent stretch."""
    rng = np.random.default_rng(seed)
    t = np.arange(width) / 22050.0
    w = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 3000, (n, 1)) * t)
         + 0.02 * rng.standard_normal((n, width))).astype(np.float32)
    if gap:
        w[:, width // 3: width // 3 + 2000] = 0.0
    return w


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def check(cond, what):
    if not cond:
        raise AssertionError(what)


# -- kernel phase -------------------------------------------------------------

def mel_f64(waves, cfg):
    """The rDFT -> power -> mel chain with every sum in float64."""
    from asr_using_robust_nn_tpu_torch.ops.mfcc_torch import (
        center_pad, device_constants, frame_signal)

    cr, ci, mel_t, _ = device_constants(cfg, waves.device)
    frames = frame_signal(center_pad(waves, cfg), cfg.num_frames(
        waves.shape[-1]), cfg.n_fft, cfg.hop_length).double()
    re, im = frames @ cr.double(), frames @ ci.double()
    return (re * re + im * im) @ mel_t.double()


def kernel_phase(dev, batches=(1, 3, 16, 64, 256, 1024)):
    """K1 vs the plain twin and the f64 chain; K1 MFCC vs oracle/goldens.
    Returns the digit B=max(batches) comparison numbers."""
    import torch
    from asr_using_robust_nn_tpu_torch.ops import frontend_ref
    from asr_using_robust_nn_tpu_torch.ops.cuda_mfcc import (
        mel_power_cuda, mel_power_plain, mfcc_cuda_batch)
    from asr_using_robust_nn_tpu_torch.ops.mfcc_torch import FrontendConfig

    summary = {}
    for preset in ("digit", "speaker"):
        cfg = getattr(FrontendConfig, preset)()
        for b in batches:
            w = torch.from_numpy(synth_waves(b, seed=b)).to(dev)
            got = mel_power_cuda(w, cfg)
            torch.cuda.synchronize()
            plain = mel_power_plain(w, cfg)
            ref = mel_f64(w, cfg)
            peak = ref.max().item()
            big = ref > 1e-6 * peak
            rel_plain = ((got - plain).abs() / plain.abs())[big].max().item()
            rel_f64 = ((got.double() - ref).abs() / ref)[big].max().item()
            abs_plain = (got - plain).abs().max().item()
            # vs the f64 chain: the kernel rounds the power to fp32 once and
            # sums non-negative mel terms in fp32 -> 1e-5 relative
            f64_ok = torch.all((got.double() - ref).abs()
                               <= 1e-5 * ref + 1e-12 * peak).item()
            # vs the fp32 twin: the twin's own fp32-GEMM error, which grows
            # with the frame's energy, not the bin's -> 1e-4 rel + 1e-8 peak
            plain_ok = torch.all((got - plain).abs()
                                 <= 1e-4 * plain.abs() + 1e-8 * peak).item()
            print(f"kernel {preset} B={b} rows={b * cfg.num_frames(22050)}: "
                  f"max_rel vs f64 {rel_f64:.3e}, vs plain {rel_plain:.3e} "
                  f"(mel > 1e-6*max); max_abs vs plain {abs_plain:.3e} "
                  f"(peak {peak:.3e})", flush=True)
            check(got.shape == (b, cfg.num_frames(22050), 128),
                  f"K1 shape {tuple(got.shape)}")
            check(f64_ok, f"K1 {preset} B={b} disagrees with the f64 chain")
            check(plain_ok, f"K1 {preset} B={b} disagrees with its plain twin")
            if preset == "digit" and b == max(batches):
                summary = {"max_abs_err": abs_plain, "max_rel_err": rel_plain,
                           "max_rel_err_vs_f64": rel_f64, "peak": peak}

        # full MFCC with lengths masking vs the f64 oracle, and the goldens
        w = synth_waves(5, seed=21)
        lens = np.array([22050, 9000, 300, 0, 15000], np.int64)
        for i, n in enumerate(lens):
            w[i, n:] = 0.0
        got = mfcc_cuda_batch(torch.from_numpy(w).to(dev), cfg,
                              torch.from_numpy(lens).to(dev)).cpu().numpy()
        check(np.isfinite(got).all(), "non-finite MFCC")
        kw = dict(n_fft=cfg.n_fft, hop_length=cfg.hop_length,
                  win_length=cfg.win_length)
        err = 0.0
        for i, n in enumerate(lens):
            if cfg.num_frames(int(n)) == 0:
                check(not got[i].any(), "row without frames must be zeros")
                continue
            want = frontend_ref.mfcc_fixed_length_ref(
                w[i, :n], cfg.utterance_length, **kw)
            err = max(err, float(np.abs(got[i] - want).max()))
        gold = np.load(os.path.join(REPO, "tests", "golden_mfcc.npz"))
        names = ["chirp", "tone_noise", "impulses"]
        gw = torch.from_numpy(np.stack([gold[f"in_{n}"] for n in names]))
        got_g = mfcc_cuda_batch(gw.to(dev), cfg).cpu().numpy()
        want_g = np.stack([gold[f"{preset}_{n}"] for n in names])
        err_g = float(np.abs(got_g - want_g).max())
        print(f"mfcc {preset}: K1 max_abs vs f64 oracle {err:.3e}, "
              f"vs goldens {err_g:.3e} (bar 5e-4)", flush=True)
        check(err <= 5e-4, f"K1 MFCC {preset} {err} from the oracle")
        check(err_g <= 5e-4, f"K1 MFCC {preset} {err_g} from the goldens")
        summary[f"mfcc_err_{preset}"] = max(err, err_g)
    return summary


# -- serving phase ------------------------------------------------------------

def build_model(dev, model_cfg, fe_cfg, seed):
    """Full-width model with seeded NonNeg-range weights, a scaler fit on
    seeded calibration audio, and BN moving statistics set to the batch
    moments of that audio, so activations are O(1) as after training."""
    import dataclasses

    import torch
    from asr_using_robust_nn_tpu_torch.data.pipeline import standardize_fit_all
    from asr_using_robust_nn_tpu_torch.frontend.mfcc import Frontend
    from asr_using_robust_nn_tpu_torch.models.mlp import apply_mlp, init_mlp

    gen = torch.Generator(device=dev).manual_seed(seed)
    params, state = init_mlp(model_cfg, gen, device=dev)
    for p in params["layers"]:
        p["w"] = p["w"].abs()  # NonNeg-constrained kernels
    calib = synth_waves(256, seed=seed + 1)
    feats = Frontend(fe_cfg, backend="plain", device=dev).flat(calib)
    feats = feats.cpu().numpy().astype(np.float64)
    _, _, _, mean, scale = standardize_fit_all(feats, feats[:0], feats[:0])
    x = (torch.from_numpy(feats).to(dev) - torch.from_numpy(mean).to(dev)) \
        / torch.from_numpy(scale).to(dev)
    _, state = apply_mlp(dataclasses.replace(model_cfg, bn_momentum=0.0),
                         params, state, x.float(), train=True)
    return params, state, (mean.astype(np.float32), scale.astype(np.float32))


def plain_probs(dev, model_cfg, fe_cfg, params, state, scaler, waves, lens):
    """The same request on the card without the kernel: plain frontend ->
    standardize -> apply_mlp -> softmax."""
    import torch
    from asr_using_robust_nn_tpu_torch.frontend.mfcc import Frontend
    from asr_using_robust_nn_tpu_torch.models.mlp import apply_mlp

    feats = Frontend(fe_cfg, backend="plain", device=dev).flat(waves, lens)
    mean, scale = (torch.from_numpy(v).to(dev) for v in scaler)
    logits, _ = apply_mlp(model_cfg, params, state, (feats - mean) / scale)
    return torch.softmax(logits, -1).cpu().numpy()


def compare_probs(got, want, what):
    """Kernel-path probs vs the plain pipeline. The two frontends differ by
    the plain twin's fp32-rDFT error (up to ~6e-4 on the MFCC), carried
    through the scaler and the MLP: 1e-3 abs on probs; labels must agree
    wherever the top-2 margin exceeds 1e-2."""
    diff = float(np.abs(got - want).max())
    top2 = np.sort(want, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-2
    check(diff <= 1e-3, f"{what}: probs differ by {diff}")
    check((got.argmax(1) == want.argmax(1))[clear].all(),
          f"{what}: labels differ")
    return diff


def serving_phase(dev, request_sizes=(5, 16, 100, 1024, 1500),
                  buckets=(16, 64, 256, 1024)):
    import torch
    from asr_using_robust_nn_tpu_torch.models.mlp import MLPConfig
    from asr_using_robust_nn_tpu_torch.ops.cuda_mfcc import mel_power_cuda
    from asr_using_robust_nn_tpu_torch.ops.mfcc_torch import FrontendConfig
    from asr_using_robust_nn_tpu_torch.serve.engine import InferenceEngine
    from asr_using_robust_nn_tpu_torch.utils.audio_io import (
        load_audio, write_wav)

    d_cfg, d_fe = MLPConfig.digit_constrained(), FrontendConfig.digit()
    d_model = build_model(dev, d_cfg, d_fe, seed=SEED)
    s_cfg, s_fe = MLPConfig.speaker_constrained(), FrontendConfig.speaker()
    s_model = build_model(dev, s_cfg, s_fe, seed=SEED + 10)
    torch.cuda.synchronize()

    mel_power_cuda.launches = 0  # the main path starts here
    frontend_calls = 0
    eng = InferenceEngine(d_cfg, d_fe, *d_model[:2], scaler=d_model[2],
                          buckets=buckets, device=dev)
    eng.warmup()
    frontend_calls += 2 * len(buckets)
    worst = 0.0
    rng = np.random.default_rng(SEED + 2)
    for n in request_sizes:
        w = synth_waves(n, seed=SEED + 100 + n)
        lens = rng.integers(4000, 22051, n)  # ragged true lengths
        for i, m in enumerate(lens):
            w[i, m:] = 0.0
        out = eng.classify(w, lengths=lens)
        frontend_calls += -(-n // buckets[-1])
        check(out["probs"].shape == (n, 10), f"probs shape {out['probs'].shape}")
        check(np.isfinite(out["probs"]).all(), "non-finite probs")
        want = plain_probs(dev, d_cfg, d_fe, *d_model, w, lens)
        worst = max(worst, compare_probs(out["probs"], want, f"f32 n={n}"))
        pcm = np.round(w * 32767).astype(np.int16)
        out16 = eng.classify(pcm, lengths=lens)
        out32 = eng.classify(pcm.astype(np.float32) / 32768.0, lengths=lens)
        frontend_calls += 2 * -(-n // buckets[-1])
        check(np.array_equal(out16["probs"], out32["probs"]),
              f"int16 ingress not bit-equal at n={n}")
        print(f"serve digit n={n}: max |probs - plain| {worst:.3e}, "
              f"int16 == f32/32768 bit-equal, labels[:8] "
              f"{out['labels'][:8].tolist()}", flush=True)

    s_eng = InferenceEngine(s_cfg, s_fe, *s_model[:2], scaler=s_model[2],
                            buckets=buckets, device=dev)
    rec = synth_waves(1, width=6 * 22050, seed=SEED + 3)[0]
    vote = s_eng.classify_windows(rec, agg="vote")
    mean = s_eng.classify_windows(rec, agg="mean")
    frontend_calls += 2
    check(vote["n_windows"] == 4 and mean["n_windows"] == 4, "window count")
    windows = rec[22050:5 * 22050].reshape(4, 22050)
    want = plain_probs(dev, s_cfg, s_fe, *s_model, windows,
                       np.full(4, 22050))
    worst = max(worst, compare_probs(vote["probs"], want, "speaker windows"))
    check(vote["label"] == int(np.bincount(vote["window_labels"],
                                           minlength=20).argmax()), "vote")
    check(mean["label"] == int(mean["probs"].mean(0).argmax()), "mean")
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for i, y in enumerate(synth_waves(3, seed=SEED + 4)):
            paths.append(os.path.join(tmp, f"utt{i}.wav"))
            write_wav(paths[-1], y, 22050)
        files = eng.classify_files(paths)
        decoded = [load_audio(p)[0] for p in paths]
        direct = eng.classify(decoded)
        long_path = os.path.join(tmp, "long.wav")
        write_wav(long_path, rec, 22050)
        (by_file,) = s_eng.classify_files([long_path], agg="vote")
        frontend_calls += 3
    check([r["label"] for r in files] == direct["labels"].tolist(),
          "classify_files != classify on the decoded audio")
    check(by_file["n_windows"] == 4, "classify_files(agg) windows")
    print(f"serve speaker: vote {vote['label']} mean {mean['label']} over "
          f"{vote['n_windows']} windows; files {[r['label'] for r in files]}",
          flush=True)
    torch.cuda.synchronize()
    launches = mel_power_cuda.launches  # the main path ends here
    print(f"K1 launches on the main path: {launches}, frontend calls: "
          f"{frontend_calls}", flush=True)
    check(launches == frontend_calls,
          f"K1 launched {launches} times for {frontend_calls} frontend calls")
    return {"launches": launches, "max_probs_err": worst, "engine": eng}


# -- timing phase -------------------------------------------------------------

def time_ms(fn, reps):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def timing_phase(dev, eng, batch=1024, reps=5, requests=20):
    """K1 vs its plain twin per preset (plain, kernel, kernel, plain, after
    one warm call each), then the engine's warm latency per bucket with the
    H2D copy and K1 timed alone beside it."""
    import torch
    from asr_using_robust_nn_tpu_torch.ops.cuda_mfcc import (
        mel_power_cuda, mel_power_plain)
    from asr_using_robust_nn_tpu_torch.ops.mfcc_torch import FrontendConfig

    card = card_line()
    out = {}
    for preset in ("digit", "speaker"):
        cfg = getattr(FrontendConfig, preset)()
        w = torch.from_numpy(synth_waves(batch, seed=7)).to(dev)
        k = lambda: mel_power_cuda(w, cfg)  # noqa: E731
        p = lambda: mel_power_plain(w, cfg)  # noqa: E731
        k(), p()
        t = [time_ms(p, reps), time_ms(k, reps), time_ms(k, reps),
             time_ms(p, reps)]
        kernel_ms, plain_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
        rows = batch * cfg.num_frames(22050)
        flop = rows * (cfg.n_fft * cfg.n_freq * 4 + cfg.n_freq * 128 * 2)
        out[preset] = {"ms": kernel_ms, "plain_ms": plain_ms,
                       "runs_ms": t, "gflop": flop / 1e9,
                       "kernel_tflops": flop / kernel_ms / 1e9}
        print(f"time K1 {preset} B={batch} ({rows} frames): kernel "
              f"{kernel_ms:.3f} ms, plain twin {plain_ms:.3f} ms "
              f"(runs p,k,k,p {[round(x, 3) for x in t]}); "
              f"{flop / 1e9:.1f} GFLOP -> {flop / kernel_ms / 1e9:.2f} "
              f"TFLOP/s; card {card}", flush=True)

    # per bucket: the engine's warm latency, and beside it the two layers
    # timed alone on the same rows: the host-to-device copy of the request
    # (pageable, as classify() makes it) and the K1 wrapper (pad + launch);
    # what is left of p50 is pack, the f64 finish, the MLP, the copy back
    # and the host's own time
    d_cfg = FrontendConfig.digit()
    rng = np.random.default_rng(SEED + 5)
    lat, layers = {}, {}
    for b in eng.buckets:
        wf = synth_waves(b, seed=int(rng.integers(1 << 30)))
        wd = torch.from_numpy(wf).to(dev)
        mel_power_cuda(wd, d_cfg)
        k1_ms = time_ms(lambda wd=wd: mel_power_cuda(wd, d_cfg), reps)
        for dt in ("float32", "int16"):
            w = wf if dt == "float32" else \
                np.round(wf * 32767).astype(np.int16)
            eng.latencies_s.clear()
            for _ in range(requests):
                eng.classify(w)
            st = eng.latency_stats()
            h2d_ms = time_ms(lambda w=w: torch.from_numpy(w).to(dev), reps)
            lat[f"{b}/{dt}"] = st
            layers[f"{b}/{dt}"] = {"h2d_ms": h2d_ms, "k1_ms": k1_ms,
                                   "rest_ms": st["p50_ms"] - h2d_ms - k1_ms}
            print(f"time engine bucket {b} {dt}: p50 {st['p50_ms']:.3f} ms "
                  f"p95 {st['p95_ms']:.3f} ms over {st['n']} warm requests "
                  f"({b / st['p50_ms'] * 1e3:.0f} utt/s at p50); alone: H2D "
                  f"{h2d_ms:.3f} ms, K1 {k1_ms:.3f} ms, rest of p50 "
                  f"{st['p50_ms'] - h2d_ms - k1_ms:.3f} ms; card {card}",
                  flush=True)
    out["layers"] = layers
    out["engine"] = lat
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing runs on the CPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from asr_using_robust_nn_tpu_torch.ops._build import (
        build_log, load_library)
    from asr_using_robust_nn_tpu_torch.ops.cuda_mfcc import KERNEL_SOURCE

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 GEMMs, never TF32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}",
          flush=True)
    t0 = time.perf_counter()
    load_library("dft_power_mel")
    print(f"build: dft_power_mel.cu in {time.perf_counter() - t0:.2f} s\n"
          f"{build_log('dft_power_mel')}", flush=True)

    kern = kernel_phase(dev)
    serve = serving_phase(dev)
    timing = timing_phase(dev, serve.pop("engine"))
    kernels = [{
        "name": "dft_power_mel", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": serve["launches"],
        "max_abs_err": kern["max_abs_err"],
        "max_rel_err": kern["max_rel_err"],
        "tolerance": "vs plain twin: 1e-4 rel + 1e-8*peak; vs f64 chain: "
                     "1e-5 rel; MFCC vs oracle/goldens: 5e-4 abs",
        "ms": timing["digit"]["ms"], "plain_ms": timing["digit"]["plain_ms"],
        "shape": "digit bucket 1024 (45056 frames x 2048)",
        "speaker_ms": timing["speaker"]["ms"],
        "speaker_plain_ms": timing["speaker"]["plain_ms"],
    }]
    print(json.dumps({"engine_latency_ms": {
        k: {m: v[m] for m in ("p50_ms", "p95_ms")}
        for k, v in timing["engine"].items()},
        "engine_layers_ms": timing["layers"],
        "mfcc_err": {k: v for k, v in kern.items() if k.startswith("mfcc")},
        "max_probs_err": serve["max_probs_err"]}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
