"""Serving path: raw waveforms -> label, padded to a fixed bucket ladder.

Counterpart of the JAX package's `serve/engine.py`. The request path

    waveform batch -> MFCC (K1 kernel on CUDA by default) -> standardize
                   -> MLP -> probs

runs on the engine's device for one of a few padded batch sizes, so a
request of any size reuses the shapes (and, on the card, the kernel's launch
geometry and the GEMM plans) of at most four buckets. Padding rows are exact
no-ops: inference has no cross-row reduction (the scaler is frozen
train-time moments and BatchNorm uses moving statistics), so padded outputs
are sliced off on the host.

Speaker-task long recordings follow the reference's slicing protocol (1-s
windows, first and last second dropped): the engine classifies every window
in one batch and aggregates per recording by majority vote or mean
probability.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..frontend.mfcc import Frontend
from ..models.convert import params_from_numpy
from ..models.mlp import MLPConfig, apply_mlp
from ..ops.mfcc_torch import FrontendConfig
from ..utils.device import resolve_device
from ..utils.profiling import span

__all__ = ["InferenceEngine", "load_checkpoint"]

# powers-of-4 ladder: at most ~4x padded waste per request, 4 shapes cover
# 1..1024 rows; larger requests run in max-bucket chunks
_DEFAULT_BUCKETS = (16, 64, 256, 1024)


def load_checkpoint(path, cfg: MLPConfig):
    """(params, state) as numpy trees from a checkpoint store dir
    (`<path>/best.npz`, train/checkpoints.py) or a Keras-layout .h5, checked
    against `cfg`. The library form of the CLI's `load_model`: it raises
    ValueError where the CLI exits with a message."""
    from ..train.checkpoints import (CheckpointManager, import_keras_h5,
                                     validate_model_tree)

    if str(path).endswith(".h5"):
        if not os.path.exists(path):
            raise ValueError(f"checkpoint file {path!r} not found")
        return import_keras_h5(path, cfg)
    if not os.path.exists(os.path.join(str(path), "best.npz")):
        raise ValueError(
            f"no checkpoint at {path!r} (expected a store dir with "
            f"'best.npz' written by `train --ckpt`, or a .h5 file)")
    tree, _ = CheckpointManager(path).load_best()
    validate_model_tree(tree["params"], tree["state"], cfg)
    return tree["params"], tree["state"]


class InferenceEngine:
    """Batched audio classifier over a bucket ladder.

    Args:
      model_cfg / frontend_cfg: the task's MLP and MFCC parameterizations
        (`MLPConfig.digit_*` + `FrontendConfig.digit()`, etc.).
      params / state: the model tree, as tensors or numpy arrays in the JAX
        package's layout (`models/convert.py`).
      scaler: (mean, scale) from train-time standardization
        (`data/pipeline.py::standardize_fit_all`), or None for a model
        trained on raw features.
      buckets: ascending batch-padding ladder.
      wave_width: fixed waveform sample width per request row. Default 1 s
        at cfg.sr; shorter inputs are masked exactly via per-row `lengths`,
        longer ones truncated.
      device: where the request path runs. None is the CUDA device (an
        error where there is none); pass "cpu" for the CPU.
      backend: the frontend backend (`frontend/mfcc.py`); 'auto' resolves
        from the device and the config by a table of H100 measurements: on
        the card, for both presets, the K1 kernel ('cuda').
    """

    def __init__(self, model_cfg: MLPConfig, frontend_cfg: FrontendConfig,
                 params, state, scaler=None, buckets=_DEFAULT_BUCKETS,
                 wave_width: int | None = None, device=None,
                 backend: str = "auto"):
        if list(buckets) != sorted(set(int(b) for b in buckets)) or \
                min(buckets) < 1:
            raise ValueError(f"buckets must be ascending unique positive "
                             f"ints, got {buckets!r}")
        self.model_cfg = model_cfg
        self.frontend_cfg = frontend_cfg
        self.buckets = tuple(int(b) for b in buckets)
        self.wave_width = int(wave_width or frontend_cfg.sr)
        self.device = resolve_device(device)
        self._fe = Frontend(frontend_cfg, backend=backend, device=self.device)
        self._params, self._state = params_from_numpy(params, state,
                                                      self.device)
        if scaler is not None:
            mean, scale = scaler
            self._scaler = tuple(
                torch.as_tensor(np.asarray(v, np.float32), device=self.device)
                for v in (mean, scale))
        else:
            self._scaler = None
        self.latencies_s: list[float] = []  # per classify() call, warm only
        self._warm: set[tuple[int, str]] = set()

    # -- construction helpers ------------------------------------------------

    @classmethod
    def from_checkpoint(cls, task: str, variant: str, ckpt_path,
                        artifacts_dir=None, standardize: bool = True,
                        **kw) -> "InferenceEngine":
        """An engine from a trained checkpoint (store dir or .h5).
        `artifacts_dir` (the `prepare-data` output the model was trained on)
        re-derives the fit-on-all scaler moments; pass standardize=False for
        a model trained on raw features. `kw` goes to the constructor
        (buckets, wave_width, device, backend)."""
        from ..data.pipeline import load_artifacts, standardize_fit_all

        model_cfg = {
            ("digit", "unconstrained"): MLPConfig.digit_unconstrained,
            ("digit", "constrained"): MLPConfig.digit_constrained,
            ("speaker", "unconstrained"): MLPConfig.speaker_unconstrained,
            ("speaker", "constrained"): MLPConfig.speaker_constrained,
        }[(task, variant)]()
        fe_cfg = (FrontendConfig.digit() if task == "digit"
                  else FrontendConfig.speaker())
        params, state = load_checkpoint(ckpt_path, model_cfg)
        scaler = None
        if standardize:
            if artifacts_dir is None:
                raise ValueError(
                    "standardize=True needs artifacts_dir to re-derive the "
                    "train-time scaler moments (or pass scaler= explicitly "
                    "to InferenceEngine)")
            d = load_artifacts(artifacts_dir)
            _, _, _, mean, scale = standardize_fit_all(
                d.train_data, d.dev_data, d.test_data)
            scaler = (mean, scale)
        return cls(model_cfg, fe_cfg, params, state, scaler=scaler, **kw)

    # -- the request path ----------------------------------------------------

    def _run_bucket(self, waves: np.ndarray, lengths: np.ndarray):
        """(bucket, wave_width) f32 or int16 rows -> (bucket, n_classes)
        probs on the device."""
        feats = self._fe.flat(waves, lengths=lengths)
        if self._scaler is not None:
            feats = (feats - self._scaler[0]) / self._scaler[1]
        logits, _ = apply_mlp(self.model_cfg, self._params, self._state,
                              feats, train=False)
        return torch.softmax(logits, dim=-1)

    def warmup(self, buckets=None, dtypes=("float32", "int16")) -> None:
        """Run the request path once for each (bucket, ingress dtype) pair,
        so first real requests don't pay one-time set-up (kernel build and
        load, device constants, GEMM plans)."""
        for b in buckets if buckets is not None else self.buckets:
            for dt in dtypes:
                w = np.zeros((b, self.wave_width), np.dtype(dt))
                lens = np.full((b,), self.wave_width, np.int64)
                self._run_bucket(w, lens).cpu()
                self._warm.add((int(b), np.dtype(dt).name))

    # -- public classification API -------------------------------------------

    def classify(self, waves, lengths=None) -> dict:
        """Classify a batch of waveforms.

        `waves`: (B, L) float OR int16-PCM array, or a list of 1-D arrays
        of varying lengths. int16 rows transfer as int16 and dequantize on
        the device (bit-identical to f32 ingress of w/32768, at half the
        transfer bytes). Returns {"labels": (B,) int64, "probs":
        (B, n_classes) float32, "latency_s": float}. Rows are padded to the
        enclosing bucket and oversized requests run in max-bucket chunks.
        `latency_s` is what the caller waits for, `_pack` included.

        While a torch profiler records, the call is the span
        `engine.classify`, holding `engine.pack` and per chunk
        `engine.bucket` (padding, the enqueue and its host-to-device copy)
        and `engine.read` (the probabilities to the host)
        (`utils/profiling.py`).
        """
        with span("engine.classify"):
            return self._classify(waves, lengths)

    def _classify(self, waves, lengths) -> dict:
        t0 = time.perf_counter()
        with span("engine.pack"):
            w, lens = self._pack(waves, lengths)
        n = w.shape[0]
        cap = self.buckets[-1]
        probs_out = []
        for start in range(0, n, cap):
            chunk, clens = w[start:start + cap], lens[start:start + cap]
            m = chunk.shape[0]
            bucket = next(b for b in self.buckets if b >= m)
            with span("engine.bucket"):
                if m < bucket:
                    chunk = np.concatenate(
                        [chunk, np.zeros((bucket - m, self.wave_width),
                                         w.dtype)], 0)
                    clens = np.concatenate(
                        [clens, np.full((bucket - m,), self.wave_width,
                                        np.int64)], 0)
                probs = self._run_bucket(chunk, clens)
            with span("engine.read"):
                probs = probs.cpu().numpy()
            probs_out.append(probs[:m])
        probs = np.concatenate(probs_out, 0)
        dt = time.perf_counter() - t0
        # warm-path latency only, tracked per (bucket, dtype): a cold call
        # measures one-time set-up, not the serving path
        touched = [(b, w.dtype.name) for b in self._buckets_touched(n)]
        if all(t in self._warm for t in touched):
            self.latencies_s.append(dt)
        else:
            self._warm.update(touched)
        return {"labels": np.argmax(probs, axis=1), "probs": probs,
                "latency_s": dt}

    def classify_windows(self, wave, sr: int | None = None,
                         agg: str = "vote") -> dict:
        """Reference speaker protocol for one long recording: slice into
        1-s windows (first/last second dropped), classify all windows as one
        batch, aggregate.

        agg: 'vote' (majority over window argmaxes, ties to the lower label
        id) or 'mean' (argmax of the mean probability). Returns {"label",
        "window_labels", "probs", "n_windows", "latency_s"}; label is None
        if the recording is too short to yield a window.
        """
        from ..data.pipeline import slice_seconds

        if agg not in ("vote", "mean"):
            raise ValueError(f"agg must be 'vote' or 'mean', got {agg!r}")
        windows = slice_seconds(np.asarray(wave, np.float32),
                                sr=sr or self.frontend_cfg.sr)
        if windows.shape[0] == 0:
            return {"label": None, "window_labels": np.zeros((0,), np.int64),
                    "probs": np.zeros((0, self.model_cfg.n_classes),
                                      np.float32),
                    "n_windows": 0, "latency_s": 0.0}
        out = self.classify(windows)
        wl = out["labels"]
        if agg == "vote":
            label = int(np.bincount(wl, minlength=self.model_cfg.n_classes)
                        .argmax())
        else:
            label = int(out["probs"].mean(axis=0).argmax())
        return {"label": label, "window_labels": wl, "probs": out["probs"],
                "n_windows": int(windows.shape[0]),
                "latency_s": out["latency_s"]}

    def classify_files(self, paths, agg: str | None = None) -> list[dict]:
        """Decode WAVs (numpy decode + polyphase resample to cfg.sr,
        `utils/audio_io.py`) and classify. With `agg` (speaker task), each
        file goes through `classify_windows`; otherwise each file is one
        utterance. Returns one dict per file (adds "path")."""
        from ..utils.audio_io import load_audio

        results = []
        if agg is not None:
            for p in paths:
                y, _ = load_audio(p, target_sr=self.frontend_cfg.sr)
                r = self.classify_windows(y, agg=agg)
                r["path"] = str(p)
                results.append(r)
            return results
        waves = [load_audio(p, target_sr=self.frontend_cfg.sr)[0]
                 for p in paths]
        out = self.classify(waves)
        for i, p in enumerate(paths):
            results.append({"path": str(p), "label": int(out["labels"][i]),
                            "probs": out["probs"][i],
                            "latency_s": out["latency_s"]})
        return results

    # -- stats ----------------------------------------------------------------

    def latency_stats(self) -> dict:
        """Percentiles over recorded warm classify() calls."""
        if not self.latencies_s:
            return {"n": 0}
        a = np.asarray(self.latencies_s)
        return {"n": int(a.size), "p50_ms": float(np.percentile(a, 50) * 1e3),
                "p90_ms": float(np.percentile(a, 90) * 1e3),
                "p95_ms": float(np.percentile(a, 95) * 1e3),
                "p99_ms": float(np.percentile(a, 99) * 1e3),
                "mean_ms": float(a.mean() * 1e3)}

    # -- internals -------------------------------------------------------------

    def _buckets_touched(self, n: int) -> list[int]:
        cap = self.buckets[-1]
        out = []
        left = n
        while left > 0:
            m = min(left, cap)
            out.append(next(b for b in self.buckets if b >= m))
            left -= m
        return out

    def _pack(self, waves, lengths):
        """-> (B, wave_width) f32 OR int16 + (B,) int64 true lengths.

        int16 input stays int16 up to the device; mixed-dtype lists fall
        back to f32 with int16 rows divided by 32768 on the host."""
        W = self.wave_width
        if isinstance(waves, np.ndarray) and waves.ndim == 2:
            rows = [waves[i] for i in range(waves.shape[0])]
        else:
            rows = [np.asarray(r).reshape(-1) for r in waves]
        if not rows:
            raise ValueError("classify() needs at least one waveform")
        int16_in = all(r.dtype == np.int16 for r in rows)
        dt = np.int16 if int16_in else np.float32
        out = np.zeros((len(rows), W), dt)
        lens = np.empty((len(rows),), np.int64)
        for i, r in enumerate(rows):
            m = min(len(r), W)
            if int16_in:
                out[i, :m] = r[:m]
            elif r.dtype == np.int16:
                # int16 rows always mean PCM, also in a mixed-dtype batch
                out[i, :m] = r[:m].astype(np.float32) / 32768.0
            else:
                out[i, :m] = np.asarray(r[:m], np.float32)
            lens[i] = m
        if lengths is not None:
            lens = np.minimum(np.asarray(lengths, np.int64), W)
        return out, lens
