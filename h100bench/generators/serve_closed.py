"""Serving traffic: one closed-loop client sends batches of one-second
utterances to `InferenceEngine.classify` and waits for each answer, as
`infer`, `evaluate` and the robustness sweeps do.

Set-up makes a pool of utterances on the card from the seed and keeps it on
the host, as float32 rows; fits the scaler on a separate calibration set
(the reference MFCC) and draws the model from the seed (Keras' init, NonNeg,
BatchNorm moving statistics from the calibration set); builds the engine,
warms the traffic's buckets and sends one request per bucket. The window's
requests take their sizes from `gen.request_sizes` and their rows from a
seeded offset into the pool; each is timed on the client's side around
`classify`. The request in flight at the deadline ends and counts.

After the window the reference classifies a sample of the window's requests,
drawn from the seed with the longest among them, from the same waves.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import gen
from ..reference import compare, mfcc
from ..reference import mlp as ref

CHUNK = 1024


class Traffic:
    def __init__(self, run):
        self.run = run
        self.cfg = run.config
        self.traffic = run.traffic
        self.model = ref.Model(self.cfg)
        self.dev = run.device
        self.fe = self.cfg["frontend"]

    def _waves(self, n, seed_word):
        rng = np.random.default_rng(gen.derive(self.run.seed, seed_word))
        lab = rng.integers(0, self.cfg["dims"][-1], n)
        return torch.cat([gen.digit_waves(
            lab[i:i + CHUNK], gen.derive(self.run.seed, seed_word, i),
            self.dev, width=self.fe["width"], sr=self.fe["sr"])
            for i in range(0, n, CHUNK)])

    def _model(self):
        """Seeded weights, the scaler and BN statistics from the calibration
        set -> (params, state, (mean, scale)) in the reference's layout."""
        c, tr = self.cfg, self.traffic
        feats = mfcc.mfcc_flat(self._waves(tr["calibration_rows"], 31),
                               self.fe).double()
        mean = feats.mean(0)
        scale = feats.std(0, unbiased=False)
        scale = torch.where(scale == 0, torch.ones_like(scale), scale)
        h = ((feats - mean) / scale).float()
        params, state = gen.init_params(c["dims"], c["batch_norm"],
                                        gen.derive(self.run.seed, 32),
                                        self.dev)
        with ref.precision("fp32"):
            for i, p in enumerate(params):
                if c["nonneg"]:
                    p["w"] = torch.clamp_min(p["w"], 0.0)
                if i == len(params) - 1:
                    break
                h = torch.relu(h @ p["w"] + p["b"])
                if c["batch_norm"]:
                    state[i] = {"mean": h.mean(0),
                                "var": h.var(0, unbiased=False)}
                    h = (h - state[i]["mean"]) * torch.rsqrt(
                        state[i]["var"] + c["bn_eps"])
        return params, state, (mean, scale)

    def setup(self):
        from asr_using_robust_nn_tpu_torch.models.mlp import MLPConfig
        from asr_using_robust_nn_tpu_torch.ops.mfcc_torch import \
            FrontendConfig
        from asr_using_robust_nn_tpu_torch.serve.engine import \
            InferenceEngine

        c, tr = self.cfg, self.traffic
        t = [time.perf_counter()]
        self.pool = self._waves(tr["pool_rows"], 30).cpu().numpy()
        params, state, (mean, scale) = self._model()
        t.append(time.perf_counter())
        self.ref_model = (params, state, (mean, scale))
        host = lambda tree: {"layers": [  # noqa: E731
            {k: v.cpu().numpy() for k, v in layer.items()} for layer in tree]}
        self.engine = InferenceEngine(
            getattr(MLPConfig, c["preset"])(),
            getattr(FrontendConfig, self.fe["preset"])(),
            host(params), host(state),
            scaler=(mean.cpu().numpy(), scale.cpu().numpy()),
            buckets=tuple(tr["buckets"]), device=self.dev)
        self.engine.warmup(buckets=tr["warm_buckets"], dtypes=(tr["dtype"],))
        for rows in tr["warm_buckets"]:
            self.engine.classify(self.pool[:rows])
        t.append(time.perf_counter())
        print("set-up s: pool and model %.3f, engine and warm-up %.3f"
              % (t[1] - t[0], t[2] - t[1]), file=sys.stderr, flush=True)
        self.sizes = gen.request_sizes(tr["rows_lo"], tr["rows_hi"],
                                       tr["block"], self.run.seed)
        self.offsets = np.random.default_rng(gen.derive(self.run.seed, 33))
        self.requests = []

    def one_request(self):
        with self.run.span("client"):
            n = next(self.sizes)
            off = int(self.offsets.integers(0, len(self.pool) - n + 1))
            waves = self.pool[off:off + n]
        with self.run.span("classify"):
            t0 = time.perf_counter()
            try:
                out = self.engine.classify(waves)
                ok = out["probs"].shape == (n, self.cfg["dims"][-1])
            except RuntimeError as e:
                print(f"request of {n} rows failed: {e}", file=sys.stderr,
                      flush=True)
                out, ok = None, False
            lat = time.perf_counter() - t0
        return {"rows": n, "offset": off, "latency_s": lat, "ok": ok,
                "out": out}

    def _loop(self, seconds):
        t0 = time.perf_counter()
        reqs = []
        while True:
            reqs.append(self.one_request())
            if time.perf_counter() - t0 >= seconds:
                break
        return reqs, time.perf_counter() - t0

    def window(self, seconds: float) -> dict:
        reqs, window_s = self._loop(seconds)
        self.requests = reqs
        lat = np.asarray([r["latency_s"] for r in reqs]) * 1e3
        big = np.asarray([r["rows"] > 256 for r in reqs])
        p50 = lambda a: np.percentile(a, 50) if len(a) else float("nan")  # noqa
        print(f"window: {len(reqs)} requests, latency ms p50 {p50(lat):.3f}"
              f" p95 {np.percentile(lat, 95):.3f}; over 256 rows p50 "
              f"{p50(lat[big]):.3f}, up to 256 p50 {p50(lat[~big]):.3f}",
              file=sys.stderr, flush=True)
        return {"window_s": window_s, "attempted": len(reqs),
                "failed": sum(not r["ok"] for r in reqs),
                "rows": sum(r["rows"] for r in reqs if r["ok"]),
                "latencies_s": [r["latency_s"] for r in reqs]}

    def traced_part(self) -> dict:
        reqs, _ = self._loop(float(self.traffic["trace_seconds"]))
        return {"requests": [{"rows": r["rows"]} for r in reqs]}

    def end_to_end(self, name: str) -> float:
        f = self.run.facts
        if name == "serve_utt_per_s":
            return f["rows"] / f["window_s"]
        if name == "setup_s":
            return f["setup_s"]
        raise KeyError(name)

    def release(self):
        self.engine = None
        torch.cuda.empty_cache()

    # -- the check ------------------------------------------------------

    def sample(self) -> list[dict]:
        """The window's requests the check compares: a seeded draw and the
        longest."""
        done = [r for r in self.requests if r["ok"]]
        rng = np.random.default_rng(gen.derive(self.run.seed, 34))
        k = min(int(self.traffic["sample_requests"]), len(done))
        pick = set(rng.choice(len(done), size=k, replace=False).tolist())
        pick.add(int(np.argmax([r["rows"] for r in done])))
        return [done[i] for i in sorted(pick)]

    def reference_probs(self, reqs, dtype=torch.float64, prec="fp32"):
        params, state, (mean, scale) = self.ref_model
        out = []
        for r in reqs:
            w = torch.as_tensor(self.pool[r["offset"]:r["offset"] + r["rows"]],
                                device=self.dev)
            f = mfcc.mfcc_flat(w, self.fe, dtype).double()
            x = ((f - mean) / scale).float()
            out.append(ref.probs(self.model, params, state, x, prec).cpu())
        return out

    def numbers(self, reqs, got_probs, got_labels) -> dict:
        want = self.reference_probs(reqs)
        gap, flips = 0.0, 0
        for g, lab, w in zip(got_probs, got_labels, want):
            gap = max(gap, compare.max_abs_gap(torch.as_tensor(g), w))
            top2 = torch.topk(w, 2, dim=1).values
            sure = (top2[:, 0] - top2[:, 1]) > 1e-3
            flips += int(((torch.as_tensor(lab) != w.argmax(1)) & sure).sum())
        return {"prob_gap": gap, "label_flips": float(flips)}

    def check(self) -> dict:
        reqs = self.sample()
        return self.numbers(reqs, [r["out"]["probs"] for r in reqs],
                            [r["out"]["labels"] for r in reqs])

    def standin(self, kind: str) -> dict:
        """The reference in the program's place: "control" one precision
        lower (a float32 frontend, TF32 GEMMs); "altered": the program's
        answers with one row's label and probabilities moved to another
        class."""
        reqs = self.sample()
        if kind == "control":
            probs = [p.numpy() for p in self.reference_probs(
                reqs, torch.float32, "tf32")]
            return self.numbers(reqs, probs, [p.argmax(1) for p in probs])
        if kind == "altered":
            probs = [r["out"]["probs"].copy() for r in reqs]
            labels = [r["out"]["labels"].copy() for r in reqs]
            probs[0][0] = np.roll(probs[0][0], 1)
            labels[0][0] = (labels[0][0] + 1) % probs[0].shape[1]
            return self.numbers(reqs, probs, labels)
        raise ValueError(kind)

