"""Training traffic: back-to-back device-resident `Trainer.fit` calls of
the configuration's recipe, each from a fresh seeded init.

Set-up makes the corpus on the card from the seed (the task's synthetic
utterances, featurized by the port's `Frontend`, standardized fit-on-all by
the benchmark) and builds one `Trainer`. Through it run, in order: a warm-up
fit of `warm_epochs` on the whole corpus, which pays the fused epoch's parity
gate on the window's own rows and warms every shape; then the check's two
fits, one epoch each from one seeded init, on the corpus's first batch and on
its first `check_steps - 1` batches and as many rows as the window's last,
ragged batch holds: the first step, and the first `check_steps` steps ending
in a step whose padded rows are masked as in every window epoch's last, of
training on the window's feed through the window's own call. The window then
runs fits of the configuration's `epochs` through the same trainer until
`--seconds` have passed; the fit in flight at the deadline ends and counts. A fit that does not report the required epoch
backend is a failed fit.

After the window the plain reference works the check's fits out again from
the same waves, initial weights, labels and seeds (`reference/mlp.py`).
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from .. import gen
from ..reference import compare, mfcc
from ..reference import mlp as ref

WAVES = {"digit": gen.digit_waves, "speaker": gen.voice_waves}
CHUNK = 1024


def _prog_tree(params, state):
    """Reference-layout lists -> the program's {"layers": [...]} trees."""
    return ({"layers": [dict(p) for p in params]},
            {"layers": [dict(s) for s in state]})


def _leaves(tree_layers, prefix):
    return {f"{prefix}{i}.{k}": v for i, layer in enumerate(tree_layers)
            for k, v in layer.items()}


class Traffic:
    def __init__(self, run):
        self.run = run
        self.cfg = run.config
        self.traffic = run.traffic
        self.model = ref.Model(self.cfg)
        self.dev = run.device

    # -- inputs ---------------------------------------------------------

    def labels(self):
        c = self.cfg
        rng = np.random.default_rng(gen.derive(self.run.seed, 11))
        n = c["corpus"]["train"] + c["corpus"]["val"]
        return rng.integers(0, c["dims"][-1], n)

    def waves(self, lab, start):
        """The corpus's waves of rows [start, start + CHUNK), on the card."""
        fe = self.cfg["frontend"]
        return WAVES[self.cfg["task"]](
            lab[start:start + CHUNK], gen.derive(self.run.seed, 12, start),
            self.dev, width=fe["width"], sr=fe["sr"])

    def standardize(self, feats: torch.Tensor) -> np.ndarray:
        """Fit-on-all z-scores (ddof 0, a constant feature's scale 1), the
        reference recipe's scaler, computed in float64."""
        f = feats.double()
        mean = f.mean(0)
        scale = f.std(0, unbiased=False)
        scale = torch.where(scale == 0, torch.ones_like(scale), scale)
        return ((f - mean) / scale).float()

    # -- the program ----------------------------------------------------

    def corpus(self) -> np.ndarray:
        """The corpus's features by the port's `Frontend` (kept for the
        check) and the split, standardized; -> all standardized rows."""
        from asr_using_robust_nn_tpu_torch.frontend.mfcc import Frontend
        from asr_using_robust_nn_tpu_torch.ops.mfcc_torch import \
            FrontendConfig

        c = self.cfg
        self.lab = self.labels()
        fe = Frontend(getattr(FrontendConfig, c["frontend"]["preset"])(),
                      backend="auto", device=self.dev)
        feats = torch.cat([fe.flat(self.waves(self.lab, i))
                           for i in range(0, len(self.lab), CHUNK)])
        self.prog_feats = feats.cpu()
        x = self.standardize(feats).cpu().numpy()
        n_tr = c["corpus"]["train"]
        self.split = (x[:n_tr], self.lab[:n_tr], x[n_tr:], self.lab[n_tr:])
        return x

    def setup(self):
        from asr_using_robust_nn_tpu_torch.constraints import \
            make_simple_norm_constraint
        from asr_using_robust_nn_tpu_torch.models.mlp import MLPConfig
        from asr_using_robust_nn_tpu_torch.train import TrainConfig, Trainer

        c, tr, seed = self.cfg, self.traffic, self.run.seed
        t = [time.perf_counter()]
        x = self.corpus()
        t.append(time.perf_counter())
        mcfg = getattr(MLPConfig, c["preset"])()
        dims = (mcfg.in_dim,) + tuple(mcfg.hidden) + (mcfg.n_classes,)
        if list(dims) != list(c["dims"]):
            raise ValueError(f"the program's {c['preset']} has dims {dims}, "
                             f"the configuration {c['dims']}")
        self.con = make_simple_norm_constraint(c["rho"], n_iter=c["n_iter"])
        tcfg = TrainConfig(
            batch_size=c["batch_size"], epochs=tr["warm_epochs"],
            patience=tr["warm_epochs"], learning_rate=c["learning_rate"],
            seed=gen.derive(seed, 21, 0), device_resident=True,
            epochs_per_dispatch=tr["epochs_per_dispatch"],
            epoch_backend=tr["epoch_backend"])
        warm = gen.init_params(c["dims"], c["batch_norm"],
                               gen.derive(seed, 20, 0), self.dev)
        p0, s0 = _prog_tree(*warm)
        self.trainer = Trainer(mcfg, tcfg, constraint=self.con.apply,
                               constraint_state=self.con.init(p0),
                               device=self.dev)
        res = self.trainer.fit(*self.split, params=p0, state=s0)
        self._require_backend(res)
        self.run.facts["gate_s"] = float(
            res["epoch_gate"]["seconds"]["total"])
        t.append(time.perf_counter())
        self.check_seed = gen.derive(seed, 23)
        init = gen.init_params(c["dims"], c["batch_norm"],
                               gen.derive(seed, 22), self.dev)
        self.trainer.cfg = dataclasses.replace(
            tcfg, epochs=1, patience=1, seed=self.check_seed)
        host = lambda t: t.detach().cpu()  # noqa: E731
        hosts = lambda tree: [{k: host(v) for k, v in layer.items()}  # noqa
                              for layer in tree]
        self.prog_out = {}
        for n, rows in self.check_fits().items():
            p, s = _prog_tree(*init)
            res = self.trainer.fit(x[:rows], self.lab[:rows], *self.split[2:],
                                   params=p, state=s)
            self._require_backend(res)
            self.prog_out[n] = {
                "loss": res["history"]["loss"][0],
                "val_loss": res["history"]["val_loss"][0],
                "params": hosts(res["params"]["layers"]),
                "state": hosts(res["state"]["layers"]),
                "g1": [{k: v / 0.1 for k, v in layer.items()} for layer in
                       hosts(res["opt_state"]["mu"]["layers"])]}
        self.init = [hosts(tree) for tree in init]
        t.append(time.perf_counter())
        print("set-up s: corpus %.3f, warm-up fit %.3f (gate %.3f), check "
              "fits %.3f" % (t[1] - t[0], t[2] - t[1],
                             self.run.facts["gate_s"], t[3] - t[2]),
              file=sys.stderr, flush=True)
        self.window_cfg = dataclasses.replace(
            tcfg, epochs=c["epochs"], patience=c["patience"])
        self.n_fit = 0

    def check_fits(self) -> dict[int, int]:
        """The check's fits, {steps: rows}: the first step, on one whole
        batch; and the first `check_steps` steps, whose last batch holds as
        many rows as the window's last (the training rows modulo the batch),
        so that K3 masks its padded rows out of BN's moments, the loss and
        the gradients as it does at the end of every window epoch."""
        b, n = self.cfg["batch_size"], int(self.traffic["check_steps"])
        tail = self.cfg["corpus"]["train"] % b or b
        return {1: b, n: (n - 1) * b + tail}

    def _require_backend(self, res):
        want = self.traffic["require_backend"]
        if res["epoch_backend"] != want:
            raise RuntimeError(f"a fit ran the {res['epoch_backend']!r} "
                               f"epoch, the cell measures {want!r}")

    def one_fit(self) -> dict:
        """The next fit of the sequence: a fresh seeded init and seed."""
        with self.run.span("between_fits"):
            self.n_fit += 1
            c, k = self.cfg, self.n_fit
            params, state = gen.init_params(
                c["dims"], c["batch_norm"], gen.derive(self.run.seed, 20, k),
                self.dev)
            p, s = _prog_tree(params, state)
            self.trainer.cfg = dataclasses.replace(
                self.window_cfg, seed=gen.derive(self.run.seed, 21, k))
        with self.run.span("fit"):
            try:
                res = self.trainer.fit(*self.split, params=p, state=s)
                self._require_backend(res)
            except RuntimeError as e:
                print(f"fit {k} failed: {e}", file=sys.stderr, flush=True)
                return {"ok": False, "rows": 0, "epochs": 0, "seconds": 0.0}
        n_tr = len(self.split[0])
        print(f"fit {k}: {res['epochs_run']} epochs, loop "
              f"{res['seconds']:.4f} s", file=sys.stderr, flush=True)
        return {"ok": True, "rows": n_tr * res["epochs_run"],
                "epochs": res["epochs_run"], "seconds": res["seconds"]}

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        fits = []
        while True:
            fits.append(self.one_fit())
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        return {"fits": fits, "window_s": window_s,
                "attempted": len(fits),
                "failed": sum(not f["ok"] for f in fits)}

    def traced_part(self) -> dict:
        """One more fit, for the trace."""
        return {"fits": [self.one_fit()]}

    def end_to_end(self, name: str) -> float:
        f = self.run.facts
        if name == "train_rows_per_s":
            return sum(x["rows"] for x in f["fits"]) / f["window_s"]
        if name == "setup_s":
            return f["setup_s"]
        raise KeyError(name)

    def release(self):
        self.trainer = self.split = None
        torch.cuda.empty_cache()

    # -- the check ------------------------------------------------------

    def reference_features(self, dtype=torch.float64) -> torch.Tensor:
        fe = self.cfg["frontend"]
        return torch.cat([mfcc.mfcc_flat(self.waves(self.lab, i), fe, dtype)
                          for i in range(0, len(self.lab), CHUNK)])

    def reference_out(self, feats, prec="fp32", fault=None, init=None,
                      seed=None, draws="fused") -> dict:
        """The check's fits worked out by the reference from `feats` (from
        `init`, with the trainer's `seed`; this traffic's by default):
        {batches: {"loss", "val_loss", "params", "state", "g1"}}."""
        c = self.cfg
        init = self.init if init is None else init
        seed = self.check_seed if seed is None else seed
        x = self.standardize(feats)
        y = torch.as_tensor(self.lab, device=self.dev)
        n_tr = c["corpus"]["train"]
        dev = lambda tree: [{k: v.to(self.dev) for k, v in layer.items()}  # noqa
                            for layer in tree]
        out = {}
        for n, rows in self.check_fits().items():
            r = ref.train_epochs(
                self.model, dev(init[0]), dev(init[1]), x[:rows],
                y[:rows], x[n_tr:], y[n_tr:], batch=c["batch_size"],
                epochs=1, lr=c["learning_rate"], rho=c["rho"],
                n_iter=c["n_iter"], seed=seed, prec=prec, fault=fault,
                draws=draws)
            out[n] = {"loss": r["loss"][0], "val_loss": r["val_loss"][0],
                      "params": r["params"], "state": r["state"],
                      "g1": r["g1"]}
        return out

    def numbers(self, feats, out, ref_feats, want, init=None) -> dict:
        """The compared numbers of a run's outputs against the reference's:
        the features; the first step's loss and gradient (the gradient as
        Adam holds it after one step, its first moment over 1 - b1); the
        first steps' mean loss, the change of every parameter and BN
        statistic over them and the validation loss after them."""
        one, many = self.check_fits()
        cpu = lambda d: {k: v.cpu() for k, v in d.items()}  # noqa: E731
        start = self.init if init is None else init
        init = cpu(_leaves(start[0], ""))
        init.update(cpu(_leaves(start[1], "state.")))

        def change(o):
            now = cpu(_leaves(o["params"], ""))
            now.update(cpu(_leaves(o["state"], "state.")))
            return {k: now[k] - init[k] for k in init}

        g_got, g_want = (cpu(_leaves(o[one]["g1"], "")) for o in (out, want))
        gate = cpu(_leaves(want[many]["g1"], ""))
        gate.update({k: torch.ones(1) for k in init if k.startswith("state.")})
        ch_got, ch_want = change(out[many]), change(want[many])
        self.detail = {
            "loss": [[out[n]["loss"], want[n]["loss"]] for n in (one, many)],
            "val_loss": [out[many]["val_loss"], want[many]["val_loss"]],
            "grad": compare.leaf_gaps(g_got, g_want),
            "change": compare.leaf_gaps(ch_got, ch_want)}
        rel = lambda n, k: compare.rel_series_gap(  # noqa: E731
            [out[n][k]], [want[n][k]])
        return {
            "feat_gap": compare.max_abs_gap(feats.cpu(), ref_feats.cpu()),
            "loss1_gap": rel(one, "loss"),
            "grad_gap": compare.leaf_norm_gap(g_got, g_want, gate=g_want),
            "loss_gap": rel(many, "loss"),
            "change_gap": compare.leaf_norm_gap(ch_got, ch_want, gate=gate),
            "val_loss_gap": rel(many, "val_loss"),
        }

    def control_prec(self) -> str:
        """One precision below the GEMMs' (the traffic's path, else the
        configuration's fused epoch): fp8 for bf16, TF32 for fp32."""
        dtype = self.traffic.get("gemm_dtype", self.cfg["train_gemm_dtype"])
        return {"bfloat16": "fp8", "float32": "tf32"}[dtype]

    def check(self) -> dict:
        ref_feats = self.reference_features()
        want = self.reference_out(ref_feats)
        return self.numbers(self.prog_feats, self.prog_out, ref_feats, want)

    def standin(self, kind: str) -> dict:
        """The numbers of the reference put in the program's place: "control"
        one precision lower (a float32 frontend, `control_prec` GEMMs), each
        of its two parts alone ("control_mfcc": the float32 frontend;
        "control_gemm": the `control_prec` GEMMs), or a planted fault
        ("half_batch"; "unchanged": each check fit returns its initial
        state)."""
        ref_feats = self.reference_features()
        want = self.reference_out(ref_feats)
        if kind in ("control", "control_mfcc", "control_gemm"):
            feats = ref_feats if kind == "control_gemm" else \
                self.reference_features(torch.float32)
            prec = "fp32" if kind == "control_mfcc" else self.control_prec()
            out = self.reference_out(feats, prec=prec)
        elif kind == "half_batch":
            feats = ref_feats
            out = self.reference_out(feats, fault="half_batch")
        elif kind == "unchanged":
            feats = ref_feats
            zeros = [{k: torch.zeros_like(v) for k, v in layer.items()}
                     for layer in self.init[0]]
            out = {n: dict(o, params=self.init[0], state=self.init[1],
                           g1=zeros) for n, o in want.items()}
        else:
            raise ValueError(kind)
        return self.numbers(feats, out, ref_feats, want)
