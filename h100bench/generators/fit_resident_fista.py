"""Training traffic under the FISTA projection: `fit_resident`'s mix
exactly (back-to-back device-resident `Trainer.fit` calls from fresh seeded
inits, a warm-up fit that pays the parity gate, the check's two one-epoch
fits), with the configuration's `make_fista_constraint(rho, nit, alpha)` in
place of simple_norm and the FISTA reference (`reference/fista.py`) in the
check. Every fit must report the fused epoch (K3 with K7).

Beside the numbers `fit_resident` compares, it reports two of the
projection alone: three more check fits, each one step on the first batch
at learning rate 0, so that the step is NonNeg and then the projection (K7
in K3's graph), from the same weights as the reference's, each read as the
worst layer's relative Frobenius gap between the kernels. They isolate the
projection's arithmetic from the bf16 GEMMs that the other numbers are
dominated by. `proj_gap` is the fit from the check's init, far above rho,
where every layer updates. `proj_near_gap` is the worse of two fits from
that init made NonNeg and scaled so that the product's 2-norm is a set
multiple of rho (`PROJ_FITS`): just inside the ball, where the exit fires at
the first layer's first iteration and ends the step, as on most of the
window's steps; and just outside it, where the first layer iterates and its
exit ends the step.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import torch

from .. import gen
from ..reference import fista as ref_fista
from . import fit_resident
from .fit_resident import _prog_tree


# The check fits at learning rate 0: {name: the product's 2-norm at their
# start as a multiple of rho, None for the check's init as drawn}.
PROJ_FITS = {"proj": None, "proj_inside": 0.95, "proj_outside": 1.05}


def near_rho(init, rho: float, f: float):
    """The (params, state) `init` with its kernels made NonNeg and scaled
    alike, so that the product W_0 ... W_m has the 2-norm f * rho (in
    float64)."""
    params, state = init
    ws = [torch.clamp_min(p["w"].double(), 0.0) for p in params]
    prod = ws[0]
    for w in ws[1:]:
        prod = prod @ w
    c = (f * rho / float(torch.linalg.matrix_norm(prod, ord=2))) \
        ** (1.0 / len(ws))
    return [dict(p, w=(w * c).float()) for p, w in zip(params, ws)], state


class Traffic(fit_resident.Traffic):
    def setup(self):
        from asr_using_robust_nn_tpu_torch.constraints import \
            make_fista_constraint
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
        self.con = make_fista_constraint(c["rho"], nit=c["nit"],
                                         alpha=c["alpha"])
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
        self.trainer.cfg = dataclasses.replace(
            tcfg, epochs=1, patience=1, seed=self.check_seed,
            learning_rate=0.0)
        self.proj_init = {}
        for n, f in PROJ_FITS.items():
            start = init if f is None else near_rho(init, c["rho"], f)
            p, s = _prog_tree(*start)
            res = self.trainer.fit(x[:c["batch_size"]],
                                   self.lab[:c["batch_size"]],
                                   *self.split[2:], params=p, state=s)
            self._require_backend(res)
            self.prog_out[n] = {"params": hosts(res["params"]["layers"])}
            self.proj_init[n] = [hosts(tree) for tree in start]
        self.init = [hosts(tree) for tree in init]
        t.append(time.perf_counter())
        print("set-up s: corpus %.3f, warm-up fit %.3f (gate %.3f), check "
              "fits %.3f" % (t[1] - t[0], t[2] - t[1],
                             self.run.facts["gate_s"], t[3] - t[2]),
              file=sys.stderr, flush=True)
        self.window_cfg = dataclasses.replace(
            tcfg, epochs=c["epochs"], patience=c["patience"])
        self.n_fit = 0

    def reference_out(self, feats, prec="fp32", fault=None, init=None,
                      seed=None, draws="fused", proj_prec="fp32") -> dict:
        """The check's fits by the FISTA reference (fit_resident's, with
        `proj_prec` the precision of the projection's products)."""
        c = self.cfg
        init = self.init if init is None else init
        seed = self.check_seed if seed is None else seed
        x = self.standardize(feats)
        y = torch.as_tensor(self.lab, device=self.dev)
        n_tr = c["corpus"]["train"]
        dev = lambda tree: [{k: v.to(self.dev) for k, v in layer.items()}  # noqa
                            for layer in tree]
        out = {}
        fits = dict(self.check_fits(),
                    **{n: c["batch_size"] for n in PROJ_FITS})
        for n, rows in fits.items():
            start = self.proj_init[n] if n in PROJ_FITS else init
            r = ref_fista.train_epochs(
                self.model, dev(start[0]), dev(start[1]), x[:rows], y[:rows],
                x[n_tr:], y[n_tr:], batch=c["batch_size"], epochs=1,
                lr=0.0 if n in PROJ_FITS else c["learning_rate"],
                rho=c["rho"], nit=c["nit"], alpha=c["alpha"], seed=seed,
                prec=prec, proj_prec=proj_prec, fault=fault)
            out[n] = {"loss": r["loss"][0], "val_loss": r["val_loss"][0],
                      "params": r["params"], "state": r["state"],
                      "g1": r["g1"]}
        return out

    def numbers(self, feats, out, ref_feats, want, init=None) -> dict:
        got = super().numbers(feats, out, ref_feats, want, init)
        self.detail["proj"] = {n: [float(torch.linalg.vector_norm(
            a["w"].cpu().double() - b["w"].cpu().double())
            / torch.linalg.vector_norm(b["w"].cpu().double()))
            for a, b in zip(out[n]["params"], want[n]["params"])]
            for n in PROJ_FITS}
        gaps = self.detail["proj"]
        got["proj_gap"] = max(gaps["proj"])
        got["proj_near_gap"] = max(max(gaps[n]) for n in PROJ_FITS
                                   if PROJ_FITS[n] is not None)
        return got

    def standin(self, kind: str) -> dict:
        """fit_resident's stand-ins, and "control_proj": the reference with
        the projection's products on bf16 operands."""
        if kind != "control_proj":
            return super().standin(kind)
        ref_feats = self.reference_features()
        want = self.reference_out(ref_feats)
        out = self.reference_out(ref_feats, proj_prec="bf16")
        return self.numbers(ref_feats, out, ref_feats, want)
