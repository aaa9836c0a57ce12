"""What the thesis-study scripts share: the recipe table, one recipe's fit,
the model closures and the analysis block.

Counterparts in the JAX scripts: the recipe lists of
`examples/robustness_study_synthetic.py:98-126`,
`examples/robustness_study_speaker.py:104-126` and
`examples/hardness_sweep.py:94-124`; the `fns(name)` logits/predict closures
(`robustness_study_synthetic.py:158-173`, `robustness_study_speaker.py:
146-161`); the analysis block (`robustness_study_synthetic.py:116-156`,
`robustness_study_speaker.py:128-144`).

Everything runs on one device (None: the card, an error where there is
none; "cpu" for the tests). `fit_recipe` takes the model and training
configurations and the initial parameters as optional arguments, whose
defaults are the scripts' values, so that a test can run a recipe at
dropout 0 from carried-over weights.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..constraints import (
    get_lipschitz_constrained,
    get_lipschitz_sound,
    get_norms,
    get_upper_lipschitz,
    make_simple_norm_constraint,
)
from ..models.convert import cstate_from_numpy, params_from_numpy
from ..models.mlp import MLPConfig, apply_mlp, init_mlp
from ..train import TrainConfig, Trainer
from ..train.trainer import _tree_map
from ..utils.device import resolve_device

__all__ = ["Recipe", "RECIPES", "fit_recipe", "model_fns", "analyze",
           "save_plot", "device_line", "fit_info"]


@dataclasses.dataclass(frozen=True)
class Recipe:
    """One side of the thesis pairing: an `MLPConfig` preset, whether the
    simple_norm projection runs, and the batch size."""

    name: str
    preset: str
    constrained: bool
    batch: int

    def model_cfg(self) -> MLPConfig:
        return getattr(MLPConfig, self.preset)()


# the reference's pairings: digit `VD/train_google_dataset.py:49-99`,
# `VD/train_constraints.py:63-119`; speaker `SR/train_no_constraints.py:
# 42-75`, `SR/train_constraints.py:41,63-105`
RECIPES = {
    "digit": (Recipe("unconstrained", "digit_unconstrained", False, 256),
              Recipe("constrained", "digit_constrained", True, 512)),
    "speaker": (Recipe("unconstrained", "speaker_unconstrained", False, 64),
                Recipe("constrained", "speaker_constrained", True, 64)),
}


def fit_recipe(recipe: Recipe, tr, ytr, dv, ydv, *, epochs: int, rho: float,
               seed: int, device=None, n_iter: int = 8,
               epochs_per_dispatch: int = 1, patience: int | None = None,
               model_cfg: MLPConfig | None = None,
               train_cfg: TrainConfig | None = None, init=None) -> dict:
    """Train one recipe as the scripts do: a device-resident `Trainer.fit`
    (K3 on the card through `epoch_backend="auto"`), patience = epochs
    unless given, simple_norm(rho, n_iter) for the constrained side.

    `init` = (params, state, cstate) numpy trees in the JAX layout (cstate
    None for the unconstrained side) starts the fit from those weights and
    that power-iteration vector. Returns {cfg, trainer, result, params,
    state}, the best-on-dev parameters on the device."""
    dev = resolve_device(device)
    cfg = model_cfg or recipe.model_cfg()
    tcfg = train_cfg or TrainConfig(
        batch_size=recipe.batch, epochs=epochs,
        patience=epochs if patience is None else patience, seed=seed,
        device_resident=True, epochs_per_dispatch=epochs_per_dispatch)
    kw, fit_kw = {}, {}
    if recipe.constrained:
        con = make_simple_norm_constraint(rho, n_iter=n_iter)
        p0, _ = init_mlp(cfg, torch.Generator(device=dev).manual_seed(seed),
                         device=dev)
        kw = dict(constraint=con.apply, constraint_state=con.init(p0))
    if init is not None:
        params, state, cstate = init
        fit_kw["params"], fit_kw["state"] = params_from_numpy(params, state,
                                                              device=dev)
        if cstate is not None:
            kw["constraint_state"] = cstate_from_numpy(cstate, device=dev)
    trainer = Trainer(cfg, tcfg, device=dev, **kw)
    res = trainer.fit(tr, ytr, dv, ydv, **fit_kw)
    on_dev = lambda t: t.to(dev)  # noqa: E731
    return {"cfg": cfg, "trainer": trainer, "result": res,
            "params": _tree_map(on_dev, res["best_params"]),
            "state": _tree_map(on_dev, res["best_state"])}


def model_fns(cfg: MLPConfig, params, state, device=None):
    """-> (logits, predict): logits of float32 tensors on the device (what
    the white-box attacks differentiate); predict of numpy features ->
    softmax probabilities as numpy (what the sweeps score)."""
    dev = resolve_device(device)

    def logits(x):
        return apply_mlp(cfg, params, state, x, train=False)[0]

    def predict(x):
        with torch.no_grad():
            xt = torch.as_tensor(np.asarray(x, np.float32), device=dev)
            return torch.softmax(logits(xt), -1).cpu().numpy()

    return logits, predict


def analyze(cfg: MLPConfig, params, state, te, yte, device=None) -> dict:
    """The analysis block: the median margin logit(true) - max other logit
    over ALL test rows (misclassified rows count with negative margins;
    `robustness_study_synthetic.py:131-144`), the reference's Lipschitz
    estimate (`get_lipschitz_constrained`), the sound BN-inclusive bound,
    the product of the layer norms, and the nominal radius margin / (2 L)."""
    dev = resolve_device(device)
    with torch.no_grad():
        lg = apply_mlp(cfg, params, state,
                       torch.as_tensor(np.asarray(te, np.float32),
                                       device=dev), train=False)[0]
    lg = lg.cpu().numpy()
    yte = np.asarray(yte)
    rows = np.arange(len(yte))
    z_true = lg[rows, yte]
    masked = lg.copy()
    masked[rows, yte] = -np.inf
    med = float(np.median(z_true - masked.max(axis=1)))
    lip = float(get_lipschitz_constrained(cfg, params, state))
    return {
        "lipschitz": lip,
        "lipschitz_sound": float(get_lipschitz_sound(cfg, params, state)),
        "norms_product": float(get_upper_lipschitz(get_norms(params))),
        "median_margin": med,
        "certified_radius": med / (2.0 * lip) if lip > 0 else math.inf,
    }


def save_plot(result, path: str, log=print) -> None:
    """The sweep's comparison plot as a PNG, where matplotlib is installed;
    otherwise one printed line says the plot was skipped."""
    try:
        import matplotlib
    except ImportError:
        log(f"plot skipped ({path}): matplotlib is not installed")
        return
    matplotlib.use("Agg")
    ax = result.plot()
    ax.figure.savefig(path, dpi=110)


def device_line(device) -> str:
    """The device the study ran on: for a card, its name and power limit as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them (the name alone where nvidia-smi is missing); else the device."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return str(dev)
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (FileNotFoundError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(dev)
    return out[dev.index or 0] if out else torch.cuda.get_device_name(dev)


def fit_info(fit: dict) -> dict:
    """What a run record keeps of one fit: epochs, backend, seconds."""
    res = fit["result"]
    return {"epochs_run": int(res["epochs_run"]),
            "epoch_backend": res["epoch_backend"],
            "seconds": float(res["seconds"]),
            "best_val_loss": float(res["best_val_loss"])}
