"""Certified robustness from the sound Lipschitz bound.

Counterpart of the JAX package's `constraints/certify.py`. With the logit
map's global L2 Lipschitz constant L (`get_lipschitz_sound`) and an example
classified as y with runner-up margin m(x) = f_y(x) - max_{j != y} f_j(x) >
0, every pairwise gap f_y - f_j is (sqrt(2) L)-Lipschitz, so no perturbation
with ||delta||_2 < m(x) / (sqrt(2) L) changes the label:

    radius_2(x) = m(x) / (sqrt(2) L),   radius_inf(x) = radius_2(x) / sqrt(d)

(the L-inf ball of radius eps lies inside the L2 ball of radius eps
sqrt(d)). Certified accuracy at eps is a lower bound on the accuracy under
any attack in that ball. Margins are one batched forward on the device; L
is one SVD a layer. With BatchNorm in the trunk the gamma / sqrt(var) gains
multiply in, so the certified curve of a typical recipe collapses at small
eps; that is a property of the method.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..models.convert import params_from_numpy
from ..models.mlp import MLPConfig, apply_mlp
from ..utils.device import resolve_device
from .lipschitz import get_lipschitz_sound

__all__ = ["certified_radii", "certified_accuracy_curve", "certify_sweep",
           "CertifyResult"]


@torch.no_grad()
def certified_radii(cfg: MLPConfig, params, state, x, y, device=None):
    """Per-example certified L2 radii in the model's input space.

    `params`/`state`: tensors or arrays in the JAX layout; `x` must be in
    the space the model consumes (standardized features for a model trained
    on them). Runs on `device` (None: the CUDA device). Returns (radii,
    correct, lipschitz_bound): radii[i] is the largest proven-safe L2
    perturbation norm for example i (0.0 when misclassified), correct[i]
    clean correctness (ties count as wrong), lipschitz_bound the sound
    constant used."""
    dev = resolve_device(device)
    params, state = params_from_numpy(params, state, dev)
    xt = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    yt = torch.as_tensor(np.asarray(y, np.int64), device=dev)
    logits, _ = apply_mlp(cfg, params, state, xt, train=False)
    lip = get_lipschitz_sound(cfg, params, state)
    own = torch.gather(logits, 1, yt[:, None])[:, 0]
    mask = torch.nn.functional.one_hot(yt, logits.shape[1]).bool()
    runner_up = torch.max(logits.masked_fill(mask, -torch.inf), dim=1).values
    margin = own - runner_up
    correct = margin > 0
    radii = torch.clamp(margin, min=0.0) / (math.sqrt(2.0) * lip)
    return radii.cpu().numpy(), correct.cpu().numpy(), float(lip)


def certified_accuracy_curve(radii, correct, eps_grid, norm: str = "l2",
                             d: int | None = None):
    """Fraction of examples provably correct under any attack of strength
    eps, per eps in `eps_grid`. norm='l2' certifies {||delta||_2 <= eps};
    'linf' certifies {||delta||_inf <= eps} through the sqrt(d) containment
    (needs the input dimension `d`). At eps == 0 this is the clean
    accuracy."""
    radii = np.asarray(radii, np.float64)
    correct = np.asarray(correct, bool)
    if norm == "linf":
        if d is None:
            raise ValueError("norm='linf' needs d (input dimension)")
        radii = radii / np.sqrt(float(d))
    elif norm != "l2":
        raise ValueError(f"norm must be 'l2' or 'linf', got {norm!r}")
    eps = np.asarray(list(eps_grid), np.float64)
    # strict > except at eps = 0, where clean correctness is the certificate
    return np.array(
        [float(np.mean(correct & ((radii > e) | (e == 0.0)))) for e in eps])


@dataclasses.dataclass
class CertifyResult:
    """Certified-accuracy curves of a constrained / unconstrained pair."""

    norm: str
    strengths: np.ndarray
    certified_constrained: np.ndarray
    certified_unconstrained: np.ndarray
    lipschitz_constrained: float
    lipschitz_unconstrained: float
    radius_stats_constrained: dict
    radius_stats_unconstrained: dict

    def as_dict(self):
        return {
            "norm": self.norm,
            "strengths": np.asarray(self.strengths).tolist(),
            "certified_constrained": self.certified_constrained.tolist(),
            "certified_unconstrained": self.certified_unconstrained.tolist(),
            "lipschitz_sound_constrained": self.lipschitz_constrained,
            "lipschitz_sound_unconstrained": self.lipschitz_unconstrained,
            "radius_stats_constrained": self.radius_stats_constrained,
            "radius_stats_unconstrained": self.radius_stats_unconstrained,
        }

    def plot(self, ax=None, title=None):
        """The reference's comparison-plot style, dashed to mark certified
        lower bounds rather than attack measurements."""
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots()
        ax.plot(self.strengths, self.certified_constrained, "r--",
                label="Constrained Model (certified)")
        ax.plot(self.strengths, self.certified_unconstrained, "b--",
                label="Unconstrained model (certified)")
        ax.legend()
        ax.set_title(title or f"Certified accuracy vs {self.norm} strength")
        ax.set_xlabel("Strength")
        ax.set_ylabel("Certified accuracy (lower bound)")
        return ax


def _radius_stats(radii, correct):
    r = np.asarray(radii)[np.asarray(correct, bool)]
    if r.size == 0:
        return {"n_correct": 0}
    return {"n_correct": int(r.size), "mean": float(r.mean()),
            "median": float(np.median(r)), "max": float(r.max())}


def certify_sweep(cfg_c: MLPConfig, pc, sc, cfg_u: MLPConfig, pu, su, x, y,
                  eps_grid, norm: str = "l2", device=None) -> CertifyResult:
    """Certified curves for a model pair on one (already standardized)
    feature set, on `device` (None: the CUDA device)."""
    rc, cc, lc = certified_radii(cfg_c, pc, sc, x, y, device=device)
    ru, cu, lu = certified_radii(cfg_u, pu, su, x, y, device=device)
    d = int(np.asarray(x).shape[1])
    return CertifyResult(
        norm=norm,
        strengths=np.asarray(list(eps_grid), np.float64),
        certified_constrained=certified_accuracy_curve(
            rc, cc, eps_grid, norm=norm, d=d),
        certified_unconstrained=certified_accuracy_curve(
            ru, cu, eps_grid, norm=norm, d=d),
        lipschitz_constrained=lc,
        lipschitz_unconstrained=lu,
        radius_stats_constrained=_radius_stats(rc, cc),
        radius_stats_unconstrained=_radius_stats(ru, cu),
    )
