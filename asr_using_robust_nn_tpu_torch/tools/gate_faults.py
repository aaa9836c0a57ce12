"""Faults planted in one operation of the fused step, for showing that the
fused epoch's parity gate (`ops/cuda_train.py::epoch_parity_vs_plain`)
refuses a wrong kernel.

    gate = epoch_parity_vs_plain(cfg, batch, data, labels, n_true,
                                 candidate=candidate("a", device))

Each fault is a subclass of the twin `_PlainOps` that overrides one
operation:

  a  the JAX package's leaky backward ReLU mask: x^ against the fp32
     threshold -mu * sdinv (`FusedStepSpec.pallas_relu_mask`), where about
     half the dead units pass gradient;
  b  the BN running mean with momentum 0.9 in place of cfg.bn_momentum;
  c  padded rows (weight 0) counted with weight 1 in the BN moments;
  d  simple_norm's per-layer exponent 1/(m - 1) in place of 1/m;
  e  the CE gradient without its 1/sum(w);
  f  NonNeg's clamp skipped on layer 0;

and, for the gate of a FISTA fit (`projection=("fista", ...)`), the faults
of `FISTA_FAULTS`:

  g  K7's step size gamma doubled.

On a card each runs as K3's kernels with the one operation of `_step` that
holds the fault (`CARD_OPS`) taken from the faulty twin, on the card's
tensors. Fault c changes nothing on a corpus without padded rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import cuda_train as ct
from ..ops.cuda_fista import fista_project_twin
from ..ops.spectral import product_spectral_norm_with_state

__all__ = ["FAULTS", "FISTA_FAULTS", "CARD_OPS", "candidate"]


class LeakyReluMask(ct._PlainOps):
    """(a) The backward ReLU mask against the fp32 threshold."""

    def __init__(self, spec):
        super().__init__(spec)
        self.leaky = ct._PlainOps(dataclasses.replace(
            spec, pallas_relu_mask=True))

    def bn_bwd(self, *args):
        return self.leaky.bn_bwd(*args)


class BnMomentum09(ct._PlainOps):
    """(b) The running mean updated with momentum 0.9."""

    def bn_fwd(self, i, a, w, denom, sm, muvec, sdvec, xhat, act_next, seeds,
               s):
        d = a.shape[1]
        old = sm["rmean"][i, :d].clone()
        super().bn_fwd(i, a, w, denom, sm, muvec, sdvec, xhat, act_next,
                       seeds, s)
        if self.spec.cfg.batch_norm:
            sm["rmean"][i, :d] = 0.9 * old + 0.1 * muvec[:d]


class PaddedRowsInMoments(ct._PlainOps):
    """(c) Every row, padding included, weighs 1 in the BN moments."""

    def bn_fwd(self, i, a, w, denom, sm, muvec, sdvec, xhat, act_next, seeds,
               s):
        super().bn_fwd(i, a, torch.ones_like(w),
                       torch.full_like(denom, a.shape[0]), sm, muvec, sdvec,
                       xhat, act_next, seeds, s)


class SimpleNormExponent(ct._PlainOps):
    """(d) The projection's factor per layer (rho / sigma)^(1 / (m - 1))."""

    def project(self, fs, sc):
        spec = self.spec
        m = spec.n_layers
        sigma, u = product_spectral_norm_with_state(
            [w.float() for w in fs["w16"]], fs["u"][0], n_iter=spec.pi_iters,
            eps=ct._EPS, matvec_dtype=ct._BF16)
        fs["u"][0] = u
        inv = float(np.float32(1.0 / (m - 1)))
        for i in range(m):
            f = torch.exp(torch.log(spec.rho / (sigma + ct._EPS)) * inv)
            self.rescale(fs, i, f)
            sigma = sigma * f


class CeGradUnnormalized(ct._PlainOps):
    """(e) dz = (p - onehot) * w, without the 1 / sum(w)."""

    def ce(self, logits, y, w, denom, losses, accs, s, dz):
        super().ce(logits, y, w, denom, losses, accs, s, dz)
        dz.mul_(denom)


class NonNegSkippedOnLayer0(ct._PlainOps):
    """(f) Layer 0's masters are not clamped at 0 after Adam."""

    def __init__(self, spec):
        super().__init__(spec)
        self.free = ct._PlainOps(dataclasses.replace(
            spec, cfg=dataclasses.replace(spec.cfg, nonneg=False)))

    def gemm_dw_adam(self, i, acts, dzb, fs, count, s):
        side = self.free if i == 0 else super()
        return side.gemm_dw_adam(i, acts, dzb, fs, count, s)


class FistaGammaDoubled(ct._PlainOps):
    """(g) The FISTA projection with gamma = 2 / (||A|| ||B|| + eps)^2."""

    def project(self, fs, sc):
        spec = self.spec
        fista_project_twin(list(fs["masters"]), list(fs["w16"]),
                           ct._fista_state_of(fs), spec.dims, spec.rho,
                           spec.nit, spec.alpha, spec.cfg.nonneg,
                           gamma_scale=2.0)


FAULTS = {"a": LeakyReluMask, "b": BnMomentum09, "c": PaddedRowsInMoments,
          "d": SimpleNormExponent, "e": CeGradUnnormalized,
          "f": NonNegSkippedOnLayer0}
FISTA_FAULTS = {"g": FistaGammaDoubled}
# the operation of `_step` that holds each fault (a _CudaOps operation in
# either launch form of `launch_plan`; f's is the grouped weight update, so
# that the card runs the faulty twin in the grouped launch's place)
CARD_OPS = {"a": "dx_bn_bwd", "b": "hidden_fwd", "c": "hidden_fwd",
            "d": "project", "e": "ce_bwd", "f": "dw_adam_all",
            "g": "project"}


def _card_class(name):
    op = CARD_OPS[name]
    plain = {**FAULTS, **FISTA_FAULTS}[name]

    def init(self, spec):
        ct._CudaOps.__init__(self, spec)
        self.faulty = plain(spec)

    def run(self, *args):
        return getattr(self.faulty, op)(*args)

    return type(f"Card{plain.__name__}", (ct._CudaOps,),
                {"__init__": init, op: run,
                 "__doc__": f"K3's kernels with `{op}` from {plain.__name__}"})


def candidate(name: str, device):
    """The gate's `candidate` for fault `name` (`spec -> operations`): the
    faulty twin on the CPU, K3's kernels with the faulty operation on a
    card."""
    if torch.device(device).type == "cuda":
        return _card_class(name)
    return {**FAULTS, **FISTA_FAULTS}[name]
