"""The simple_norm Lipschitz projection, on tensors.

Counterpart of the JAX package's `constraints/engine.py` (`Constraint`,
`make_simple_norm_constraint`); the other three algorithms wait for a later
slice. The projection is a pure function `(params, cstate) -> (params,
cstate)` that the trainer runs after the Adam update and the NonNeg clamp.
All norm divisions use eps = np.spacing(1), as the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..models.mlp import dense_kernels, set_dense_kernels
from ..ops.cuda_spectral import product_spectral_norm_cuda
from ..ops.spectral import product_spectral_norm_with_state

_EPS = float(np.spacing(1.0))

__all__ = ["Constraint", "make_simple_norm_constraint"]


@dataclasses.dataclass(frozen=True)
class Constraint:
    """A projection to run inside the train step after the Adam update."""

    init: Callable  # params -> cstate
    apply: Callable  # (params, cstate) -> (params, cstate)


def make_simple_norm_constraint(
    rho: float, affected_layers_indices: tuple[int, ...] = (),
    n_iter: int = 16, matvec_dtype: torch.dtype | None = None,
    pi_backend: str = "auto",
) -> Constraint:
    """Algorithm 2 of the reference: sigma = ||W_m^T ... W_1^T||_2 by one
    persistent-u power iteration, then for each affected layer (model order
    for all layers, descending indices for a subset) w_i <- w_i * f with
    f = (rho / (sigma + eps))^(1/m) and sigma <- sigma * f, the exact scalar
    form of the reference's per-layer recompute on the live weights.

    `matvec_dtype=torch.bfloat16` runs the matvecs on once-downcast kernels
    with fp32 sums. `pi_backend`: "cuda" runs the power iteration through
    K2's wrapper (ops/cuda_spectral.py: the kernel on CUDA tensors, its plain
    twin on CPU tensors); "plain" runs the plain twin; "auto" is "cuda" on a
    CUDA tensor and "plain" otherwise.
    """
    if pi_backend not in ("auto", "plain", "cuda"):
        raise ValueError(f"unknown pi_backend {pi_backend!r}")

    def init(params):
        w_last = dense_kernels(params)[-1]
        gen = torch.Generator(device=w_last.device).manual_seed(23)
        return {"u": torch.randn(w_last.shape[1], generator=gen,
                                 device=w_last.device)}

    def apply(params, cstate):
        ws = list(dense_kernels(params))
        m = len(ws)
        affected = (list(range(m)) if not affected_layers_indices
                    else sorted(affected_layers_indices, reverse=True))
        use_cuda = pi_backend == "cuda" or (pi_backend == "auto"
                                            and ws[0].is_cuda)
        if use_cuda:
            sigma, u = product_spectral_norm_cuda(
                ws, cstate["u"], n_iter=n_iter, eps=_EPS,
                matvec_bf16=matvec_dtype is not None)
        else:
            sigma, u = product_spectral_norm_with_state(
                ws, cstate["u"], n_iter=n_iter, eps=_EPS,
                matvec_dtype=matvec_dtype)
        for i in affected:
            factor = (rho / (sigma + _EPS)) ** (1.0 / m)
            ws[i] = ws[i] * factor
            sigma = sigma * factor
        return set_dense_kernels(params, ws), {"u": u}

    # what the trainer's "auto" epoch backend reads to recognize the
    # projection that the fused epoch (K3) implements
    apply._asrtpu_kind = "simple_norm"
    apply._asrtpu_meta = {
        "rho": float(rho),
        "affected_all": not affected_layers_indices,
        "n_iter": int(n_iter),
    }
    return Constraint(init=init, apply=apply)
