"""The four Lipschitz constraint algorithms, as projections on tensors.

Counterpart of the JAX package's `constraints/engine.py`. Each algorithm is
a pure function `(params, cstate) -> (params, cstate)` that the trainer runs
after the Adam update and the NonNeg clamp:

  1. make_norm_constraint        per layer: clamp w >= 0, rescale each kernel
                                 to spectral norm rho^(1/m) by power
                                 iteration with a persistent u per layer
  2. make_custom_constraint      clamp w >= 0, scale by rho / ||w|| where
                                 ||.|| is the Frobenius norm: the
                                 reference's tf.norm(w, ord=2) on a 2-D
                                 tensor is Frobenius (docs/PARITY.md #4),
                                 kept for parity
  3. make_fista_constraint       FISTA projection of each kernel so that the
                                 whole-network product A W B has singular
                                 values <= rho (two SVDs an iteration,
                                 cuSOLVER on the card); in the fused epoch
                                 (K3) it runs as K7, ops/cuda_fista.py
  4. make_simple_norm_constraint scale every kernel by
                                 (rho / ||W_m^T ... W_1^T||_2)^(1/m), the
                                 product norm by K2 on a CUDA tensor

All norm divisions use eps = np.spacing(1), as the reference does.

K2's limits (ops/cuda_spectral.py): at most 16 layers and widths up to
8192, on a device that can schedule one 16-block cluster. They are hard and
there is no step-down: with `pi_backend="auto"` a CUDA chain outside them
raises instead of running the plain twin. All four MLP presets fit.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..models.mlp import dense_kernels, set_dense_kernels
from ..ops.cuda_spectral import product_spectral_norm_cuda
from ..ops.spectral import (no_tf32, product_spectral_norm_with_state,
                            spectral_norm_with_state)

_EPS = float(np.spacing(1.0))

__all__ = ["Constraint", "make_norm_constraint", "make_custom_constraint",
           "make_simple_norm_constraint", "make_fista_constraint"]


@dataclasses.dataclass(frozen=True)
class Constraint:
    """A projection to run inside the train step after the Adam update."""

    init: Callable  # params -> cstate
    apply: Callable  # (params, cstate) -> (params, cstate)


def _init_u_per_layer(params) -> dict:
    """One seeded start vector per kernel, of its input width; draws differ
    from the JAX package's (threefry), so parity tests carry u across."""
    out = []
    for i, w in enumerate(dense_kernels(params)):
        gen = torch.Generator(device=w.device).manual_seed(17 + i)
        out.append(torch.randn(w.shape[0], generator=gen, device=w.device,
                               dtype=w.dtype))
    return {"u": out}


def make_norm_constraint(rho: float, n_iter: int = 8) -> Constraint:
    """Algorithm 1: after each batch w <- relu(w) * rho^(1/m) /
    (sigma(w) + eps) for every Dense kernel, sigma by `n_iter` rounds of
    power iteration on the layer's persistent u."""

    def apply(params, cstate):
        ws = dense_kernels(params)
        m = len(ws)
        new_ws, new_us = [], []
        for w, u in zip(ws, cstate["u"]):
            w = w * (w >= 0.0)
            sigma, u = spectral_norm_with_state(w, u, n_iter)
            new_ws.append(w * (rho ** (1.0 / m)) / (sigma + _EPS))
            new_us.append(u)
        return set_dense_kernels(params, new_ws), {"u": new_us}

    return Constraint(init=_init_u_per_layer, apply=apply)


def make_custom_constraint(rho: float) -> Constraint:
    """The reference's in-graph Keras constraint: w <- relu(w) * rho /
    (||w||_F + eps). Frobenius by reference parity."""

    def apply(params, cstate):
        ws = []
        for w in dense_kernels(params):
            w = w * (w >= 0.0)
            ws.append(w * rho / (torch.linalg.norm(w) + _EPS))
        return set_dense_kernels(params, ws), cstate

    return Constraint(init=lambda params: (), apply=apply)


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


def make_fista_constraint(rho: float, nit: int = 2,
                          alpha: float = 2.1) -> Constraint:
    """Algorithm 3: for each layer i, project W_i so that the end-to-end
    product A @ W_i^T @ B has singular values <= rho, where A = W_m^T ...
    W_{i+1}^T and B = W_{i-1}^T ... W_1^T, by the reference's FISTA dual
    iteration (`_fista_project`). Layers run in model order on the live
    weights: B is built from the layers already projected in this call, A
    from those not yet projected."""

    def apply(params, cstate):
        ws = list(dense_kernels(params))
        m = len(ws)
        with no_tf32():
            # A_i reads only layers not yet projected (layer j is replaced at
            # loop step j > i), so the left-associated suffix chain is built
            # once, the same products in the same order. B_i reads projected
            # layers and the reference multiplies it highest index first; an
            # incremental prepend would change the float association, so B
            # is rebuilt per layer.
            suffix: list = [None] * m
            acc = None
            for j in range(m - 1, -1, -1):
                suffix[j] = acc
                acc = ws[j].T if acc is None else acc @ ws[j].T
            for i in range(m):
                a = suffix[i]
                if a is None:
                    a = torch.eye(ws[i].shape[1], dtype=ws[i].dtype,
                                  device=ws[i].device)
                b = None
                for j in range(i - 1, -1, -1):
                    t = ws[j].T
                    b = t if b is None else b @ t
                if b is None:
                    b = torch.eye(ws[i].shape[0], dtype=ws[i].dtype,
                                  device=ws[i].device)
                ws[i] = _fista_project(ws[i].T, a, b, rho, nit, alpha).T
        return set_dense_kernels(params, ws), cstate

    # what the trainer's "auto" epoch backend reads to recognize the
    # projection that the fused epoch (K3 with K7) implements
    apply._asrtpu_kind = "fista"
    apply._asrtpu_meta = {"rho": float(rho), "nit": int(nit),
                          "alpha": float(alpha)}
    return Constraint(init=lambda params: (), apply=apply)


def _fista_project(w, a, b, rho, nit, alpha):
    """The reference's FISTA inner loop on w = W_i^T: at most `nit`
    iterations, leaving early once ||w_new - w||_F < 30 and the singular
    excess ||max(s - rho, 0)|| < 0.01 (the JAX package's lax.while_loop with
    the same condition; here a Python loop that reads both to the host)."""
    sig_a = torch.linalg.matrix_norm(a, ord=2)
    sig_b = torch.linalg.matrix_norm(b, ord=2)
    gam = 1.0 / ((sig_a * sig_b + _EPS) ** 2)
    y = yold = torch.zeros((a.shape[0], b.shape[1]), dtype=w.dtype,
                           device=w.device)
    w_new = w
    i = 0
    while i < nit:
        eta = i / (i + 1.0 + alpha)
        z = y + eta * (y - yold)
        yold = y
        w_cand = w - a.T @ z @ b.T
        w_cand = w_cand * (w_cand >= 0.0)
        t = a @ w_cand @ b
        s = torch.linalg.svdvals(t)
        criterion = torch.linalg.norm(w_cand - w)
        constraint = torch.linalg.norm(torch.where(s > rho, s - rho, 0.0))
        yt = z + gam * t
        u1, s1, v1 = torch.linalg.svd(yt / gam, full_matrices=False)
        y = yt - gam * ((u1 * torch.clamp(s1, 0.0, rho)) @ v1)
        w_new = w_cand
        i += 1
        if bool((criterion < 30.0) & (constraint < 0.01)):
            break
    return w_new
