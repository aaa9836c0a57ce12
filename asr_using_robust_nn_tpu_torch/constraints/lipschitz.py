"""Lipschitz analyzers and the per-epoch monitor.

Counterpart of the JAX package's `constraints/lipschitz.py`: the
reference's `get_norms` / `get_upper_lipschitz` / `get_lipschitz_constrained`
and its epoch monitor, plus the sound BN-inclusive bound. Norms are exact
(`torch.linalg.matrix_norm(ord=2)`, a float64 SVD; cuSOLVER on the card):
these run once an epoch or once a certificate, not every step. Trees are the port's
tensors on one device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.mlp import MLPConfig, dense_kernels

__all__ = ["get_norms", "get_upper_lipschitz", "get_lipschitz_constrained",
           "get_lipschitz_sound", "lipschitz_monitor"]


def _spectral(w: torch.Tensor) -> torch.Tensor:
    """The largest singular value, from an SVD in float64 rounded back to
    w's dtype: cuSOLVER's float32 SVD read a digit-width network's sound
    bound 1.4e-4 high on an H100, too loose for a certificate."""
    return torch.linalg.matrix_norm(w.double(), ord=2).to(w.dtype)


def get_norms(params) -> torch.Tensor:
    """Spectral norm of each Dense kernel."""
    return torch.stack([_spectral(w) for w in dense_kernels(params)])


def get_upper_lipschitz(norms) -> torch.Tensor:
    """Naive upper bound: the product of the per-layer norms."""
    return torch.prod(torch.as_tensor(norms))


def get_lipschitz_constrained(cfg: MLPConfig, params, state) -> torch.Tensor:
    """||W_m^T ... W_1^T||_2 divided by the BatchNorm correction factor
    prod_i max(sqrt(var_i) / gamma_i), with the moving variance, as the
    reference reads it."""
    cst = None
    for w in reversed(dense_kernels(params)):
        cst = w.T if cst is None else cst @ w.T
    sigma = _spectral(cst)
    correction = torch.ones((), dtype=sigma.dtype, device=sigma.device)
    if cfg.batch_norm:
        for p, s in zip(params["layers"], state["layers"]):
            if "gamma" in p:
                correction = correction * torch.max(
                    torch.sqrt(s["var"]) / p["gamma"])
    return sigma / correction


def get_lipschitz_sound(cfg: MLPConfig, params, state) -> torch.Tensor:
    """Sound inference-time upper bound: prod_i ||W_i||_2 * BN gain_i with
    gain_i = max_j |gamma_ij| / sqrt(var_ij + eps). The reference's
    constrained constant divides by max(sqrt(var)/gamma), which can
    understate the gain where BatchNorm amplifies; ReLU and eval-mode
    dropout are 1-Lipschitz, so this product bounds the whole network."""
    w0 = params["layers"][0]["w"]
    bound = torch.ones((), dtype=torch.float32, device=w0.device)
    for p, s in zip(params["layers"], state["layers"]):
        bound = bound * _spectral(p["w"])
        if cfg.batch_norm and "gamma" in p:
            bound = bound * torch.max(
                torch.abs(p["gamma"]) / torch.sqrt(s["var"] + cfg.bn_eps))
    return bound


def lipschitz_monitor(cfg: MLPConfig, print_fn=print):
    """Epoch callback for Trainer(epoch_callbacks=...): prints the per-layer
    norms and the end-to-end constant, as the reference's callback does."""

    def cb(epoch, params, state, history):
        norms = get_norms(params).cpu().numpy()
        for i, n in enumerate(np.asarray(norms)):
            print_fn(f"The norm for layer dense_{i} is : {n}")
        lip = float(get_lipschitz_constrained(cfg, params, state))
        print_fn(f"The Lipschitz constant on epoch {epoch} is {lip}")
        if cfg.batch_norm:
            sound = float(get_lipschitz_sound(cfg, params, state))
            print_fn(f"  (sound BN-inclusive upper bound: {sound:.4g} — "
                     "see get_lipschitz_sound)")

    return cb
