"""The plain reference of the FISTA-constrained digit recipe: the thesis
MLP's training step (reference/mlp.py's model, loss, Adam and NonNeg, drawn
in the trainer's order) with the FISTA projection of `Constraints.py` in
place of simple_norm, in plain PyTorch at float32 (TF32 off).

    for layer i = 0 .. m-1 in model order, on the live weights:
      A = W_{m-1}^T ... W_{i+1}^T   (left to right, the layers not yet
                                     projected; the identity for the last)
      B = W_{i-1}^T ... W_0^T       (left to right, the layers projected;
                                     the identity for the first)
      gamma = 1 / (||A||_2 ||B||_2 + eps)^2        (exact 2-norms)
      w = W_i^T; y = y_old = 0
      for k < nit:
        eta = k / (k + 1 + alpha); z = y + eta (y - y_old); y_old = y
        w_new = relu(w - A^T z B^T); t = A w_new B
        s = sigma(t); criterion = ||w_new - w||_F
        constraint = ||max(s - rho, 0)||
        y_t = z + gamma t; U S V^T = svd(y_t / gamma)
        y = y_t - gamma U clip(S, 0, rho) V^T
        if criterion < 30 and constraint < 0.01: stop
      W_i = w_new^T

`proj_prec="bf16"` rounds both operands of every product of the projection
to bfloat16 (fp32 sums): the control one precision below the float32 the
configuration states for it. Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

from .mlp import (_train_forward, _val_loss, derived_generator, keep_mask,
                  precision)

__all__ = ["fista_project", "train_epochs"]

_EPS = float(np.spacing(1.0))


def _pm(a: torch.Tensor, b: torch.Tensor, proj_prec: str) -> torch.Tensor:
    if proj_prec == "bf16":
        return a.bfloat16().float() @ b.bfloat16().float()
    return a @ b


def _project_layer(w, a, b, rho, nit, alpha, proj_prec):
    sig_a = torch.linalg.matrix_norm(a, ord=2)
    sig_b = torch.linalg.matrix_norm(b, ord=2)
    gam = 1.0 / ((sig_a * sig_b + _EPS) ** 2)
    y = y_old = torch.zeros((a.shape[0], b.shape[1]), dtype=w.dtype,
                            device=w.device)
    w_new = w
    for k in range(nit):
        eta = k / (k + 1.0 + alpha)
        z = y + eta * (y - y_old)
        y_old = y
        w_new = torch.relu(w - _pm(_pm(a.T, z, proj_prec), b.T, proj_prec))
        t = _pm(_pm(a, w_new, proj_prec), b, proj_prec)
        s = torch.linalg.svdvals(t)
        criterion = torch.linalg.norm(w_new - w)
        constraint = torch.linalg.norm(torch.clamp_min(s - rho, 0.0))
        y_t = z + gam * t
        u, s1, vh = torch.linalg.svd(y_t / gam, full_matrices=False)
        y = y_t - gam * _pm(u * torch.clamp(s1, 0.0, rho), vh, proj_prec)
        if bool(criterion < 30.0) and bool(constraint < 0.01):
            break
    return w_new


def fista_project(ws: list, rho: float, nit: int, alpha: float,
                  proj_prec: str = "fp32") -> list:
    """The FISTA projection of the kernels `ws` (Keras layout, d_i x
    d_{i+1}) in model order, in their precision -> the projected kernels."""
    ws = list(ws)
    m = len(ws)
    for i in range(m):
        a = None
        for j in range(m - 1, i, -1):
            a = ws[j].T if a is None else _pm(a, ws[j].T, proj_prec)
        if a is None:
            a = torch.eye(ws[i].shape[1], dtype=ws[i].dtype,
                          device=ws[i].device)
        b = None
        for j in range(i - 1, -1, -1):
            b = ws[j].T if b is None else _pm(b, ws[j].T, proj_prec)
        if b is None:
            b = torch.eye(ws[i].shape[0], dtype=ws[i].dtype,
                          device=ws[i].device)
        ws[i] = _project_layer(ws[i].T, a, b, rho, nit, alpha, proj_prec).T
    return ws


def train_epochs(model, params: list, state: list, x, y, vx, vy, *,
                 batch: int, epochs: int, lr: float, rho: float, nit: int,
                 alpha: float, seed: int, prec: str = "fp32",
                 proj_prec: str = "fp32", fault: str | None = None) -> dict:
    """reference/mlp.py::train_epochs (the fused epoch's draws) with the
    FISTA projection after each step's Adam update and NonNeg clamp. `prec`
    sets the model's products (as there), `proj_prec` the projection's;
    `fault` "half_batch" trains each step on the first half of its rows.
    -> {"loss", "val_loss", "params", "state", "mu", "g1"}."""
    dev = x.device
    n = x.shape[0]
    rows_run = -(-batch // 64) * 64
    keep = [1.0 - r for r in model.dropout]
    p = [{k: v.detach().clone() for k, v in layer.items()} for layer in params]
    st = [{k: v.detach().clone() for k, v in layer.items()} for layer in state]
    mu = [{k: torch.zeros_like(v) for k, v in layer.items()} for layer in p]
    nu = [{k: torch.zeros_like(v) for k, v in layer.items()} for layer in p]
    perm = torch.randperm(n, generator=derived_generator(dev, seed, 1, 0),
                          device=dev)
    n_batches = -(-n // batch)
    count = 0
    losses, val_losses = [], []
    with precision(prec):
        for epoch in range(epochs):
            drop_gen = derived_generator(dev, seed, 2, epoch)
            seeds = torch.randint(0, 2 ** 31 - 1, (n_batches,),
                                  dtype=torch.int32, device=dev,
                                  generator=drop_gen).tolist()
            ep_loss = torch.zeros((), dtype=torch.float64, device=dev)
            for s in range(n_batches):
                full = perm[s * batch:(s + 1) * batch]
                idx = full
                if fault == "half_batch":
                    idx = full[: max(1, full.shape[0] // 2)]
                rows = idx.shape[0]
                masks = [keep_mask(seeds[s], i, rows_run,
                                   -(-model.dims[i + 1] // 128) * 128,
                                   keep[i], dev)[:rows, :model.dims[i + 1]]
                         if i < len(keep) and keep[i] < 1.0 else None
                         for i in range(model.n_layers - 1)]
                leaves = [t.requires_grad_(True) for layer in p
                          for t in layer.values()]
                with torch.enable_grad():
                    logits, moments = _train_forward(model, p, st, x[idx],
                                                     masks, prec)
                    loss = torch.nn.functional.cross_entropy(logits, y[idx])
                    grads = torch.autograd.grad(loss, leaves)
                ep_loss += loss.detach().double() * full.shape[0]
                count += 1
                if count == 1:
                    g_it = iter(grads)
                    g1 = [{k: next(g_it).detach().clone() for k in layer}
                          for layer in p]
                bc1, bc2 = 1.0 - 0.9 ** count, 1.0 - 0.999 ** count
                g_it = iter(grads)
                with torch.no_grad():
                    for i, layer in enumerate(p):
                        for k in layer:
                            g = next(g_it)
                            m_ = mu[i][k].mul_(0.9).add_(0.1 * g)
                            v_ = nu[i][k].mul_(0.999).add_(0.001 * g * g)
                            upd = (m_ / bc1) / (torch.sqrt(v_ / bc2) + 1e-7)
                            layer[k] = layer[k].detach() - lr * upd
                        if model.nonneg:
                            layer["w"] = torch.clamp_min(layer["w"], 0.0)
                    for i, (mean, var) in enumerate(moments):
                        mom = model.bn_momentum
                        st[i]["mean"] = mom * st[i]["mean"] + (1 - mom) * mean
                        st[i]["var"] = mom * st[i]["var"] + (1 - mom) * var
                    with precision("fp32"):
                        ws = fista_project([layer["w"] for layer in p], rho,
                                           nit, alpha, proj_prec)
                    for layer, w in zip(p, ws):
                        layer["w"] = w
            losses.append(float(ep_loss) / n)
            with torch.no_grad():
                val_losses.append(_val_loss(model, p, st, vx, vy, prec))
    detach = lambda tree: [{k: v.detach() for k, v in layer.items()}  # noqa
                           for layer in tree]
    return {"loss": losses, "val_loss": val_losses, "params": detach(p),
            "state": detach(st), "mu": detach(mu), "g1": g1}
