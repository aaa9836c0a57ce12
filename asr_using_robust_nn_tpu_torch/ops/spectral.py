"""Spectral norms by power iteration, in plain PyTorch.

Counterpart of the JAX package's `ops/spectral.py`:
`spectral_norm_with_state` (one matrix, the per-layer norm constraint) and
`product_spectral_norm_with_state`, with their stateless forms
`spectral_norm` and `product_spectral_norm`. The latter is also the plain twin of K2
(`ops/cuda_spectral.py`): with `matvec_dtype=torch.bfloat16` the kernels are
rounded to bf16 once, the vector is rounded to bf16 before every link, and
each matvec sums its bf16-exact products in fp32.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["spectral_norm", "spectral_norm_with_state",
           "product_spectral_norm", "product_spectral_norm_with_state",
           "no_tf32"]

_EPS = 1e-12


@contextlib.contextmanager
def no_tf32():
    """CUDA matmuls in fp32, never TF32; the caller's setting is restored."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _l2_normalize(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.sqrt(torch.sum(v * v)) + _EPS)


def spectral_norm(w: torch.Tensor, n_iter: int = 32,
                  u0: torch.Tensor | None = None) -> torch.Tensor:
    """Largest singular value of a 2-D matrix by power iteration from `u0`
    (None: the seeded start of `spectral_norm_with_state`); a 0-d tensor."""
    return spectral_norm_with_state(w, u0, n_iter)[0]


def spectral_norm_with_state(
    w: torch.Tensor, u: torch.Tensor | None = None, n_iter: int = 8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(sigma, u_next): the largest singular value of a 2-D `w` by power
    iteration with a persistent left vector `u` of shape (w.shape[0],),
    carried across train steps so a few rounds a step suffice. Without `u`
    the start is a seeded normal draw (the JAX package's differs)."""
    if u is None:
        gen = torch.Generator(device=w.device).manual_seed(
            w.shape[0] * 7919 + w.shape[1])
        u = torch.randn(w.shape[0], generator=gen, device=w.device,
                        dtype=w.dtype)
    with no_tf32():
        u = _l2_normalize(u)
        for _ in range(n_iter):
            u = _l2_normalize(w @ _l2_normalize(w.T @ u))
        v = _l2_normalize(w.T @ u)
        return u @ (w @ v), u


def product_spectral_norm_with_state(
    ws: list[torch.Tensor],
    u: torch.Tensor,
    n_iter: int = 64,
    eps: float = _EPS,
    matvec_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(sigma, u_next) for ||W_m^T @ ... @ W_1^T||_2 without forming the
    product, with a persistent left vector `u` of shape (ws[-1].shape[1],).
    `sigma` is a 0-d tensor; `u_next` is the normalized vector after the
    last round. CUDA matmuls run without TF32; the caller's setting is
    restored on return.
    """
    with no_tf32():
        return _power_iteration(ws, u, n_iter, eps, matvec_dtype)


def product_spectral_norm(ws: list[torch.Tensor],
                          n_iter: int = 64) -> torch.Tensor:
    """sigma of W_m^T @ ... @ W_1^T from a cold start: a seeded normal draw
    of shape (ws[-1].shape[1],) (the JAX package's start differs), n_iter
    rounds of the stateful form; a 0-d tensor."""
    d_out = ws[-1].shape[1]
    gen = torch.Generator(device=ws[0].device).manual_seed(
        d_out * 31 + len(ws))
    u = torch.randn(d_out, generator=gen, device=ws[0].device)
    return product_spectral_norm_with_state(ws, u, n_iter)[0]


def _power_iteration(ws, u, n_iter, eps, matvec_dtype):
    def nrm(v):
        return v / (torch.sqrt(torch.sum(v * v)) + eps)

    if matvec_dtype is not None:
        mws = [w.to(matvec_dtype).float() for w in ws]

        def cast(x):
            return x.to(matvec_dtype).float()
    else:
        mws = [w.float() for w in ws]

        def cast(x):
            return x

    def apply(x):  # P^T x = W_1 ... W_m x
        for w in reversed(mws):
            x = w @ cast(x)
        return x

    def apply_t(x):  # P x = W_m^T ... W_1^T x
        for w in mws:
            x = w.T @ cast(x)
        return x

    u = nrm(u.float())
    for _ in range(n_iter):
        u = nrm(apply_t(nrm(apply(u))))
    v = nrm(apply(u))
    return torch.sum(u * apply_t(v)), u
