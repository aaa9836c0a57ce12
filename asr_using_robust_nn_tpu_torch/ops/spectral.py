"""Product spectral norm by power iteration, in plain PyTorch.

Counterpart of the JAX package's `ops/spectral.py::
product_spectral_norm_with_state`. It is also the plain twin of K2
(`ops/cuda_spectral.py`): with `matvec_dtype=torch.bfloat16` the kernels are
rounded to bf16 once, the vector is rounded to bf16 before every link, and
each matvec sums its bf16-exact products in fp32.
"""

from __future__ import annotations

import torch

__all__ = ["product_spectral_norm_with_state"]

_EPS = 1e-12


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
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 sums, never TF32
    try:
        return _power_iteration(ws, u, n_iter, eps, matvec_dtype)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


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
