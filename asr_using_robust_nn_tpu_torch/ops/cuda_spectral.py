"""K2 on Hopper: the product power iteration, its wrapper and its plain twin.
Counterpart of the JAX package's `ops/pallas_spectral.py`
(`product_spectral_norm_pallas`).

  product_spectral_norm_cuda(ws, u, n_iter, eps, matvec_bf16)
      CUDA tensors: one call of csrc/product_power_iter.cu's host entry, which
      enqueues every link of the chain (2 * m * (n_iter + 1) matvec kernels)
      and a finishing kernel on the current stream -> (sigma, u_next).
      CPU tensors: the plain twin, `ops/spectral.py::
      product_spectral_norm_with_state`.
  pi_launch(...)
      the same entry on given buffers, with the simple_norm rescale of the
      bf16 kernels and their f32 masters; the fused epoch (K3,
      ops/cuda_train.py) captures it into its CUDA graph.

A CUDA tensor never falls back to the twin: the kernels launch or the wrapper
raises. `product_spectral_norm_cuda.launches` counts calls that launched.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ._build import load_library
from .spectral import product_spectral_norm_with_state

__all__ = ["product_spectral_norm_cuda", "pi_launch", "pi_scratch",
           "KERNEL_SOURCE", "REPLACES"]

KERNEL_SOURCE = "asr_using_robust_nn_tpu_torch/csrc/product_power_iter.cu"
REPLACES = "asr_using_robust_nn_tpu/ops/pallas_spectral.py:44"
_EPS = float(np.spacing(1.0))
_MAX_DIM = 8192  # one staged vector per block in 48 KB of shared memory


@functools.cache
def _lib():
    lib = load_library("product_power_iter")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.asr_pi_run.argtypes = [ptr, ptr, i32, i32, ptr, ptr, ptr, ptr, i32,
                               f32, f32, f32, ptr, ptr]
    lib.asr_pi_run.restype = i32
    lib.asr_pi_preload.argtypes = []
    lib.asr_pi_preload.restype = i32
    return lib


def preload() -> None:
    """Load every K2 kernel into the current context (before a capture)."""
    rc = _lib().asr_pi_preload()
    if rc != 0:
        raise RuntimeError(f"product_power_iter preload failed: CUDA error {rc}")


def pi_scratch(dims, device) -> torch.Tensor:
    """The fp32 work buffer `pi_launch` needs for a chain of widths `dims`:
    four vectors of the widest width and one factor per layer."""
    return torch.empty(4 * max(dims) + len(dims) - 1, dtype=torch.float32,
                       device=device)


def pi_launch(ws, u_in, u_out, sigma, scratch, n_iter, eps=_EPS, rho=None,
              masters=None) -> None:
    """Enqueue the power iteration on the current stream; no checks beyond
    the C entry's, no allocation, no synchronization (capturable).

    ws: contiguous (d_i, d_{i+1}) kernels, all bf16 or all fp32; u_in/u_out
    (d_m,) fp32 (may be the same buffer); sigma (1,) fp32. With `rho`, the
    bf16 kernels are then rescaled layer by layer by f_i = exp(log(rho /
    (sigma_i + eps)) / m), sigma_{i+1} = sigma_i * f_i, and `masters` (fp32,
    same shapes) by the same factors."""
    m = len(ws)
    dims = [ws[0].shape[0]] + [w.shape[1] for w in ws]
    wptr = (ctypes.c_void_p * m)(*[w.data_ptr() for w in ws])
    dim_arr = (ctypes.c_int * (m + 1))(*dims)
    mptr = None
    if masters is not None:
        mptr = (ctypes.c_void_p * m)(*[w.data_ptr() for w in masters])
    dev = ws[0].device
    with torch.cuda.device(dev):
        rc = _lib().asr_pi_run(
            wptr, dim_arr, m, int(ws[0].dtype == torch.bfloat16),
            u_in.data_ptr(), u_out.data_ptr(), sigma.data_ptr(),
            scratch.data_ptr(), n_iter, eps,
            -1.0 if rho is None else float(rho), float(np.float32(1.0 / m)),
            mptr, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"product_power_iter launch failed: CUDA error {rc}")


def product_spectral_norm_cuda(ws, u, n_iter: int = 16, eps: float = _EPS,
                               matvec_bf16: bool = True):
    """(sigma, u_next) = power iteration for ||W_m^T ... W_1^T||_2.

    `ws`: fp32 (d_in, d_out) kernels in model order; `u`: the persistent
    (d_out_last,) vector. On CUDA tensors the kernels are cast once (to bf16
    when `matvec_bf16`) and K2 runs the chain; on CPU tensors the plain twin
    does. Any other device raises."""
    if all(w.device.type == "cpu" for w in ws) and u.device.type == "cpu":
        return product_spectral_norm_with_state(
            list(ws), u, n_iter=n_iter, eps=eps,
            matvec_dtype=torch.bfloat16 if matvec_bf16 else None)
    dev = u.device
    if not u.is_cuda or any(w.device != dev for w in ws):
        raise ValueError("product_spectral_norm_cuda: every tensor must be on "
                         f"one CUDA device (u on {dev})")
    if u.dtype != torch.float32 or u.dim() != 1:
        raise ValueError("product_spectral_norm_cuda: u must be a 1-D float32 "
                         f"tensor, got {tuple(u.shape)} {u.dtype}")
    for a, b in zip(ws[:-1], ws[1:]):
        if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
            raise ValueError("product_spectral_norm_cuda: kernels do not chain")
    if ws[-1].shape[1] != u.shape[0]:
        raise ValueError("product_spectral_norm_cuda: u does not match the "
                         "last kernel's width")
    dims = [ws[0].shape[0]] + [w.shape[1] for w in ws]
    if max(dims) > _MAX_DIM:
        raise ValueError(f"product_spectral_norm_cuda: widths up to "
                         f"{_MAX_DIM}, got {max(dims)}")
    wdt = torch.bfloat16 if matvec_bf16 else torch.float32
    wk = [w.to(wdt).contiguous() for w in ws]
    u_out = torch.empty_like(u)
    sigma = torch.empty(1, dtype=torch.float32, device=dev)
    pi_launch(wk, u.contiguous(), u_out, sigma, pi_scratch(dims, dev), n_iter,
              eps)
    product_spectral_norm_cuda.launches += 1
    return sigma[0], u_out


product_spectral_norm_cuda.launches = 0
