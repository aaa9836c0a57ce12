"""K2 on Hopper: the product power iteration, its wrapper and its plain twins.
Counterpart of the JAX package's `ops/pallas_spectral.py`
(`product_spectral_norm_pallas`), whose Pallas kernel `_pi_kernel` it
replaces.

  product_spectral_norm_cuda(ws, u, n_iter, eps, matvec_bf16)
      CUDA tensors: ONE launch of csrc/product_power_iter.cu on a thread-block
      cluster runs all 2 * m * (n_iter + 1) links and the finish ->
      (sigma, u_next). CPU tensors: the plain twin,
      `ops/spectral.py::product_spectral_norm_with_state`.
  pi_launch(...)
      the same launch on given buffers, with the simple_norm rescale of the
      bf16 kernels and their f32 masters in it; the fused epoch (K3,
      ops/cuda_train.py) and the fused step (K6, ops/cuda_step.py) capture it
      into their CUDA graphs, after `preload()`.
  pi_plan(dims, cluster, wbf16)
      the host-side partition plan the kernel is launched with: which block
      of the cluster owns which rows of each layer, which layers stay
      resident in shared memory, and the bytes a block needs. Pure.
  product_spectral_norm_partitioned(...)
      a plain twin that sums every matvec and every norm in the plan's
      order (per block, then over the blocks in rank order).

What bounds K2 on an H100 is latency: 204 dependent matvecs over 3.2 MB of
bf16 weights at the digit recipe. The cluster form separates the links by
exchanges through distributed shared memory (st.async stores counted by
transaction barriers) instead of launches and keeps the weights in the
cluster's shared memory (see the kernel's header). It needs a device that can
schedule a cluster of `CLUSTER_SIZE` blocks with 227 KB of shared memory each
(an H100: 16 SMs of one GPC); `preload()` raises when it cannot.

A CUDA tensor never falls back to a twin: the kernel launches or the wrapper
raises. `product_spectral_norm_cuda.launches` counts calls that launched.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ._build import load_library
from .spectral import product_spectral_norm_with_state

__all__ = ["product_spectral_norm_cuda", "pi_launch", "preload", "pi_plan",
           "PiPlan", "product_spectral_norm_partitioned",
           "CLUSTER_SIZE", "KERNEL_SOURCE", "REPLACES"]

KERNEL_SOURCE = "asr_using_robust_nn_tpu_torch/csrc/product_power_iter.cu"
REPLACES = "asr_using_robust_nn_tpu/ops/pallas_spectral.py:44"
_EPS = float(np.spacing(1.0))
_MAX_DIM = 8192      # widths the kernel's shared-memory vectors are sized for
_MAX_LAYERS = 16
_THREADS = 512       # threads of a block (csrc/product_power_iter.cu)
SMEM_MAX = 232448    # shared memory one block may use on an H100
CLUSTER_SIZE = 16    # blocks of the cluster; 8 is the portable size


class PiPlan(NamedTuple):
    """How one cluster launch cuts a chain of widths `dims`."""
    dims: tuple
    cluster: int
    esize: int          # bytes of one weight
    per: tuple          # per[i]: entries of dimension i a block owns (4 | per)
    resident: tuple     # resident[j]: layer j's slices stay in shared memory
    res_off: tuple      # byte offset of layer j's slice in a block, or -1
    vec_bytes: int      # the vectors, inboxes and reduction scratch
    smem_bytes: int     # dynamic shared memory of one block

    def owned(self, i: int, rank: int) -> tuple:
        """[lo, hi) of dimension i that block `rank` owns: rows of layer i
        and entries of every vector of that width."""
        lo = min(rank * self.per[i], self.dims[i])
        return lo, min(lo + self.per[i], self.dims[i])

    def ranks(self, i: int) -> int:
        """Blocks that own a non-empty slice of dimension i."""
        return -(-self.dims[i] // self.per[i])


@functools.lru_cache(maxsize=64)
def pi_plan(dims: tuple, cluster: int = CLUSTER_SIZE,
            wbf16: bool = True) -> PiPlan:
    """The partition plan for a chain of widths `dims` on `cluster` blocks.

    Dimension i is cut into contiguous slices of per[i] = ceil(d_i / cluster)
    rounded up to a multiple of 4 (so four neighbouring entries share an
    owner and move as one 16-byte word); trailing blocks may own nothing.
    Layers are made resident largest first while a block's widest slice of
    each still fits beside the vectors in `SMEM_MAX` bytes; the others are
    read from global memory."""
    dims = tuple(int(d) for d in dims)
    m = len(dims) - 1
    if m < 1 or m > _MAX_LAYERS:
        raise ValueError(f"pi_plan: 1..{_MAX_LAYERS} layers, got {m}")
    if min(dims) < 1 or max(dims) > _MAX_DIM:
        raise ValueError(f"pi_plan: widths 1..{_MAX_DIM}, got {dims}")
    if cluster not in (1, 2, 4, 8, 16):
        raise ValueError(f"pi_plan: cluster size {cluster}")
    esize = 2 if wbf16 else 4
    per = tuple(_round4(-(-d // cluster)) for d in dims)
    segmax = max(per)
    vec_floats = (2 * _round4(max(dims)) + _round4(dims[m]) + segmax
                  + 2 * cluster * segmax + 4 * cluster + 4 * _THREADS + 32
                  + 80)
    vec_bytes = 4 * vec_floats
    if vec_bytes > SMEM_MAX:
        raise ValueError(f"pi_plan: the vectors of {dims} need {vec_bytes} "
                         f"bytes of shared memory, over {SMEM_MAX}")
    slices = [per[j] * dims[j + 1] * esize for j in range(m)]
    used = _round16(vec_bytes)
    res_off = [-1] * m
    for j in sorted(range(m), key=lambda j: -slices[j]):
        if used + slices[j] <= SMEM_MAX:
            res_off[j] = used
            used = _round16(used + slices[j])
    return PiPlan(dims, cluster, esize, per,
                  tuple(o >= 0 for o in res_off), tuple(res_off), vec_bytes,
                  min(used, SMEM_MAX))


def _round4(x: int) -> int:
    return (x + 3) & ~3


def _round16(x: int) -> int:
    return (x + 15) & ~15


def product_spectral_norm_partitioned(ws, u, n_iter: int = 16,
                                      eps: float = _EPS,
                                      matvec_bf16: bool = True,
                                      cluster: int = CLUSTER_SIZE):
    """(sigma, u_next) as `product_spectral_norm_with_state`, with every sum
    taken in the cluster kernel's order: a P link (W^T x) as per-block
    partials over the block's rows, added in rank order; a norm as per-block
    partial sums of squares, added in rank order. The plain twin of the
    partition, for any device."""
    dims = (ws[0].shape[0],) + tuple(w.shape[1] for w in ws)
    plan = pi_plan(dims, cluster, matvec_bf16)
    m = len(ws)
    if matvec_bf16:
        mws = [w.to(torch.bfloat16).float() for w in ws]

        def cast(x):
            return x.to(torch.bfloat16).float()
    else:
        mws = [w.float() for w in ws]

        def cast(x):
            return x

    def ordered(parts):
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total

    def nrm(x, i):
        ssq = ordered([torch.sum(x[lo:hi] * x[lo:hi]) for lo, hi in
                       (plan.owned(i, c) for c in range(plan.ranks(i)))])
        return x / (torch.sqrt(ssq) + eps)

    def apply(x):  # P^T x: row dots, block by block
        for j in reversed(range(m)):
            x = mws[j] @ cast(x)
        return x

    def apply_t(x):  # P x: partials over each block's rows, in rank order
        for j in range(m):
            xc = cast(x)
            x = ordered([mws[j][lo:hi].T @ xc[lo:hi] for lo, hi in
                         (plan.owned(j, c) for c in range(plan.ranks(j)))])
        return x

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 sums, never TF32
    try:
        u = u.float()
        u = u / (torch.sqrt(torch.sum(u * u)) + eps)
        for _ in range(n_iter):
            u = nrm(apply_t(nrm(apply(u), 0)), m)
        v = nrm(apply(u), 0)
        return torch.sum(u * apply_t(v)), u
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@functools.cache
def _lib():
    lib = load_library("product_power_iter")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.asr_pi_run.argtypes = [ptr, ptr, i32, i32, ptr, ptr, ptr, i32, f32,
                               f32, f32, ptr, i32, ptr, ptr, i32, ptr]
    lib.asr_pi_run.restype = i32
    lib.asr_pi_preload.argtypes = [i32, ptr]
    lib.asr_pi_preload.restype = i32
    return lib


def preload() -> int:
    """Load K2's kernels into the current device's context and set their
    attributes (before a capture), once per device. Returns how many
    clusters of `CLUSTER_SIZE` blocks the device can hold at once; raises
    when it can hold none, since a launch of such a cluster could never be
    scheduled."""
    return _preload(torch.cuda.current_device())


@functools.cache
def _preload(device_index: int) -> int:
    held = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = _lib().asr_pi_preload(CLUSTER_SIZE, ctypes.byref(held))
    if rc != 0:
        raise RuntimeError(f"product_power_iter preload failed: CUDA error {rc}")
    if held.value < 1:
        raise RuntimeError(
            f"product_power_iter: this device cannot schedule a cluster of "
            f"{CLUSTER_SIZE} blocks with {SMEM_MAX} bytes of shared memory each "
            f"(cudaOccupancyMaxActiveClusters = 0)")
    return held.value


def pi_launch(ws, u_in, u_out, sigma, n_iter, eps=_EPS, rho=None,
              masters=None) -> None:
    """Enqueue the power iteration as one launch on a cluster of
    `CLUSTER_SIZE` blocks on the current stream; no checks beyond the plan's
    and the C entry's, no allocation, no synchronization (capturable; call
    `preload()` before a capture). Every vector, inbox and factor lives in
    the cluster's shared memory, so there is no device work buffer.

    ws: contiguous (d_i, d_{i+1}) kernels, all bf16 or all fp32; u_in/u_out
    (d_m,) fp32 (may be the same buffer); sigma (1,) fp32. With `rho`, the
    bf16 kernels are then rescaled layer by layer by f_i = exp(log(rho /
    (sigma_i + eps)) / m), sigma_{i+1} = sigma_i * f_i, and `masters` (fp32,
    same shapes) by the same factors, in the same launch."""
    m = len(ws)
    wbf16 = ws[0].dtype == torch.bfloat16
    dims = (ws[0].shape[0],) + tuple(w.shape[1] for w in ws)
    plan = pi_plan(dims, CLUSTER_SIZE, wbf16)
    wptr = (ctypes.c_void_p * m)(*[w.data_ptr() for w in ws])
    dim_arr = (ctypes.c_int * (m + 1))(*dims)
    per_arr = (ctypes.c_int * (m + 1))(*plan.per)
    off_arr = (ctypes.c_int * m)(*plan.res_off)
    mptr = None
    if masters is not None:
        mptr = (ctypes.c_void_p * m)(*[w.data_ptr() for w in masters])
    dev = ws[0].device
    with torch.cuda.device(dev):
        rc = _lib().asr_pi_run(
            wptr, dim_arr, m, int(wbf16), u_in.data_ptr(), u_out.data_ptr(),
            sigma.data_ptr(), n_iter, eps,
            -1.0 if rho is None else float(rho), float(np.float32(1.0 / m)),
            mptr, CLUSTER_SIZE, per_arr, off_arr, plan.smem_bytes,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"product_power_iter launch failed: CUDA error {rc}")


def product_spectral_norm_cuda(ws, u, n_iter: int = 16, eps: float = _EPS,
                               matvec_bf16: bool = True):
    """(sigma, u_next) = power iteration for ||W_m^T ... W_1^T||_2.

    `ws`: fp32 (d_in, d_out) kernels in model order; `u`: the persistent
    (d_out_last,) vector. On CUDA tensors the kernels are cast once (to bf16
    when `matvec_bf16`) and K2 runs the chain in one launch on a cluster of
    `CLUSTER_SIZE` blocks; on CPU tensors the plain twin does. Any other device
    raises, as do more than 16 layers or a width over 8192."""
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
    if len(ws) > _MAX_LAYERS:
        raise ValueError(f"product_spectral_norm_cuda: at most {_MAX_LAYERS} "
                         f"layers, got {len(ws)}")
    wdt = torch.bfloat16 if matvec_bf16 else torch.float32
    wk = [w.to(wdt).contiguous() for w in ws]
    u_out = torch.empty_like(u)
    sigma = torch.empty(1, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        preload()
    pi_launch(wk, u.contiguous(), u_out, sigma, n_iter, eps)
    product_spectral_norm_cuda.launches += 1
    return sigma[0], u_out


product_spectral_norm_cuda.launches = 0
