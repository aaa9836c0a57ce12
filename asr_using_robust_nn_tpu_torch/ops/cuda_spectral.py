"""K2 on Hopper: the product power iteration, its wrapper and its plain twins.
Counterpart of the JAX package's `ops/pallas_spectral.py`
(`product_spectral_norm_pallas`), whose Pallas kernel `_pi_kernel` it
replaces.

  product_spectral_norm_cuda(ws, u, n_iter, eps, matvec_bf16)
      CUDA tensors: ONE launch of csrc/product_power_iter.cu on a thread-block
      cluster runs the whole iteration and the finish -> (sigma, u_next).
      CPU tensors: the plain twin,
      `ops/spectral.py::product_spectral_norm_with_state`.
  pi_launch(...)
      the same launch on given buffers, at given true widths inside padded
      buffers, with the simple_norm rescale of the bf16 kernels and their f32
      masters in it; the fused epoch (K3, ops/cuda_train.py) and the fused
      step (K6, ops/cuda_step.py) capture it into their CUDA graphs, after
      `preload()`. Counts `k2.gram` or `k2.chain` (`utils/profiling.py::
      count`) once a call.
  pi_plan(dims, cluster, wbf16)
      the host-side plan the kernel is launched with, from the widths alone:
      the form (product or chain), which block of the cluster owns which
      rows of each layer, which layers of the chain form stay resident in
      shared memory, and the bytes a block needs. Pure.
  product_spectral_norm_gram(...)
      the plain twin of the product form: the kernel's partition, summation
      runs and rank-order sums, with fp32 fmaf rounded once, so it gives the
      kernel's bits.
  product_spectral_norm_partitioned(...)
      the plain twin of the chain form: every matvec and every norm summed
      in the kernel's order (lanes, xor trees, thread groups, blocks in rank
      order), fmaf rounded once, so it gives the kernel's bits.

What bounds K2 on an H100 is latency: as written the iteration is 2 m
(n_iter + 1) dependent matvecs (204 at the digit recipe). The product form
runs the rounds on the d_m x d_m Gram of Q = W_1 ... W_m instead, after m - 1
multi-vector links that build Q from the narrow end; the chain form, for a
wide last layer, separates the links by exchanges through distributed shared
memory (see the kernel's header). It needs a device that can schedule a
cluster of `CLUSTER_SIZE` blocks with 227 KB of shared memory each (an H100:
16 SMs of one GPC); `preload()` raises when it cannot.

A CUDA tensor never falls back to a twin: the kernel launches or the wrapper
raises. `product_spectral_norm_cuda.launches` counts calls that launched.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..utils.profiling import count
from ._build import load_library
from .spectral import product_spectral_norm_with_state

__all__ = ["product_spectral_norm_cuda", "pi_launch", "preload", "pi_plan",
           "PiPlan", "product_spectral_norm_gram",
           "product_spectral_norm_partitioned",
           "CLUSTER_SIZE", "KERNEL_SOURCE", "REPLACES"]

KERNEL_SOURCE = "asr_using_robust_nn_tpu_torch/csrc/product_power_iter.cu"
REPLACES = "asr_using_robust_nn_tpu/ops/pallas_spectral.py:44"
_EPS = float(np.spacing(1.0))
_MAX_DIM = 8192      # widths the kernel's shared-memory vectors are sized for
_MAX_LAYERS = 16
_THREADS = 512       # threads of a block (csrc/product_power_iter.cu)
SMEM_MAX = 232448    # shared memory one block may use on an H100
CLUSTER_SIZE = 16    # blocks of the cluster; 8 is the portable size
_GRAM_COLS = 32      # the product form's widest last layer
_PLAN_FLOATS = 80    # the kernel's barriers and per-dimension slices


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
    gram: bool          # the product form (else the chain form)
    rrows: int          # product form: rows of each copy of R

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
    """The plan for a chain of (true) widths `dims` on `cluster` blocks.

    Dimension i is cut into contiguous slices of per[i] = ceil(d_i / cluster)
    rounded up to a multiple of 4 (so four neighbouring entries share an
    owner and move as one 16-byte word); trailing blocks may own nothing.

    The form follows the widths alone, never n_iter: the product (Gram) form
    where d_m <= 32 and its shared memory fits `SMEM_MAX` bytes: two fp32
    copies of R (the widest inner width, or a block's slice of d_0, by d_m
    rounded up to 4), every block's partial of the d_m x d_m Gram, the Gram
    and u. Else the chain form, whose layers are made resident largest
    first while a block's widest slice of each still fits beside the
    vectors; the others are read from global memory."""
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
    dm = dims[m]
    rrows = max((per[0],) + dims[1:m])
    gram_bytes = 4 * (2 * rrows * _round4(dm) + (cluster + 1) * _round4(dm * dm)
                      + _round4(dm) + _round4(cluster) + 32
                      + _PLAN_FLOATS)
    if dm <= _GRAM_COLS and gram_bytes <= SMEM_MAX:
        return PiPlan(dims, cluster, esize, per, (False,) * m, (-1,) * m,
                      gram_bytes, gram_bytes, True, rrows)
    segmax = max(per)
    vec_floats = (2 * _round4(max(dims)) + _round4(dims[m]) + segmax
                  + 2 * cluster * segmax + 4 * cluster + 4 * _THREADS + 32
                  + _PLAN_FLOATS)
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
                  min(used, SMEM_MAX), False, 0)


def _round4(x: int) -> int:
    return (x + 3) & ~3


def _round16(x: int) -> int:
    return (x + 15) & ~15


def product_spectral_norm_partitioned(ws, u, n_iter: int = 16,
                                      eps: float = _EPS,
                                      matvec_bf16: bool = True,
                                      cluster: int = CLUSTER_SIZE):
    """(sigma, u_next) by the kernel's chain form, bit for bit: the
    iteration as `product_spectral_norm_with_state` writes it, every sum in
    the cluster kernel's order, every multiply-add an fmaf rounded once
    (`_fma`), on the device of `u`. A P^T link (W x) as a warp sums a row:
    lane l takes entries 4 l + 128 i + q (one entry l + 32 i where the width
    is not a multiple of 4), then the xor tree. A P link (W^T x) as the
    block's partials over its rows (column groups of 4, rows dealt to
    `min(512 / columns, rows)` thread groups, summed per group in row order
    and added in group order), the blocks' partials added in rank order. A
    norm or a dot as the kernel's `block_sum` of per-thread sums (entry i to
    thread i mod 512), the blocks' sums added in rank order."""
    dims = (ws[0].shape[0],) + tuple(w.shape[1] for w in ws)
    plan = pi_plan(dims, cluster, matvec_bf16)
    m, dev = len(ws), u.device
    wdt = torch.bfloat16 if matvec_bf16 else torch.float32
    mws = [w.detach().to(dev).to(wdt).float() for w in ws]
    vec = [d % 4 == 0 for d in dims[1:]]
    lane = torch.arange(32, device=dev)
    eps32 = torch.tensor(eps, dtype=torch.float32, device=dev)

    def cast(x):
        return x.to(torch.bfloat16).float() if matvec_bf16 else x

    def tree(v):  # the xor tree over the last axis (32 lanes)
        for o in (16, 8, 4, 2, 1):
            v = v + v[..., lane ^ o]
        return v[..., 0]

    def block_sum(x, y):  # sum of x * y over one block's slice
        pad = -x.shape[0] % _THREADS
        x = torch.nn.functional.pad(x, (0, pad)).reshape(-1, _THREADS)
        y = torch.nn.functional.pad(y, (0, pad)).reshape(-1, _THREADS)
        acc = torch.zeros(_THREADS, device=dev)
        for k in range(x.shape[0]):
            acc = _fma(x[k], y[k], acc)
        warps = tree(acc.reshape(_THREADS // 32, 32))
        return tree(torch.nn.functional.pad(warps, (0, 32 - warps.shape[0])))

    def ordered(parts):
        total = torch.zeros_like(parts[0])
        for p in parts:
            total = total + p
        return total

    def all_sum(i, x, y):  # over the blocks owning dimension i, rank order
        return ordered([block_sum(x[lo:hi], y[lo:hi]) for lo, hi in
                        (plan.owned(i, c) for c in range(plan.ranks(i)))])

    def nrm(x, total):
        return x / (torch.tensor(math.sqrt(float(total)), device=dev).float()
                    + eps32)

    def pt(j, x):  # W_j x, every row as a warp sums it
        w = mws[j]
        vw = 4 if vec[j] else 1
        acc = torch.zeros((w.shape[0], 32), device=dev)
        for base in range(0, w.shape[1], 32 * vw):
            for q in range(vw):
                k = base + vw * lane + q
                ok = k < w.shape[1]
                acc[:, ok] = _fma(w[:, k[ok]], x[k[ok]][None], acc[:, ok])
        return tree(acc)

    def partials(j, w, x, nrows):  # blocks of nrows rows: (blocks, dout)
        units = w.shape[-1] // (4 if vec[j] else 1)
        groups = 1 if units >= _THREADS else min(_THREADS // units, nrows)
        pad = -nrows % groups
        w = torch.nn.functional.pad(w, (0, 0, 0, pad))
        w = w.reshape(w.shape[0], -1, groups, w.shape[-1])
        x = torch.nn.functional.pad(x, (0, pad)).reshape(x.shape[0], -1, groups)
        acc = torch.zeros((w.shape[0], groups, w.shape[-1]), device=dev)
        for k in range(w.shape[1]):  # thread group g takes rows g, g + groups..
            acc = _fma(w[:, k], x[:, k, :, None], acc)
        return ordered(list(acc.transpose(0, 1)))  # groups in order

    def p(j, x):  # W_j^T x from the blocks' partials over their rows
        per, n, dout = plan.per[j], dims[j], dims[j + 1]
        whole = n // per  # blocks that own `per` rows; one more owns the rest
        parts = []
        if whole:
            parts += list(partials(j, mws[j][:whole * per].reshape(
                whole, per, dout), x[:whole * per].reshape(whole, per), per))
        if n > whole * per:
            parts += list(partials(j, mws[j][whole * per:][None],
                                   x[whole * per:][None], n - whole * per))
        return ordered(parts)

    u = u.detach().to(dev).float()
    u = nrm(u, block_sum(u, u))
    sigma = None
    for rnd in range(n_iter + 1):
        x = cast(u)
        for j in reversed(range(m)):
            x = pt(j, x) if j == 0 else cast(pt(j, x))
        v = cast(nrm(x, all_sum(0, x, x)))
        for j in range(m - 1):
            v = cast(p(j, v))
        y = p(m - 1, v)
        if rnd < n_iter:
            u = nrm(y, all_sum(m, y, y))
        else:
            sigma = all_sum(m, u, y)
    return sigma, u


def _fma(a, b, c):
    """fp32 fmaf(a, b, c), rounded once, on float32 tensors (broadcast): the
    product of two floats is exact in float64; TwoSum keeps the rounding
    error of the float64 sum, and a sum that lands exactly halfway between
    two floats is moved off the tie toward that error."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    back = s - p
    err = (p - (s - back)) + (c - back)
    r = s.float()
    up = s > r.double()
    other = torch.nextafter(r, torch.where(up, torch.inf, -torch.inf)
                            .to(torch.float32))
    tie = (r.double() + other.double()) * 0.5 == s
    return torch.where(tie & (err != 0) & ((err > 0) == up), other, r)


def _gram_splits(per: int, k: int) -> int:
    """How many runs of consecutive k a product-form link of depth k is cut
    into, for blocks of `per` rows (csrc/product_power_iter.cu::
    gram_splits): a lane takes 2 rows, ceil(per / 64) warps cover the
    block's rows, and there are as many runs as the warps allow, at most one
    per 32 of k."""
    by_warps = _THREADS // 32 // -(-per // 64)
    return max(1, min(by_warps, -(-k // 32)))


def _gram_link(w, r, per):
    """w (rows, k) @ r (k, N) as a product-form link sums it: each run of ks
    consecutive k (`_gram_splits`) in order, one fmaf a term, then the runs'
    sums added in order to 0."""
    k = w.shape[1]
    splits = _gram_splits(per, k)
    ks = (-(-k // splits) + 7) & ~7
    parts = torch.zeros((w.shape[0], splits, r.shape[1]))
    for t in range(ks):
        idx = torch.arange(t, k, ks)  # step t of every run that reaches it
        n = len(idx)
        parts[:, :n] = _fma(w[:, idx, None], r[idx][None], parts[:, :n])
    out = torch.zeros((w.shape[0], r.shape[1]))
    for s in range(splits):
        out = out + parts[:, s]
    return out


def product_spectral_norm_gram(ws, u, n_iter: int = 16, eps: float = _EPS,
                               matvec_bf16: bool = True,
                               cluster: int = CLUSTER_SIZE):
    """(sigma, u_next) by the kernel's product form, bit for bit: Q = W_1 ...
    W_m from the narrow end in fp32 (`_gram_link`), G = Q^T Q as per-block
    partials over each block's rows of Q (one fmaf a row, rows in order),
    added in rank order, then u = nrm(u0), n_iter rounds of u = nrm(G u),
    q = u^T G u and sigma = q / (sqrt(q) + eps), every sum a sequential fmaf
    chain in index order. The same iteration as the chain's apart from the
    eps inside the inner nrm; its rounding is fp32's alone, where the chain
    rounds the vector to bf16 before every link. CPU tensors; u_next has
    d_m entries."""
    dims = (ws[0].shape[0],) + tuple(w.shape[1] for w in ws)
    plan = pi_plan(dims, cluster, matvec_bf16)
    m, dm = len(ws), dims[-1]
    wdt = torch.bfloat16 if matvec_bf16 else torch.float32
    mws = [w.detach().cpu().to(wdt).float() for w in ws]
    r = mws[-1]
    for j in reversed(range(m - 1)):
        r = _gram_link(mws[j], r, plan.per[j])
    parts = torch.zeros((plan.ranks(0), dm, dm))
    for c in range(plan.ranks(0)):
        lo, hi = plan.owned(0, c)
        for row in r[lo:hi]:
            parts[c] = _fma(row[:, None], row[None, :], parts[c])
    g = torch.zeros((dm, dm))
    for part in parts:
        g = g + part
    eps32 = torch.tensor(eps, dtype=torch.float32)

    def root(x):  # sqrtf: the float64 root rounded to float32 is rounded once
        return torch.tensor(math.sqrt(float(x))).float() + eps32

    def dot(x, y):
        acc = torch.zeros(())
        for n in range(dm):
            acc = _fma(x[n], y[n], acc)
        return acc

    def apply(x):  # G x, row i summed over n in order
        acc = torch.zeros(dm)
        for n in range(dm):
            acc = _fma(g[:, n], x[n], acc)
        return acc

    def nrm(x):
        return x / root(dot(x, x))

    u = nrm(u.detach().cpu().float()[:dm])
    for _ in range(n_iter):
        u = nrm(apply(u))
    q = dot(u, apply(u))
    return q / root(q), u


@functools.cache
def _lib():
    lib = load_library("product_power_iter")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.asr_pi_run.argtypes = [ptr, ptr, ptr, ptr, i32, i32, ptr, ptr, i32,
                               ptr, i32, f32, f32, f32, ptr, i32, i32, ptr,
                               ptr, i32, ptr]
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
              masters=None, dims=None) -> None:
    """Enqueue the power iteration as one launch on a cluster of
    `CLUSTER_SIZE` blocks on the current stream, in the form `pi_plan` picks
    for the widths `dims`; no checks beyond the plan's and the C entry's, no
    allocation, no synchronization (capturable; call `preload()` before a
    capture). Every vector, inbox and factor lives in the cluster's shared
    memory, so there is no device work buffer.

    ws: contiguous 2-D buffers, all bf16 or all fp32, whose leading (d_i,
    d_{i+1}) block holds kernel i and the rest zeros (K3's and K6's padded
    kernels); `dims` = (d_0, ..., d_m) are those true widths, the buffers'
    shapes by default. u_in: its first d_m entries are read; u_out: written
    whole, zeros past d_m (may be u_in); sigma (1,) fp32. With `rho`, the
    bf16 buffers are then rescaled layer by layer by f_i = exp(log(rho /
    (sigma_i + eps)) / m), sigma_{i+1} = sigma_i * f_i, and `masters` (fp32,
    same shapes) by the same factors, in the same launch."""
    m = len(ws)
    wbf16 = ws[0].dtype == torch.bfloat16
    if dims is None:
        dims = (ws[0].shape[0],) + tuple(w.shape[1] for w in ws)
    plan = pi_plan(tuple(dims), CLUSTER_SIZE, wbf16)
    wptr = (ctypes.c_void_p * m)(*[w.data_ptr() for w in ws])
    dim_arr = (ctypes.c_int * (m + 1))(*plan.dims)
    ld_arr = (ctypes.c_int * m)(*[w.shape[1] for w in ws])
    numel_arr = (ctypes.c_longlong * m)(*[w.numel() for w in ws])
    per_arr = (ctypes.c_int * (m + 1))(*plan.per)
    off_arr = (ctypes.c_int * m)(*plan.res_off)
    mptr = None
    if masters is not None:
        mptr = (ctypes.c_void_p * m)(*[w.data_ptr() for w in masters])
    dev = ws[0].device
    with torch.cuda.device(dev):
        rc = _lib().asr_pi_run(
            wptr, dim_arr, ld_arr, numel_arr, m, int(wbf16),
            u_in.data_ptr(), u_out.data_ptr(), u_out.numel(),
            sigma.data_ptr(), n_iter, eps,
            -1.0 if rho is None else float(rho), float(np.float32(1.0 / m)),
            mptr, CLUSTER_SIZE, int(plan.gram), per_arr, off_arr,
            plan.smem_bytes, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"product_power_iter launch failed: CUDA error {rc}")
    count("k2.gram" if plan.gram else "k2.chain")


def product_spectral_norm_cuda(ws, u, n_iter: int = 16, eps: float = _EPS,
                               matvec_bf16: bool = True):
    """(sigma, u_next) = power iteration for ||W_m^T ... W_1^T||_2.

    `ws`: fp32 (d_in, d_out) kernels in model order; `u`: the persistent
    (d_out_last,) vector. On CUDA tensors the kernels are cast once (to bf16
    when `matvec_bf16`) and K2 runs in one launch on a cluster of
    `CLUSTER_SIZE` blocks, in the form `pi_plan` picks; on CPU tensors the
    plain twin of the chain runs. Any other device
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
