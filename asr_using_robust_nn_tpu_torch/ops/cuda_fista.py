"""K7 on Hopper: the FISTA projection of a training step, its wrapper and its
plain twin. It has no counterpart among the JAX package's Pallas kernels
(that package runs the projection as XLA ops in `lax.while_loop`); it exists
so that a fit under `constraints/engine.py::make_fista_constraint` runs the
fused epoch (K3, ops/cuda_train.py), which calls it where the simple_norm
recipe calls K2.

  fista_plan(dims)
      the launch's form from the widths alone: where each A_i^T lies in the
      scratch, the row stride of the row chains, the bytes of shared memory a
      block needs. Raises ValueError for widths K7 does not take.
  fista_state(dims, device) / fista_scratch(dims, device)
      the projection's state (the power vectors v_i of ||B_i||_2, warm from
      step to step, and the counters) and the launch's scratch.
  fista_launch(masters, w16, state, scratch, dims, rho, nit, alpha)
      one cooperative launch of csrc/fista_project.cu on the current stream:
      all layers of one step, the fp32 masters projected in place and their
      bf16 copies written. No allocation, no synchronization, no host read:
      capturable (call `fista_preload(dims)` first).
  fista_project_twin(...)
      the same arithmetic as torch operations, on CPU or CUDA tensors.

The projection is the reference's (`Constraints.py`, the port's
`_fista_project`): for layers i = 0 .. m-1 in model order on the live
weights, with A_i = W_{m-1}^T ... W_{i+1}^T (the layers not yet projected),
B_i = W_{i-1}^T ... W_0^T (those already projected), gamma = 1 / (||A_i||_2
||B_i||_2 + eps)^2, at most `nit` iterations of the FISTA dual step with
the exit test ||w - W_i||_F < 30 and ||max(sigma(t) - rho, 0)|| < 0.01.
K7 takes nit 1 or 2 (the thesis's is 2): iteration 0 has z = 0, so its w
is relu(W_i) and its t = A_i relu(W_i)^T B_i; iteration 1's w is the output.

Departures from the reference's association, each allowed because it
computes the same function (fp32 throughout, TF32 off, as the
configuration states for the projection):

  * A and B are applied as chains of n-row (n-column) products through the
    layers; B is never formed. The reference forms B_i (2.25 GFLOP a step
    at the digit widths).
  * The SVDs of the n x d_0 matrices (n = 10 classes) come from their n x n
    Gram, t t^T, in fp64 (cyclic Jacobi in K7, `torch.linalg.eigh` here):
    s_k = sqrt(lambda_k), u_k its eigenvectors.
  * gamma U clip(S, 0, rho) V^T is computed as gamma (z / gamma + t) -
    gamma sum_{s_k > rho} (s_k - rho) u_k v_k^T, so that y = gamma C t with
    C = U diag((s_k - rho)_+ / s_k) U^T; at iteration 0, z = 0 and the
    second SVD (of z / gamma + t) is the first.
  * The work of the last iteration that feeds no output (its t, its SVDs,
    its y) is skipped.
  * With NonNeg masters (`nonneg`), a layer whose exit fires stays as it
    is (relu(W_i) = W_i), so the next layer's product A W B is the same
    matrix, its exit fires too, and so on: the first exit ends the step's
    projection, the later layers counted as exits.
  * ||A_i||_2 comes from the eigenvalues of A_i A_i^T (fp64). ||B_i||_2
    comes from a power iteration on B_i B_i^T from v_i, warm from the step
    before, whose first round rides in the chains above (x = B_i^T v_i,
    w = B_i B_i^T v_i): it has converged when the residual ||w - ||x||^2
    v_i|| is within SIGMA_TOL of ||w||, and then ||B_i||_2 = ||x||; else
    more rounds run from v = w / ||w||. The rounds end on that test, never
    after a fixed count (MAX_ROUNDS is a guard, counted when hit). NonNeg
    kernels have a wide Perron gap, so one round usually suffices. The
    estimate agrees with the float64 SVD to SIGMA_AGREE relative (tests/
    test_torch_fista_epoch.py reads it at the digit widths along steps).

K2's cluster links (csrc/product_power_iter.cu) are not reused: they
exchange through one 16-SM cluster's shared memory, and K7's chains, which
read the 6.4 MB of masters some dozen times a step, spread over every SM of
the card and meet at grid-wide barriers instead.

Counters (`state["n"]`, int64): layer projections run, FISTA iterations run
(1 where the exit fires at iteration 0, else `nit`), power-iteration rounds,
and rounds that hit MAX_ROUNDS. They accumulate over a fit in the device state;
the trainer reads them once at the fit's end (`fista.projections`,
`fista.iterations` in utils/profiling.py's table).

A CUDA tensor never falls back to the twin: the kernel launches or the
wrapper raises. `fista_launch.launches` counts launches enqueued.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ._build import load_library
from .spectral import no_tf32

__all__ = ["fista_plan", "FistaPlan", "fista_state", "fista_scratch",
           "fista_launch", "fista_preload", "fista_project_twin",
           "SIGMA_TOL", "SIGMA_AGREE", "MAX_ROUNDS", "KERNEL_SOURCE"]

KERNEL_SOURCE = "asr_using_robust_nn_tpu_torch/csrc/fista_project.cu"
_EPS = float(np.spacing(1.0))
SIGMA_TOL = 1e-2      # the power iteration's residual, relative
# ||B_i||_2 against the float64 SVD, relative: gamma then errs by 2e-4 at
# most, a twentieth of one bf16 ulp of the copies K3 trains on
SIGMA_AGREE = 1e-4
MAX_ROUNDS = 100
_MAX_LAYERS = 16
_MAX_CLASSES = 10    # n: the eigenproblems run in one warp's registers
_THREADS = 384      # a block of K7 (csrc/fista_project.cu: kThreads)
_WARPS = _THREADS // 32
_SMEM_LIMIT = 232448  # shared memory one block may use on an H100
_MAX_GRID = 512      # blocks: one an SM


class FistaPlan(NamedTuple):
    """How K7 lays out one chain of widths `dims`."""
    dims: tuple
    at_off: tuple       # float offset of A_i^T (dims[i+1] x n) in `at`
    at_floats: int
    q_ld: int           # row stride of the row chains
    rows_max: int       # the widest input or hidden width
    smem_bytes: int     # dynamic shared memory a block needs


def _odd(x: int) -> int:
    return x | 1


def fista_plan(dims) -> FistaPlan:
    """K7's form for the true widths `dims` = (d_0, ..., d_m). Raises
    ValueError where K7 does not take them: more than 16 layers, more than
    10 classes (the n x n eigenproblems run in one warp's registers), or a
    layer whose staged operands pass a block's shared memory (the kernel's
    static ~14 KB aside): the digit presets fit, the speaker presets (20
    classes) do not."""
    dims = tuple(int(d) for d in dims)
    m, n = len(dims) - 1, dims[-1]
    if m < 1 or m > _MAX_LAYERS:
        raise ValueError(f"K7 takes 1 to {_MAX_LAYERS} layers, got {m}")
    if n < 1 or n > _MAX_CLASSES:
        raise ValueError(f"K7 takes 1 to {_MAX_CLASSES} classes, got {n}")
    at_off, off = [], 0
    for i in range(m):
        at_off.append(off)
        off += dims[i + 1] * n
    tp = _odd(n + 1)
    part = _WARPS * (n + 1) * 32
    need = [dims[0] * tp + part,                       # eig + first row link
            dims[0] * tp + dims[1] * _odd(n)]          # layer 0's update
    for j in range(m):
        need.append(dims[j + 1] * tp)                  # column links
        need.append(dims[j] * tp + part)               # row links
    smem = 4 * max(need)
    if smem > _SMEM_LIMIT - 32 * 1024:
        raise ValueError(f"K7: the widths {dims} need {smem} bytes of shared "
                         f"memory a block")
    rows = max(dims[:-1])
    return FistaPlan(dims, tuple(at_off), off, -(-rows // 4) * 4, rows, smem)


def fista_state(dims, device) -> dict:
    """The projection's state on `device`: "v" (m, max(dims[:-1])) float32, row i
    holding v_i = ones / sqrt(d_i) on its first d_i entries (a positive
    start for the Perron vector of B_i B_i^T; row 0 is unused); "u" (m, 2,
    n, n) float64, the eigenvectors K7's Jacobi starts from (of t t^T and of
    A_i A_i^T, the step before's; identity at first; the twin leaves them);
    and "n" (4,) int64 counters at 0."""
    dims = tuple(int(d) for d in dims)
    m, n = len(dims) - 1, dims[-1]
    v = torch.zeros((m, max(dims[:-1])), device=device)
    for i in range(1, m):
        v[i, :dims[i]] = 1.0 / np.sqrt(dims[i])
    u = torch.eye(n, dtype=torch.float64, device=device).expand(
        m, 2, n, n).contiguous()
    return {"v": v, "u": u,
            "n": torch.zeros(4, dtype=torch.int64, device=device)}


def fista_scratch(dims, device) -> dict:
    """K7's work buffers on `device` (reused by every launch): A_i^T with
    A_{m-1}^T = I in place, two column-chain and two row-chain buffers, two
    power-iteration vectors, per-block partial sums and the grid
    barrier's two counters (zero: each launch leaves them so)."""
    plan = fista_plan(dims)
    n, m = plan.dims[-1], len(plan.dims) - 1
    f32 = dict(dtype=torch.float32, device=device)
    at = torch.zeros(plan.at_floats, **f32)
    at[plan.at_off[m - 1]:plan.at_off[m - 1] + n * n] = torch.eye(
        n, **f32).flatten()
    return {
        "at": at,
        "r": torch.zeros((2, plan.rows_max * (n + 1)), **f32),
        "q": torch.zeros((2, (n + 1) * plan.q_ld), **f32),
        "pw": torch.zeros((2, plan.q_ld), **f32),
        "vb": torch.zeros((2, plan.q_ld), **f32),
        "v_next": torch.zeros((m, plan.rows_max), **f32),
        "crit": torch.zeros(_MAX_GRID, dtype=torch.float64, device=device),
        "u_next": torch.zeros((m, 2, n, n), dtype=torch.float64,
                              device=device),
        "bar": torch.zeros(2, dtype=torch.int32, device=device),
    }


@functools.cache
def _lib():
    lib = load_library("fista_project")
    p, i, f, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_double
    lib.asr_fista_run.argtypes = [p, p, p, p, p, i, f, f, i, d, i, d, p, i,
                                  p, p, p, p, p, p, p, p, p, p, p, p, p, i,
                                  p, i, p, i, i, p]
    lib.asr_fista_run.restype = i
    ip = ctypes.POINTER(ctypes.c_int)
    lib.asr_fista_preload.argtypes = [i, ip, ip, ip]
    lib.asr_fista_preload.restype = i
    return lib


def fista_preload(dims) -> int:
    """Load K7 into the current device's context and opt it in to its
    shared memory (before a capture); -> the grid it launches with, one
    block per SM. Raises where the device cannot run it: no cooperative
    launch, or no block of it fits an SM."""
    return _preload(torch.cuda.current_device(), fista_plan(dims).smem_bytes)


@functools.cache
def _preload(device_index: int, smem: int) -> int:
    sms, per_sm, static = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = _lib().asr_fista_preload(smem, ctypes.byref(sms),
                                      ctypes.byref(per_sm),
                                      ctypes.byref(static))
    if rc != 0:
        raise RuntimeError(f"fista_project preload failed: CUDA error {rc}")
    if per_sm.value < 1 or smem + static.value > _SMEM_LIMIT:
        raise RuntimeError(f"fista_project: no block fits an SM ({smem} "
                           f"dynamic + {static.value} static bytes)")
    return min(sms.value, _MAX_GRID)


def fista_launch(masters, w16, state, scratch, dims, rho: float, nit: int,
                 alpha: float, nonneg: bool = False) -> None:
    """Enqueue one step's projection on the current stream. `masters`
    (fp32) and `w16` (bf16): each layer's contiguous buffer, whose leading
    (d_i, d_{i+1}) block holds the layer (K3's padded layout; the rest zero,
    left so); `state` from `fista_state`, `scratch` from `fista_scratch`,
    both on the masters' device. `nonneg`: the masters are >= 0 (a NonNeg
    model), so that an exit ends the projection (see the module's
    docstring)."""
    if nit not in (1, 2):
        raise ValueError(f"K7 runs nit 1 or 2, got {nit}")
    plan = fista_plan(dims)
    m = len(masters)
    dev = masters[0].device
    grid = _preload(dev.index if dev.index is not None
                    else torch.cuda.current_device(), plan.smem_bytes)
    ptrs = lambda ts: (ctypes.c_void_p * m)(  # noqa: E731
        *[t.data_ptr() for t in ts])
    dim_arr = (ctypes.c_int * (m + 1))(*plan.dims)
    ld_arr = (ctypes.c_int * m)(*[w.shape[1] for w in masters])
    off_arr = (ctypes.c_int * m)(*plan.at_off)
    sc = scratch
    with torch.cuda.device(dev):
        rc = _lib().asr_fista_run(
            ptrs(masters), ptrs(w16), dim_arr, ld_arr, off_arr, m,
            float(rho), float(1.0 / (2.0 + alpha)), int(nit), SIGMA_TOL,
            MAX_ROUNDS, _EPS, state["v"].data_ptr(),
            state["v"].shape[1], state["u"].data_ptr(),
            sc["u_next"].data_ptr(), state["n"].data_ptr(),
            sc["at"].data_ptr(),
            sc["r"][0].data_ptr(), sc["r"][1].data_ptr(),
            sc["q"][0].data_ptr(), sc["q"][1].data_ptr(),
            sc["pw"][0].data_ptr(), sc["pw"][1].data_ptr(),
            sc["vb"][0].data_ptr(), sc["vb"][1].data_ptr(),
            sc["v_next"].data_ptr(), plan.q_ld,
            sc["crit"].data_ptr(), int(bool(nonneg)), sc["bar"].data_ptr(),
            grid, plan.smem_bytes,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fista_project launch failed: CUDA error {rc}")
    fista_launch.launches += 1


fista_launch.launches = 0


def _power_round_chain(ws, i, v):
    """x = B_i^T v = W_0 (W_1 ... (W_{i-1} v))."""
    x = v[:, None]
    for j in range(i - 1, -1, -1):
        x = ws[j] @ x
    return x[:, 0]


def fista_project_twin(masters, w16, state, dims, rho: float, nit: int,
                       alpha: float, nonneg: bool = False,
                       tol: float = SIGMA_TOL,
                       max_rounds: int = MAX_ROUNDS,
                       gamma_scale: float = 1.0, sigmas=None) -> None:
    """K7's arithmetic as torch operations, in place on `masters` (their
    leading (d_i, d_{i+1}) blocks), `w16` (cast from the new masters) and
    `state` ("v", "n"; "u" is K7's own and left), as the kernel updates
    them; in the masters' precision (fp32 as K7, or float64 for a check of
    the algebra) with TF32 off, the Gram and its eigenpairs in fp64. Sums
    run in torch's order, not the kernel's: the two agree to rounding.
    `nonneg` as `fista_launch`'s. `gamma_scale` multiplies gamma
    (1; another value plants a fault, tools/gate_faults.py); `sigmas`, a
    list, receives (||A_i||_2, ||B_i||_2) of each layer that updates."""
    if nit not in (1, 2):
        raise ValueError(f"K7 runs nit 1 or 2, got {nit}")
    dims = tuple(int(d) for d in dims)
    m, n = len(dims) - 1, dims[-1]
    eta1 = 1.0 / (2.0 + alpha)
    cnt = [0, 0, 0, 0]
    dt = masters[0].dtype
    # K7 rounds gamma and 1 / ||w|| to fp32; a float64 check keeps them
    rnd = (lambda x: float(np.float32(x))) if dt == torch.float32 else float
    with no_tf32():
        ws = [masters[j][:dims[j], :dims[j + 1]] for j in range(m)]
        at = [None] * m
        at[m - 1] = torch.eye(n, dtype=ws[0].dtype, device=ws[0].device)
        for j in range(m - 1, 0, -1):
            at[j - 1] = ws[j] @ at[j]
        sig_a = [float(torch.linalg.eigvalsh(a.double().T @ a.double())
                       .max().clamp_min(0.0).sqrt()) for a in at[:-1]]
        sig_a.append(1.0)
        for i in range(m):
            w = ws[i]
            crit = float(torch.sum(torch.clamp_max(w, 0.0).double() ** 2)
                         .sqrt())
            wr = torch.clamp_min(w, 0.0)
            r = wr @ at[i]
            if i > 0:
                r = torch.cat([r, state["v"][i, :dims[i], None].to(dt)], 1)
            for j in range(i - 1, -1, -1):
                r = ws[j] @ r
            tt = r[:, :n]
            lam, u = torch.linalg.eigh(tt.double().T @ tt.double())
            s = lam.clamp_min(0.0).sqrt()
            excess = torch.clamp_min(s - rho, 0.0)
            stop = nit < 2 or (crit < 30.0 and float(
                torch.sqrt(torch.sum(excess ** 2))) < 0.01)
            cnt[0] += 1
            cnt[1] += 1 if stop else 2
            if stop and nonneg:  # every later layer's product is this one
                cnt[0] += m - 1 - i
                cnt[1] += m - 1 - i
                break
            if stop:
                new = wr
            else:
                f = torch.where(s > rho, excess / torch.where(s > 0, s, 1.0),
                                0.0)
                cf = ((1.0 + eta1) * (u * f) @ u.T).to(dt)
                z = tt @ cf.T  # (d_0, n): column k of (1 + eta) C t, rowwise
                sig_b = 1.0
                if i == 0:
                    p = z.T
                else:
                    q = torch.cat([z.T, r[:, n][None]], 0)
                    for j in range(i):
                        q = q @ ws[j]
                    p, wv = q[:n], q[n]
                    s0 = float(torch.linalg.vector_norm(r[:, n].double()))
                    vv = state["v"][i, :dims[i]].to(dt)
                    for rounds in range(1, max_rounds + 1):
                        res = float(torch.linalg.vector_norm(
                            wv.double() - s0 * s0 * vv.double()))
                        nw = float(torch.linalg.vector_norm(wv.double()))
                        scale = rnd(1.0 / nw) if nw > 0 else 0.0
                        conv = res <= tol * nw
                        cnt[2] += 1
                        if conv or rounds >= max_rounds:
                            state["v"][i, :dims[i]] = wv * scale
                            cnt[3] += 0 if conv else 1
                            sig_b = s0
                            break
                        vv = wv * scale
                        x = _power_round_chain(ws, i, vv)
                        s0 = float(torch.linalg.vector_norm(x.double()))
                        wv = x[None] @ ws[0]
                        for j in range(1, i):
                            wv = wv @ ws[j]
                        wv = wv[0]
                    if sigmas is not None:
                        sigmas.append((sig_a[i], sig_b))
                sa = sig_a[i] * sig_b + _EPS
                g = rnd(gamma_scale / (sa * sa))
                new = torch.clamp_min(w - g * (p.T @ at[i].T), 0.0)
            w.copy_(new)
            w16[i].copy_(masters[i].to(torch.bfloat16))
    state["n"] += torch.tensor(cnt, dtype=torch.int64,
                               device=state["n"].device)
