"""K6 on Hopper: one constrained train step per call on the packed state,
with deferred constraint scales, and its plain twin. Counterpart of the JAX
package's `ops/pallas_train.py::build_fused_step` (the per-step kernel
`_make_kernel`).

  fused_step_plain(spec, fstate, x_pad, y, wrow, seed)
  fused_steps_plain(spec, fstate, xs, ys, ws, seeds)
      the step math in PyTorch (one step, or a chain of them on one state).
  build_fused_step(spec) -> step(fstate, x_pad, y, wrow, seed)
      CUDA tensors: the step's kernels, captured once per (spec, device) into
      one CUDA graph and replayed per call; CPU tensors: the twin.
      `step.chain(fstate, xs, ys, ws, seeds)` runs n steps on one state (the
      `scan_steps=True` epoch of ops/cuda_train.py::build_fused_epoch_fn).

A K6 step is the fused epoch's step program (`ops/cuda_train.py::_step`) with
two operations swapped:

  * the Adam load reads the fp32 master as `master * scales[0, i]`: the
    previous step's constraint factor is folded in here, exactly once;
  * the projection rescales only the bf16 compute copies `w16`, in bf16, and
    writes its factors to `scales`; the masters are not touched. With
    `rho=None` the step leaves `scales` = 1 and `u` as it was.

So `w16` is state, carried from step to step (after a constrained step it is
`bf16(bf16(w) * f)`, not a cast of the masters), `count` advances by one per
call on the device, and `unpack_params` (or the grid epoch) must fold
`scales` into the masters. On CUDA the fused forward, the CCE, dX with the
BN backward and the power iteration are the compiled functions K3 launches,
in the forms `launch_plan(spec)` gives; the dW + Adam kernel with the fold
and the deferred rescale are csrc/fused_step.cu. A CUDA tensor never falls back to the twin.
`build_fused_step.launches` counts graph replays (one per step).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ._build import load_library
from .cuda_spectral import pi_launch, preload
from .cuda_train import (_BF16, _EPS, FusedStepSpec, _AdamArgs,
                         _ComposedOps, _CudaOps, _PlainOps, _scratch,
                         _state_leaves, _state_map, _step, _template_state,
                         preload_kernels)

__all__ = ["build_fused_step", "fused_step_plain", "fused_steps_plain",
           "KERNEL_SOURCE", "REPLACES"]

KERNEL_SOURCE = "asr_using_robust_nn_tpu_torch/csrc/fused_step.cu"
REPLACES = "asr_using_robust_nn_tpu/ops/pallas_train.py:189"
_MAX_LAYERS = 16  # csrc/fused_step.cu: kMaxLayers


def _k6_step(ops, spec, fs, sc, x, y, w, seed, loss, acc):
    """One K6 step on `fs` in place: `seed`, `loss`, `acc` are (1,) buffers
    (the step index inside `_step` is always 0; `count` advances here)."""
    _step(ops, spec, fs, sc, x, y, w, seed, 0, loss, acc)
    if spec.rho is None:
        ops.scales_one(fs["scales"])
    ops.count_add(fs["count"], 1)


class _PlainStepOps(_PlainOps):
    """K6's two swapped operations in PyTorch."""

    def load_master(self, fs, i):
        return fs["masters"][i] * fs["scales"][0, i]

    def rescale(self, fs, i, f):
        fs["w16"][i].copy_((fs["w16"][i].float() * f).to(_BF16))
        fs["scales"][0, i] = f

    def project(self, fs, sc):
        super().project(fs, sc)
        fs["scales"][0, self.spec.n_layers:] = 1.0

    def scales_one(self, scales):
        scales.fill_(1.0)


@functools.cache
def _lib():
    lib = load_library("fused_step")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sig = {
        "asr_fs_dw_adam": [p, p, p, p, p, p, i, i, i, p, p, i,
                           ctypes.POINTER(_AdamArgs), i,
                           ctypes.POINTER(ctypes.c_int), p],
        "asr_fs_rescale": [p, p, i, p, p, f, f, f, p],
        "asr_fs_scales_one": [p, p],
        "asr_fs_preload": [ctypes.POINTER(ctypes.c_int)],
    }
    for name, argtypes in sig.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


class _CudaStepOps(_CudaOps):
    """K3's launches with K6's two operations from csrc/fused_step.cu; the
    weight updates stay one launch a layer (K3 groups them)."""

    dw_adam_all = _ComposedOps.dw_adam_all

    def __init__(self, spec: FusedStepSpec):
        if spec.n_layers > _MAX_LAYERS:
            raise ValueError(f"fused step: at most {_MAX_LAYERS} layers, got "
                             f"{spec.n_layers}")
        super().__init__(spec)
        self.slib = _lib()

    def gemm_dw_adam(self, i, acts, dzb, fs, count, s):
        K, M = acts.shape
        self._ran("dw_adam", self.slib.asr_fs_dw_adam(
            acts.data_ptr(), dzb.data_ptr(), fs["masters"][i].data_ptr(),
            fs["mw"][i].data_ptr(), fs["vw"][i].data_ptr(),
            fs["w16"][i].data_ptr(), M, dzb.shape[1], K, count.data_ptr(),
            fs["scales"].data_ptr(), i, ctypes.byref(self.adam),
            int(self.spec.cfg.nonneg), self.plan["dw"][i].dims(),
            self._stream()))

    def project(self, fs, sc):
        spec, m = self.spec, self.spec.n_layers
        pi_launch(list(fs["w16"]), fs["u"], fs["u"], sc["sigma"],
                  spec.pi_iters, _EPS, dims=spec.dims)
        self.launched += 1
        ws = (ctypes.c_void_p * m)(*[w.data_ptr() for w in fs["w16"]])
        ns = (ctypes.c_longlong * m)(*[w.numel() for w in fs["w16"]])
        self._ran("rescale", self.slib.asr_fs_rescale(
            ws, ns, m, sc["sigma"].data_ptr(), fs["scales"].data_ptr(),
            float(spec.rho), _EPS, float(np.float32(1.0 / m)),
            self._stream()))

    def scales_one(self, scales):
        self._ran("scales_one", self.slib.asr_fs_scales_one(
            scales.data_ptr(), self._stream()))


def _step_inputs(spec: FusedStepSpec, xs, ys, ws, seeds):
    """Batches of a chain as (n, B, pd0) f32, (n, B) int32, (n, B) f32 and
    (n,) int32 on xs' device."""
    n, B = xs.shape[0], spec.batch
    if xs.shape != (n, B, spec.pdims[0]):
        raise ValueError(f"fused step: x must be ({B}, {spec.pdims[0]}) per "
                         f"step, got {tuple(xs.shape[1:])}")
    seeds = torch.as_tensor(seeds, device=xs.device)
    return (xs.float().contiguous(),
            ys.reshape(n, B).to(torch.int32).contiguous(),
            ws.reshape(n, B).float().contiguous(),
            seeds.reshape(n).to(torch.int32).contiguous())


def fused_steps_plain(spec: FusedStepSpec, fstate: dict, xs, ys, ws, seeds,
                      ops: _PlainOps | None = None):
    """K6's plain twin over a chain of steps: -> (fstate', losses (n,), accs
    (n,)) for xs (n, B, pdims[0]) f32, ys (n, B) labels, ws (n, B) row
    weights, seeds (n,) int32. `fstate` is not modified; fstate' carries its
    own `w16` and the last step's `scales`. `ops` (default
    `_PlainStepOps(spec)`) lets a check swap one operation."""
    xs, ys, ws, seeds = _step_inputs(spec, xs, ys, ws, seeds)
    ys = ys.long()
    fs = _state_map(lambda t: t.clone(), fstate)
    n = xs.shape[0]
    losses = torch.zeros(n, device=xs.device)
    accs = torch.zeros(n, device=xs.device)
    ops = ops or _PlainStepOps(spec)
    sc = _scratch(spec, xs.device)
    with torch.no_grad():
        for s in range(n):
            _k6_step(ops, spec, fs, sc, xs[s], ys[s], ws[s], seeds[s: s + 1],
                     losses[s: s + 1], accs[s: s + 1])
    return fs, losses, accs


def fused_step_plain(spec: FusedStepSpec, fstate: dict, x_pad, y, wrow, seed,
                     ops: _PlainOps | None = None):
    """K6's plain twin, one step: -> (fstate', loss, acc) with the signature
    of `build_fused_step`'s `step`."""
    seed = torch.as_tensor(seed, device=x_pad.device).reshape(1)
    fs, losses, accs = fused_steps_plain(spec, fstate, x_pad[None], y[None],
                                         wrow[None], seed, ops=ops)
    return fs, losses[0], accs[0]


class _StepGraph:
    """Static buffers and the CUDA graph of one (spec, device): the state,
    one batch, the seed, and the step's loss and accuracy. `load` copies a
    caller's state in, `replay` runs one step on it in place, `store` clones
    it out. `kernel_nodes` is the number of kernels the graph holds."""

    def __init__(self, spec: FusedStepSpec, device):
        B, pd = spec.batch, spec.pdims
        ops = _CudaStepOps(spec)  # the plan refuses what the kernels do not take
        self.spec = spec
        self.device = device
        with torch.cuda.device(device):
            zeros = lambda t: torch.zeros_like(t, device=device)  # noqa: E731
            self.fs = _state_map(zeros, _template_state(spec))
            self.x = torch.zeros((B, pd[0]), device=device)
            self.y = torch.zeros(B, dtype=torch.int32, device=device)
            self.w = torch.zeros(B, device=device)
            self.seed = torch.zeros(1, dtype=torch.int32, device=device)
            self.loss = torch.zeros(1, device=device)
            self.acc = torch.zeros(1, device=device)
            self.sc = _scratch(spec, device)
            preload_kernels(ops.lib)
            preload_kernels(ops.slib, "asr_fs_preload")
            preload()
            torch.cuda.synchronize(device)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                _k6_step(ops, spec, self.fs, self.sc, self.x, self.y, self.w,
                         self.seed, self.loss, self.acc)
            self.kernel_nodes = ops.launched

    def load(self, fstate):
        for dst, src in zip(_state_leaves(self.fs), _state_leaves(fstate)):
            if dst.shape != src.shape:
                raise ValueError(f"fused step: state leaf {tuple(src.shape)} "
                                 f"where {tuple(dst.shape)} was captured")
            dst.copy_(src)

    def replay(self, x, y, w, seed):
        for dst, src in ((self.x, x), (self.y, y), (self.w, w),
                         (self.seed, seed)):
            dst.copy_(src)
        with torch.cuda.device(self.device):
            self.graph.replay()
        build_fused_step.launches += 1

    def store(self):
        return _state_map(lambda t: t.clone(), self.fs)


def build_fused_step(spec: FusedStepSpec):
    """-> step(fstate, x_pad, y, wrow, seed) -> (fstate', loss, acc): one
    constrained train step on the packed state. x_pad (batch, pdims[0]) f32
    feature-padded, y (batch,) labels, wrow (batch,) f32 row weights, seed
    an int32 scalar (tensor or int) for the dropout hash; loss and acc are
    0-d tensors.

    On CPU tensors the plain twin runs. On CUDA tensors the step is one
    replay of a CUDA graph captured at the first call per device (`batch`
    must be a positive multiple of 64; `pallas_relu_mask` is refused); the
    seed, `count`, `scales` and `u` are device buffers the graph reads.

    State handling: the graph works in place on static buffers of its own
    (the TPU kernel aliases its big inputs to its outputs); `step` copies
    the caller's state in and clones it out, so `fstate` is never modified
    and fstate' is the caller's own. That costs one read and one write of
    the whole state each way per call (about 2 x 26 MB at the digit widths,
    in ~40 small copies). `step.chain(fstate, xs, ys, ws, seeds)` ->
    (fstate', losses (n,), accs (n,)) pays those copies once for n steps and
    never synchronizes with the host between steps. `step.graphs` maps each
    device to its `_StepGraph`. The FISTA projection (`spec.fista`) has no
    deferred form and is refused (ValueError): K3 runs it."""
    if spec.fista:
        raise ValueError("the fused step (K6) defers simple_norm's scales; "
                         "FISTA runs in the fused epoch (K3)")
    graphs: dict = {}

    def graph(device):
        g = graphs.get(device)
        if g is None:
            g = graphs[device] = _StepGraph(spec, device)
        return g

    def chain(fstate, xs, ys, ws, seeds):
        if xs.device.type == "cpu":
            return fused_steps_plain(spec, fstate, xs, ys, ws, seeds)
        if not xs.is_cuda:
            raise ValueError(f"fused step: unsupported device {xs.device}")
        xs, ys, ws, seeds = _step_inputs(spec, xs, ys, ws, seeds)
        g = graph(xs.device)
        n = xs.shape[0]
        losses = torch.empty(n, device=xs.device)
        accs = torch.empty(n, device=xs.device)
        g.load(fstate)
        for s in range(n):
            g.replay(xs[s], ys[s], ws[s], seeds[s: s + 1])
            losses[s: s + 1].copy_(g.loss)
            accs[s: s + 1].copy_(g.acc)
        return g.store(), losses, accs

    def step(fstate, x_pad, y, wrow, seed):
        seed = torch.as_tensor(seed, device=x_pad.device).reshape(1)
        fs, losses, accs = chain(fstate, x_pad[None], y[None], wrow[None],
                                 seed)
        return fs, losses[0], accs[0]

    step.chain = chain
    step.graphs = graphs
    return step


build_fused_step.launches = 0
