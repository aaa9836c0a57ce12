"""K3 on Hopper: the fused constrained epoch, its plain twin, and the packed
state both run on. Counterpart of the JAX package's `ops/pallas_train.py`
(the epoch-grid kernel `_make_epoch_kernel` and its builders).

  pack_state / unpack_params / unpack_opt_state / pad_features
      the padded training state: fp32 masters, bf16 compute copies and fp32
      Adam moments per layer, with every dim padded to a multiple of 128,
      and the small per-layer vectors stacked into (m, dmax) arrays.
  fused_epoch_plain(spec, fstate, xs, ys, ws, seeds)
      the step math in PyTorch with an explicit backward, rounded where the
      kernel rounds: bf16 GEMM operands summed in fp32, activations and x^
      stored in bf16, dZ cast to bf16 before the dW and dX products.
  build_fused_epoch_call(spec, n_batches) -> run(fstate, xs, ys, ws, seeds)
      CUDA tensors: csrc/fused_epoch.cu's kernels (and, for the projection,
      K2's under simple_norm or K7's, ops/cuda_fista.py, under FISTA) for
      all n_batches steps, captured once per (spec,
      n_batches, device) into one CUDA graph and replayed per call; CPU
      tensors: `fused_epoch_plain`.
  build_fused_epoch_fn(spec, ...)
      the epoch on the whole split: the shuffle gather in PyTorch, per-step
      dropout seeds from a torch.Generator, then one `run`.
  epoch_parity_vs_plain(...)
      the gate the trainer runs before it trains with K3: K3 against its
      twin in lockstep (ops/k3_lockstep.py) and K3's epoch against the plain
      epoch, its BN bar scaled by the spread of summation order.

  launch_plan(spec)
      the form of every kernel launch of a step, from the spec alone: tile,
      grid, cluster, stages, shared memory, whether BN rides in the GEMM
      epilogues, and the tile list of the grouped dW + Adam launch. `_CudaOps`
      takes each launch's form and cluster split from it; the C entries form
      the same grids from the matrix shapes and refuse any other.

Both the twin and the kernels run one step program, `_step`, over one set
of buffers; only the operations differ (`_PlainOps`, `_CudaOps`). A CUDA
tensor never falls back to the twin. `build_fused_epoch_call.launches` counts
graph replays. K6, the per-step form with deferred constraint scales, is
ops/cuda_step.py: the same `_step` with two operations swapped.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..constraints import make_fista_constraint, make_simple_norm_constraint
from ..models.mlp import MLPConfig, init_mlp
from ..train.epoch_scan import build_epoch_fn, shuffle_batches
from ..train.trainer import _generator, adam_optimizer
from ..utils.profiling import count as count_event
from ..utils.profiling import span
from ._build import load_library
from .cuda_fista import (fista_launch, fista_preload, fista_project_twin,
                         fista_scratch, fista_state)
from .cuda_spectral import pi_launch, preload
from .spectral import product_spectral_norm_with_state

__all__ = ["FusedStepSpec", "pack_state", "unpack_params", "unpack_opt_state",
           "pad_features", "fused_epoch_plain", "build_fused_epoch_call",
           "build_fused_epoch_fn", "epoch_parity_vs_plain", "parity_bars",
           "GATE_SPREAD_FACTOR", "GATE_LOCKSTEP_STEPS", "order_spread",
           "bn_bar",
           "dropout_keep", "launch_plan", "Launch", "GroupLaunch",
           "KERNEL_SOURCE", "REPLACES"]

KERNEL_SOURCE = "asr_using_robust_nn_tpu_torch/csrc/fused_epoch.cu"
REPLACES = "asr_using_robust_nn_tpu/ops/pallas_train.py:546"
_LANE = 128
_EPS = float(np.spacing(1.0))
_SMALL_KEYS = ("b", "m_b", "v_b", "gamma", "m_gamma", "v_gamma",
               "beta", "m_beta", "v_beta", "rmean", "rvar")
_BF16 = torch.bfloat16


def _pad_to(n: int, m: int = _LANE) -> int:
    return -(-n // m) * m


@dataclass(frozen=True)
class FusedStepSpec:
    """Static geometry and hyperparameters of the fused step program."""

    cfg: MLPConfig
    batch: int
    lr: float = 1e-3
    rho: float | None = None     # the projection's rho; None = no constraint
    pi_iters: int = 4            # simple_norm: power-iteration rounds a step
    # the projection after each step: "simple_norm" (K2: every kernel scaled
    # by (rho / ||W_m^T ... W_1^T||_2)^(1/m)) or "fista" (K7: the FISTA
    # projection of make_fista_constraint(rho, nit, alpha), on the fp32
    # masters); `nit` and `alpha` are FISTA's
    projection: str = "simple_norm"
    nit: int = 2
    alpha: float = 2.1
    # The backward ReLU mask is x^ > -mu * sdinv with x^ stored in bf16. The
    # threshold is rounded to bf16 too, so a dead unit (a = 0, x^ exactly
    # the threshold) stays masked, and a live unit whose x^ would round onto
    # it is stored one bf16 step above it (`_PlainOps.bn_fwd`, K3's
    # xhat_store): the mask is a > 0. True compares against the fp32 threshold,
    # as the JAX package's Pallas kernel does: there about half the dead
    # units round above it and pass gradient. Only the plain twin has this
    # switch (the tests hold it against that kernel); K3 refuses it.
    pallas_relu_mask: bool = False

    def __post_init__(self):
        if self.projection not in ("simple_norm", "fista"):
            raise ValueError(f"unknown projection {self.projection!r} "
                             f"(simple_norm, fista)")

    @property
    def fista(self) -> bool:
        """Whether each step ends with K7's FISTA projection."""
        return self.rho is not None and self.projection == "fista"

    @property
    def dims(self) -> tuple[int, ...]:
        c = self.cfg
        return (c.in_dim,) + tuple(c.hidden) + (c.n_classes,)

    @property
    def pdims(self) -> tuple[int, ...]:
        return tuple(_pad_to(d) for d in self.dims)

    @property
    def n_layers(self) -> int:
        return len(self.dims) - 1

    @property
    def dmax(self) -> int:
        return max(self.pdims[1:])


# --------------------------------------------------------------------------
# packed state
# --------------------------------------------------------------------------

def pack_state(spec: FusedStepSpec, params: dict, state: dict) -> dict:
    """(params, state) -> the padded fstate on the params' device. Adam
    moments and `count` start at 0, `scales` at 1; `u` is drawn from a
    torch.Generator seeded 23 (JAX draws from PRNGKey(23); its values
    differ, models/convert.py carries a JAX-packed u across). Under FISTA
    (`spec.fista`) it also holds K7's power vectors `fista_v`, the
    eigenvectors its Jacobi starts from `fista_u` and its counters `fista_n`
    (ops/cuda_fista.py::fista_state)."""
    dev = params["layers"][0]["w"].device
    pd, m = spec.pdims, spec.n_layers
    masters = []
    for i, p in enumerate(params["layers"]):
        w = torch.zeros((pd[i], pd[i + 1]), device=dev)
        w[: spec.dims[i], : spec.dims[i + 1]] = p["w"]
        masters.append(w)

    def stack_vec(getter):
        a = torch.zeros((m, spec.dmax), device=dev)
        for i in range(m):
            v = getter(i)
            if v is not None:
                a[i, : v.shape[0]] = v
        return a

    hidden = lambda i, d, k: d["layers"][i].get(k) if i < m - 1 else None  # noqa: E731
    small = {
        "b": stack_vec(lambda i: params["layers"][i]["b"]),
        "gamma": stack_vec(lambda i: hidden(i, params, "gamma")),
        "beta": stack_vec(lambda i: hidden(i, params, "beta")),
        "rmean": stack_vec(lambda i: hidden(i, state, "mean")),
        "rvar": stack_vec(lambda i: hidden(i, state, "var")),
    }
    for k in ("b", "gamma", "beta"):
        small["m_" + k] = torch.zeros_like(small[k])
        small["v_" + k] = torch.zeros_like(small[k])
    gen = torch.Generator(device=dev).manual_seed(23)
    fs = {
        "masters": tuple(masters),
        "w16": tuple(w.to(_BF16) for w in masters),
        "mw": tuple(torch.zeros_like(w) for w in masters),
        "vw": tuple(torch.zeros_like(w) for w in masters),
        "small": small,
        "scales": torch.ones((1, _LANE), device=dev),
        "u": torch.randn((1, pd[-1]), generator=gen, device=dev),
        "count": torch.zeros((1,), dtype=torch.int32, device=dev),
    }
    return _with_fista_state(spec, fs, dev)


def _with_fista_state(spec: FusedStepSpec, fs: dict, dev) -> dict:
    if spec.fista:
        st = fista_state(spec.dims, dev)
        fs["fista_v"], fs["fista_u"], fs["fista_n"] = (st["v"], st["u"],
                                                       st["n"])
    return fs


def unpack_params(spec: FusedStepSpec, fstate: dict) -> tuple[dict, dict]:
    """fstate -> (params, state) in the standard layout (copies), with any
    deferred `scales` folded into the kernels."""
    m, dims = spec.n_layers, spec.dims
    sm = fstate["small"]
    layers, slayers = [], []
    for i in range(m):
        d = dims[i + 1]
        w = fstate["masters"][i] * fstate["scales"][0, i]
        p = {"w": w[: dims[i], :d].clone(), "b": sm["b"][i, :d].clone()}
        s = {}
        if i < m - 1 and spec.cfg.batch_norm:
            p["gamma"] = sm["gamma"][i, :d].clone()
            p["beta"] = sm["beta"][i, :d].clone()
            s["mean"] = sm["rmean"][i, :d].clone()
            s["var"] = sm["rvar"][i, :d].clone()
        layers.append(p)
        slayers.append(s)
    return {"layers": layers}, {"layers": slayers}


def unpack_opt_state(spec: FusedStepSpec, fstate: dict, optimizer,
                     params: dict) -> dict:
    """fstate moments/count -> the trainer's Adam state ({"count", "mu",
    "nu"} in `optimizer.moments_dtype`), paired with `unpack_params`."""
    m, dims = spec.n_layers, spec.dims
    sm = fstate["small"]
    dt = optimizer.moments_dtype

    def moments(prefix, stacked):
        layers = []
        for i, p in enumerate(params["layers"][:m]):
            d = dims[i + 1]
            q = {"w": stacked[i][: dims[i], :d].to(dt, copy=True),
                 "b": sm[prefix + "_b"][i, :d].to(dt, copy=True)}
            if "gamma" in p:
                q["gamma"] = sm[prefix + "_gamma"][i, :d].to(dt, copy=True)
                q["beta"] = sm[prefix + "_beta"][i, :d].to(dt, copy=True)
            layers.append(q)
        return {"layers": layers}

    return {"count": fstate["count"][0].clone(),
            "mu": moments("m", fstate["mw"]), "nu": moments("v", fstate["vw"])}


def pad_features(spec: FusedStepSpec, x: torch.Tensor) -> torch.Tensor:
    """(N, in_dim) -> (N, pdims[0]) float32 with zero feature columns."""
    x = x.float()
    pad = spec.pdims[0] - spec.dims[0]
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


# --------------------------------------------------------------------------
# dropout hash (csrc/fused_epoch.cu: mix32 / keep_unit)
# --------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32), without int64 overflow."""
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def dropout_keep(seed: torch.Tensor, layer: int, rows: int, cols: int,
                 keep: float) -> torch.Tensor:
    """(rows, cols) bool mask of kept units: h = mix32((row * cols + col) ^
    mix32(seed + layer)), kept iff (h >> 8) * 2^-24 < keep, bit for bit the
    kernel's draw. `seed` is an int32 tensor (0-d or (1,))."""
    dev = seed.device
    key = _mix32((seed.reshape(()).long() + layer) & _M32)
    idx = (torch.arange(rows, device=dev)[:, None] * cols
           + torch.arange(cols, device=dev)[None, :])
    h = _mix32(idx ^ key)
    u = (h >> 8).float() * (1.0 / (1 << 24))
    return u < torch.tensor(keep, dtype=torch.float32, device=dev)


# --------------------------------------------------------------------------
# the step program and its two sets of operations
# --------------------------------------------------------------------------

def _keeps(spec):
    c = spec.cfg
    return tuple(1.0 - (c.dropout[i] if i < len(c.dropout) else 0.0)
                 for i in range(spec.n_layers - 1))


class _AdamArgs(ctypes.Structure):
    _fields_ = [(k, ctypes.c_float) for k in
                ("lr", "b1", "b2", "omb1", "omb2", "eps", "logb1", "logb2")]


def _adam_consts(spec):
    b1, b2 = 0.9, 0.999
    return dict(lr=spec.lr, b1=b1, b2=b2, omb1=1 - b1, omb2=1 - b2, eps=1e-7,
                logb1=float(np.log(b1)), logb2=float(np.log(b2)))


def _view(buf: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return buf[: rows * cols].view(rows, cols)


# The geometry of csrc/gemm_sm90.cuh and csrc/fused_epoch.cu that the plan is
# written in. The entries launch with the plan's grid, cluster and bytes and
# refuse a plan that does not fit their kernel; `preload_kernels` holds these
# constants to the built library (`asr_fe_geometry`).
_TILE = 64            # kTile: tile rows, columns and depth
_STAGES = 4           # kStages
_THREADS = 128        # kThreads: one warpgroup
_RING_BYTES = 1024 + 2 * _STAGES * _TILE * 128   # alignment slack + the ring
_STATE_BYTES = 3 * _TILE * _TILE * 4             # dW: master and moments
# the grouped dW + Adam launch: a block holds a 3-stage ring alone (the state
# goes through registers), four persistent blocks an SM of an H100's 132
_GROUP_STAGES = 3       # kGroupStages
_GROUP_SMEM = 1024 + 2 * _GROUP_STAGES * _TILE * 128
_GROUP_MAX_LAYERS = 16  # kGroupMaxLayers
_GROUP_BLOCKS = 4 * 132
_MAX_CLUSTER = 8      # the portable cluster size
_CE_ROWS = 8          # fe_ce: rows per block
_CE_MAX_WIDTH = 512   # fe_ce: widest padded class dimension
_COL_WIDTH = 8        # column kernels: columns per block
SMEM_LIMIT = 232448   # shared memory one block may use on an H100


@dataclass(frozen=True)
class Launch:
    """One kernel launch of a step. `grid` and `cluster` are (x, y, z) in
    blocks; x walks the output's 64-column tiles, y its 64-row tiles, z the
    depth split. `cluster_axis` names what the cluster's blocks share:
    "batch" (a column tile's rows, for the BN sums) or "depth" (one dW tile,
    each block a slice of the batch). `smem_bytes` is the dynamic shared
    memory of a block (the kernels' few KB of static exchange arrays come on
    top; `preload_kernels` checks the sum on the device). `dims()` is what
    the C entry launches with."""

    kernel: str
    rows: int
    cols: int
    depth: int
    tile: tuple[int, int, int]
    grid: tuple[int, int, int]
    cluster: tuple[int, int, int]
    cluster_axis: str | None
    stages: int
    smem_bytes: int
    bn_in_epilogue: bool = False

    @property
    def cluster_size(self) -> int:
        return self.cluster[0] * self.cluster[1] * self.cluster[2]

    def dims(self):
        """The launch for a C entry: grid, cluster, dynamic bytes."""
        return (ctypes.c_int * 7)(*self.grid, *self.cluster, self.smem_bytes)

    def rank_rows(self) -> list[tuple[int, int]]:
        """dW only: [row0, row1) of the 64-row tile that each depth rank sums
        across the cluster and runs Adam on."""
        own = _TILE // self.cluster[2]
        return [(r * own, (r + 1) * own) for r in range(self.cluster[2])]

    def rank_depth(self) -> list[tuple[int, int]]:
        """dW only: the [k0, k1) slice of the depth each rank multiplies."""
        per = self.depth // self.cluster[2]
        return [(r * per, (r + 1) * per) for r in range(self.cluster[2])]


@dataclass(frozen=True)
class GroupLaunch:
    """The grouped dW + Adam launch of a step (`fe_dw_adam_group`): `grid`
    persistent blocks (four an SM) walk one list of the 64 x 64 output
    tiles of every layer's dW; block b takes tiles b, b + G, b + 2G, ...
    (G = grid[0]). `layers` lists (layer, rows, cols, split) in list order,
    the largest layer first; a layer's tiles are listed row-major. `split`
    is the per-layer plan's depth split: the block sums each of `split`
    depth slices in its own accumulator and adds them in rank order, as the
    per-layer launch's cluster does. `dims()` is what the C entry launches
    with (no cluster)."""

    kernel: str
    layers: tuple[tuple[int, int, int, int], ...]
    depth: int
    grid: tuple[int, int, int]
    stages: int
    smem_bytes: int
    cluster: tuple[int, int, int] = (1, 1, 1)
    cluster_size: int = 1

    @property
    def n_tiles(self) -> int:
        return sum((r // _TILE) * (c // _TILE) for _, r, c, _ in self.layers)

    def dims(self):
        """The launch for the C entry: grid, cluster, dynamic bytes."""
        return (ctypes.c_int * 7)(*self.grid, *self.cluster, self.smem_bytes)

    def tiles(self) -> list[tuple[int, int, int]]:
        """(layer, row0, col0) of every tile, in list order."""
        return [(i, r0, c0) for i, rows, cols, _ in self.layers
                for r0 in range(0, rows, _TILE)
                for c0 in range(0, cols, _TILE)]

    def block_tiles(self, b: int) -> list[tuple[int, int, int]]:
        """The tiles block `b` updates, in its order."""
        return self.tiles()[b::self.grid[0]]

    def depth_slices(self, layer: int) -> list[tuple[int, int]]:
        """The [k0, k1) depth slices whose sums layer `layer`'s tiles add
        in order."""
        split = next(sp for i, _, _, sp in self.layers if i == layer)
        per = self.depth // split
        return [(r * per, (r + 1) * per) for r in range(split)]


def _dw_split(tiles: int, depth_tiles: int) -> int:
    """Blocks along the depth for a dW product of `tiles` output tiles: the
    smallest power of two (at most the cluster limit, dividing the depth
    tiles) that brings the grid to 128 blocks."""
    split = 1
    while (split < _MAX_CLUSTER and tiles * split < 128
           and depth_tiles % (2 * split) == 0):
        split *= 2
    return split


def launch_plan(spec: FusedStepSpec) -> dict:
    """The kernel launches of one step, decided from the spec alone (the
    counterpart of ops/cuda_spectral.py::pi_plan for K3 and K6):

      {"bn_in_epilogue": bool,
       "fwd": [Launch per layer], "ce": Launch,
       "dx": [None, Launch per layer 1..m-1], "dw": [Launch per layer],
       "dw_group": GroupLaunch or None,
       "bn_fwd" / "bn_bwd": [Launch per hidden layer] (column form only)}

    BN rides in the GEMM epilogues when the batch is 1, 2, 4 or 8 row tiles:
    the blocks of a column tile then form one cluster along the batch. Any
    other batch takes plain-epilogue GEMMs and the column kernels. A dW
    launch also holds its block's rows of the master and both moments in
    shared memory. K3 updates every layer in the one grouped launch
    `dw_group` (None past _GROUP_MAX_LAYERS layers: then the per-layer
    launches), with each layer's depth split as its per-layer launch has
    it; K6 keeps the per-layer launches. Raises ValueError for a spec the
    kernels do not take."""
    B, pd, m = spec.batch, spec.pdims, spec.n_layers
    if spec.pallas_relu_mask:
        raise ValueError("FusedStepSpec.pallas_relu_mask: K3 masks with "
                         "the bf16 threshold only; the Pallas rule runs "
                         "in the plain twin")
    if B <= 0 or B % _TILE:
        raise ValueError(f"fused kernels: batch must be a positive multiple "
                         f"of {_TILE}, got {B}")
    if pd[-1] > _CE_MAX_WIDTH:
        raise ValueError(f"fused kernels: at most {_CE_MAX_WIDTH} padded "
                         f"classes, got {pd[-1]}")
    if any(d % _TILE for d in pd) or pd[-1] % _LANE:
        raise ValueError(f"fused kernels: padded widths must be multiples "
                         f"of {_TILE} and the class width of {_LANE}, got "
                         f"{pd}")
    row_tiles = B // _TILE
    fused = row_tiles in (1, 2, 4, 8)
    tile = (_TILE, _TILE, _TILE)

    def gemm(kernel, rows, cols, depth, cluster=(1, 1, 1), axis=None,
             extra=0, bn=False):
        grid = (cols // _TILE, rows // _TILE, cluster[2])
        return Launch(kernel, rows, cols, depth, tile, grid, cluster, axis,
                      _STAGES, _RING_BYTES + extra, bn)

    def column(kernel, rows, cols):
        return Launch(kernel, rows, cols, 0, (rows, _COL_WIDTH, 0),
                      (cols // _COL_WIDTH, 1, 1), (1, 1, 1), None, 0, 0)

    along_batch = (1, row_tiles, 1)
    fwd, dx, dw = [], [None], []
    for i in range(m):
        if i == m - 1:
            fwd.append(gemm("logits", B, pd[i + 1], pd[i]))
        elif fused:
            fwd.append(gemm("fwd_bn", B, pd[i + 1], pd[i], along_batch,
                            "batch", bn=True))
        else:
            fwd.append(gemm("gemm_fwd", B, pd[i + 1], pd[i]))
        if i > 0:
            dx.append(gemm("dx_bn", B, pd[i], pd[i + 1], along_batch, "batch",
                           bn=True) if fused
                      else gemm("gemm_dx", B, pd[i], pd[i + 1]))
        split = _dw_split((pd[i] // _TILE) * (pd[i + 1] // _TILE), row_tiles)
        dw.append(gemm("dw_adam", pd[i], pd[i + 1], B, (1, 1, split), "depth",
                       extra=_STATE_BYTES))
    ce = Launch("ce", B, pd[-1], 0, (_CE_ROWS, pd[-1], 0),
                (B // _CE_ROWS, 1, 1), (1, 1, 1), None, 0, 0)
    group = None
    if m <= _GROUP_MAX_LAYERS:
        order = sorted(range(m), key=lambda i: -pd[i] * pd[i + 1])
        layers = tuple((i, pd[i], pd[i + 1], dw[i].cluster[2]) for i in order)
        n_tiles = sum((r // _TILE) * (c // _TILE) for _, r, c, _ in layers)
        group = GroupLaunch("dw_adam_group", layers, B,
                            (min(n_tiles, _GROUP_BLOCKS), 1, 1),
                            _GROUP_STAGES, _GROUP_SMEM)
    plan = {"bn_in_epilogue": fused, "fwd": fwd, "ce": ce, "dx": dx, "dw": dw,
            "dw_group": group, "bn_fwd": [], "bn_bwd": []}
    if not fused:
        plan["bn_fwd"] = [column("bn_fwd", B, pd[i + 1]) for i in range(m - 1)]
        plan["bn_bwd"] = [column("bn_bwd", B, pd[i + 1]) for i in range(m - 1)]
    return plan


def plan_launches(plan: dict, grouped: bool = True) -> list:
    """Every launch of `plan` in step order (the projection and the
    prologue aside): the forward, the CCE, the dX chain, then the weight
    updates, as K3's grouped launch (`grouped`, where the plan has one) or
    as the per-layer launches K6 makes."""
    m = len(plan["fwd"])
    out = []
    for i in range(m):
        out.append(plan["fwd"][i])
        if i < m - 1 and plan["bn_fwd"]:
            out.append(plan["bn_fwd"][i])
    out.append(plan["ce"])
    for i in range(m - 1, 0, -1):
        out.append(plan["dx"][i])
        if plan["bn_bwd"]:
            out.append(plan["bn_bwd"][i - 1])
    if grouped and plan["dw_group"] is not None:
        out.append(plan["dw_group"])
    else:
        out.extend(plan["dw"][i] for i in range(m - 1, -1, -1))
    return out


def _scratch(spec: FusedStepSpec, device) -> dict:
    """Every buffer a step uses besides the state; reused by every step.
    `z` and `da` (fp32) are touched only where BN runs as separate kernels
    (and by the twin); `dzb[i]` is layer i's dZ (B, pdims[i + 1]) in bf16,
    one buffer a layer, since every dW product runs after the whole dX
    chain. Under FISTA, K7's scratch under `fista_<name>`."""
    B, pd, m, dmax = spec.batch, spec.pdims, spec.n_layers, spec.dmax
    f32 = dict(dtype=torch.float32, device=device)
    sc = {
        "acts": [torch.empty((B, pd[i]), dtype=_BF16, device=device)
                 for i in range(m)],
        "xhats": [torch.empty((B, pd[i + 1]), dtype=_BF16, device=device)
                  for i in range(m - 1)],
        "z": torch.empty(B * dmax, **f32),
        "da": torch.empty(B * dmax, **f32),
        "dzb": [torch.empty((B, pd[i + 1]), dtype=_BF16, device=device)
                for i in range(m)],
        "muvec": torch.zeros((m, dmax), **f32),
        "sdvec": torch.zeros((m, dmax), **f32),
        "denom": torch.empty(1, **f32),
        "sigma": torch.empty(1, **f32),
        "ce_part": torch.zeros(-(-B // _CE_ROWS) * (pd[-1] + 2), **f32),
        "ce_ticket": torch.zeros(1, dtype=torch.int32, device=device),
    }
    if spec.fista:
        sc.update({"fista_" + k: v for k, v in fista_scratch(
            spec.dims, device).items()})
    return sc


def _fista_scratch_of(sc: dict) -> dict:
    return {k[len("fista_"):]: v for k, v in sc.items()
            if k.startswith("fista_")}


def _fista_state_of(fs: dict) -> dict:
    return {"v": fs["fista_v"], "u": fs["fista_u"], "n": fs["fista_n"]}


def _step(ops, spec, fs, sc, x, y, w, seeds, s, losses, accs):
    """One training step on the packed state (Pallas `_make_epoch_kernel`
    body): forward, CCE, the dX chain with Adam on each layer's small
    vectors, then every layer's dW with Adam on the kernels, projection.
    dX of layer i - 1 reads layer i's bf16 kernel before the weight update
    writes it, and nothing else the backward reads is written by a dW, so
    updating the kernels after the chain changes no result."""
    m, pd, B = spec.n_layers, spec.pdims, spec.batch
    sm = fs["small"]
    dzb = sc["dzb"]
    ops.prologue(x, w, sc["acts"][0], sc["denom"])
    for i in range(m - 1):
        ops.hidden_fwd(i, sc["acts"][i], fs["w16"][i], sm, w, sc,
                       sc["xhats"][i], sc["acts"][i + 1], seeds, s)
    z = _view(sc["z"], B, pd[-1])
    ops.gemm_fwd(m - 1, sc["acts"][m - 1], fs["w16"][m - 1], sm["b"][m - 1],
                 z, spec.cfg.n_classes)
    ops.ce_bwd(m - 1, z, y, w, sm, sc, losses, accs, s, dzb[m - 1],
               fs["count"])
    for i in range(m - 1, 0, -1):
        ops.dx_bn_bwd(i - 1, dzb[i], fs["w16"][i], sc["xhats"][i - 1], w, sm,
                      sc, dzb[i - 1], seeds, s, fs["count"])
    ops.dw_adam_all(sc["acts"], dzb, fs, fs["count"], s)
    if spec.rho is not None:
        ops.project(fs, sc)


def _bf16_next_up(t):
    """The bf16 value one step above each element of the bf16 tensor `t`
    (csrc/fused_epoch.cu::bf16_next_up)."""
    b = t.view(torch.int16)
    up = torch.where(b < 0, b - 1, b + 1)  # a negative value moves to zero
    up = torch.where((b & 0x7FFF) == 0, torch.ones_like(b), up)
    return up.view(_BF16)


class _ComposedOps:
    """The fused operations of `_step` as compositions of the separate
    ones: the forward and the dX with BN through the fp32 scratch `z` and
    `da` (what the twin computes, and what the kernels launch where BN does
    not ride in a GEMM epilogue), and the weight updates of every layer as
    one `gemm_dw_adam` a layer (the twin, and K6's launches)."""

    def dw_adam_all(self, acts, dzbs, fs, count, s):
        """dW + Adam of every layer, after the dX chain: layer i's dW =
        acts[i]^T . dzbs[i], then Adam, NonNeg and the bf16 copy."""
        for i in range(len(dzbs) - 1, -1, -1):
            self.gemm_dw_adam(i, acts[i], dzbs[i], fs, count, s)

    def hidden_fwd(self, i, a16, w16, sm, w, sc, xhat, act_next, seeds, s):
        z = _view(sc["z"], a16.shape[0], w16.shape[1])
        self.gemm_fwd(i, a16, w16, sm["b"][i], z, -1)
        self.bn_fwd(i, z, w, sc["denom"], sm, sc["muvec"][i], sc["sdvec"][i],
                    xhat, act_next, seeds, s)

    def dx_bn_bwd(self, i, dzb_up, w16_up, xhat, w, sm, sc, dzb, seeds, s,
                  count):
        da = _view(sc["da"], dzb.shape[0], dzb.shape[1])
        self.gemm_dx(i + 1, dzb_up, w16_up, da)
        self.bn_bwd(i, da, xhat, w, sc["denom"], sm, sc["muvec"][i],
                    sc["sdvec"][i], dzb, seeds, s, count)


def _epoch(ops, spec, fs, sc, xs, ys, ws, seeds, losses, accs):
    """All steps of one epoch; the bf16 copies start and end as a cast of
    the masters, and `count` advances by the number of steps."""
    m = spec.n_layers
    for i in range(m):
        ops.cast_w16(fs["masters"][i], fs["w16"][i])
    for s in range(xs.shape[0]):
        _step(ops, spec, fs, sc, xs[s], ys[s], ws[s], seeds, s, losses, accs)
    ops.count_add(fs["count"], xs.shape[0])
    for i in range(m):
        ops.cast_w16(fs["masters"][i], fs["w16"][i])


class _PlainOps(_ComposedOps):
    """The step's operations in PyTorch, writing the same buffers."""

    def __init__(self, spec: FusedStepSpec):
        self.spec = spec
        self.keeps = _keeps(spec)
        self.a = _adam_consts(spec)

    def _bc(self, count, s):
        t = (count + s + 1).float()
        return (1.0 - torch.exp(t * self.a["logb1"]),
                1.0 - torch.exp(t * self.a["logb2"]))

    def _adam(self, p, mw, vw, g, bc1, bc2):
        a = self.a
        mn = a["b1"] * mw + a["omb1"] * g
        vn = a["b2"] * vw + a["omb2"] * g * g
        upd = (mn / bc1) / (torch.sqrt(vn / bc2) + a["eps"])
        return p - a["lr"] * upd, mn, vn

    def _small_adam(self, sm, key, i, g, bc1, bc2):
        d = g.shape[0]
        p, mn, vn = self._adam(sm[key][i, :d], sm["m_" + key][i, :d],
                               sm["v_" + key][i, :d], g, bc1, bc2)
        sm[key][i, :d] = p
        sm["m_" + key][i, :d] = mn
        sm["v_" + key][i, :d] = vn

    def colsum(self, t):
        """Sum over the batch rows. A check may replace the order (the
        kernels add 64-row blocks in rank order)."""
        return torch.sum(t, 0)

    def dw_product(self, i, acts, dzb):
        """dW of layer i in fp32 from the bf16 operands. A check may replace
        the order (the kernels add depth slices in rank order)."""
        return acts.float().T @ dzb.float()

    def cast_w16(self, master, w16):
        w16.copy_(master.to(_BF16))

    def prologue(self, x, w, acts0, denom):
        acts0.copy_(x.to(_BF16))
        denom.copy_((torch.sum(w) + 1e-9).reshape(1))

    def gemm_fwd(self, i, a16, w16, bias_row, out, n_classes):
        d = out.shape[1]
        z = a16.float() @ w16.float() + bias_row[:d]
        if n_classes >= 0:
            cmask = torch.arange(d, device=z.device) >= n_classes
            z = torch.where(cmask, -1e9, z)
        else:
            z = torch.clamp_min(z, 0.0)
        out.copy_(z)

    def bn_fwd(self, i, a, w, denom, sm, muvec, sdvec, xhat, act_next, seeds,
               s):
        c = self.spec.cfg
        d = a.shape[1]
        if c.batch_norm:
            wc = w[:, None]
            mu = self.colsum(a * wc) / denom
            var = self.colsum(((a - mu) ** 2) * wc) / denom
            sdinv = torch.rsqrt(var + c.bn_eps)
            muvec[:d] = mu
            sdvec[:d] = sdinv
            xh = (a - mu) * sdinv
            out = xh * sm["gamma"][i, :d] + sm["beta"][i, :d]
            mom = c.bn_momentum
            sm["rmean"][i, :d] = mom * sm["rmean"][i, :d] + (1 - mom) * mu
            sm["rvar"][i, :d] = mom * sm["rvar"][i, :d] + (1 - mom) * var
        else:
            xh = out = a
            muvec[:d] = 0.0
            sdvec[:d] = 1.0
        xb = xh.to(_BF16)
        if c.batch_norm and not self.spec.pallas_relu_mask:
            # a live unit (a > 0) whose x^ rounds onto the ReLU threshold
            # -mu * sdinv is stored one bf16 step above it, so that the
            # backward's mask (x^ > the bf16 threshold) is exact
            thr = (-mu * sdinv).to(_BF16)
            xb = torch.where((a > 0) & (xb <= thr), _bf16_next_up(thr), xb)
        xhat.copy_(xb)
        keep = self.keeps[i]
        if keep < 1.0:
            mask = dropout_keep(seeds[s], i, a.shape[0], d, keep)
            out = torch.where(mask, out / keep, 0.0)
        act_next.copy_(out.to(_BF16))

    def ce(self, logits, y, w, denom, losses, accs, s, dz):
        zmax = torch.max(logits, 1, keepdim=True).values
        ez = torch.exp(logits - zmax)
        sez = torch.sum(ez, 1, keepdim=True)
        probs = ez / sez
        onehot = (torch.arange(logits.shape[1], device=logits.device)[None]
                  == y[:, None]).float()
        logp = logits - zmax - torch.log(sez)
        nll = -torch.sum(logp * onehot, 1)
        losses[s] = torch.sum(nll * w) / denom[0]
        pred = torch.argmax(logits, 1)
        accs[s] = torch.sum((pred == y).float() * w) / denom[0]
        dz.copy_((probs - onehot) * w[:, None] / denom)

    def ce_bwd(self, i, logits, y, w, sm, sc, losses, accs, s, dzb, count):
        """CCE and the output layer's backward: its dZ in bf16, Adam on its
        bias."""
        da = _view(sc["da"], logits.shape[0], logits.shape[1])
        self.ce(logits, y, w, sc["denom"], losses, accs, s, da)
        self.bn_bwd(i, da, None, w, sc["denom"], sm, sc["muvec"][i],
                    sc["sdvec"][i], dzb, None, s, count)

    def bn_bwd(self, i, dD, xhat, w, denom, sm, muvec, sdvec, dzb, seeds, s,
               count):
        c = self.spec.cfg
        d = dD.shape[1]
        bc1, bc2 = self._bc(count, s)
        if xhat is None:  # output layer
            dz = dD
        else:
            keep = self.keeps[i]
            if keep < 1.0:
                mask = dropout_keep(seeds[s], i, dD.shape[0], d, keep)
                dD = torch.where(mask, dD / keep, 0.0)
            xh = xhat.float()
            if c.batch_norm:
                dgamma = self.colsum(dD * xh)
                dbeta = self.colsum(dD)
                dxh = dD * sm["gamma"][i, :d]  # gamma before its update
                self._small_adam(sm, "gamma", i, dgamma, bc1, bc2)
                self._small_adam(sm, "beta", i, dbeta, bc1, bc2)
                da = self.bn_dx(dxh, xh, (w / denom)[:, None],
                                sdvec[:d][None])
                # a > 0 <=> x^ > -mu * sdinv (FusedStepSpec.pallas_relu_mask)
                thr = -muvec[:d] * sdvec[:d]
                if not self.spec.pallas_relu_mask:
                    thr = thr.to(_BF16).float()
                relu = xh > thr[None]
            else:
                da = dD
                relu = xh > 0.0
            dz = torch.where(relu, da, 0.0)
        self._small_adam(sm, "b", i, self.colsum(dz), bc1, bc2)
        dzb.copy_(dz.to(_BF16))

    def bn_dx(self, dxh, xh, wd, sd):
        """dL/da of the row-weighted BN from dL/dx^ (wd = w / denom)."""
        s1 = self.colsum(dxh)[None]
        s2 = self.colsum(dxh * xh)[None]
        return sd * (dxh - wd * s1 - wd * xh * s2)

    def gemm_dx(self, i, dzb, w16, out):
        """dX of layer i's input from its dZ and its kernel."""
        out.copy_(dzb.float() @ w16.float().T)

    def load_master(self, fs, i):
        """The fp32 master Adam starts from (K3: kept current)."""
        return fs["masters"][i]

    def gemm_dw_adam(self, i, acts, dzb, fs, count, s):
        g = self.dw_product(i, acts, dzb)
        bc1, bc2 = self._bc(count, s)
        wn, mn, vn = self._adam(self.load_master(fs, i), fs["mw"][i],
                                fs["vw"][i], g, bc1, bc2)
        if self.spec.cfg.nonneg:
            wn = torch.clamp_min(wn, 0.0)
        fs["masters"][i].copy_(wn)
        fs["mw"][i].copy_(mn)
        fs["vw"][i].copy_(vn)
        fs["w16"][i].copy_(wn.to(_BF16))

    def rescale(self, fs, i, f):
        """Apply layer i's projection factor (K3: eagerly, masters too)."""
        fs["w16"][i].copy_((fs["w16"][i].float() * f).to(_BF16))
        fs["masters"][i].mul_(f)

    def project(self, fs, sc):
        spec = self.spec
        if spec.fista:
            fista_project_twin(list(fs["masters"]), list(fs["w16"]),
                               _fista_state_of(fs), spec.dims, spec.rho,
                               spec.nit, spec.alpha, spec.cfg.nonneg)
            return
        m = spec.n_layers
        sigma, u = product_spectral_norm_with_state(
            [w.float() for w in fs["w16"]], fs["u"][0], n_iter=spec.pi_iters,
            eps=_EPS, matvec_dtype=_BF16)
        fs["u"][0] = u
        inv_m = float(np.float32(1.0 / m))
        for i in range(m):
            f = torch.exp(torch.log(spec.rho / (sigma + _EPS)) * inv_m)
            self.rescale(fs, i, f)
            sigma = sigma * f

    def count_add(self, count, n):
        count.add_(n)


@functools.cache
def _lib():
    lib = load_library("fused_epoch")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    adam = ctypes.POINTER(_AdamArgs)
    dims = ctypes.POINTER(ctypes.c_int)  # Launch.dims()
    sig = {
        "asr_fe_cast_bf16": [p, p, ctypes.c_longlong, p],
        "asr_fe_prologue": [p, p, p, p, i, i, p],
        "asr_fe_gemm_fwd": [p, p, p, p, i, i, i, i, dims, p],
        "asr_fe_gemm_dx": [p, p, p, i, i, i, dims, p],
        "asr_fe_fwd_bn": [p] * 13 + [i, i, i, i, f, f, f, f, p, i, i, dims,
                                     p],
        "asr_fe_ce": [p, p, p, p, i, i, p, p, i, p, p, p, p, p, adam, dims,
                      p],
        "asr_fe_dx_bn": [p] * 9 + [i, i, i, i, f, p, i, i, p, adam, dims, p],
        "asr_fe_gemm_dw_adam": [p, p, p, p, p, p, i, i, i, p, i, adam, i,
                                dims, p],
        "asr_fe_dw_adam_group": [p, dims, i, i, p, i, adam, i, dims, p],
        "asr_fe_bn_fwd": [p, i, i, p, p, p, p, p, p, p, p, p, p, i, f, f, f,
                          f, p, i, i, dims, p],
        "asr_fe_bn_bwd": [i, p, i, i, p, p, p, p, p, p, p, f, p, i, i, p,
                          adam, dims, p],
        "asr_fe_count_add": [p, i, p],
        "asr_fe_geometry": [dims],
        "asr_fe_preload": [ctypes.POINTER(ctypes.c_int)],
    }
    for name, argtypes in sig.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check(name, rc):
    if rc != 0:
        raise RuntimeError(f"fused training kernel {name} launch failed: CUDA "
                           f"error {rc}")


def preload_kernels(lib, entry: str = "asr_fe_preload") -> int:
    """Load a fused-kernel library's kernels and opt them in to their shared
    memory, before a graph capture. Returns how many 8-block clusters of its
    cluster kernels the device holds at once and raises if that is 0."""
    n = ctypes.c_int(0)
    _check("preload", getattr(lib, entry)(ctypes.byref(n)))
    if entry == "asr_fe_preload":
        kernel_geometry(lib)
    if n.value < 1:
        raise RuntimeError("the fused training kernels launch thread-block "
                           "clusters of 8 blocks, and this device cannot "
                           "schedule one")
    return n.value


def kernel_geometry(lib) -> dict:
    """The constants of the built csrc/fused_epoch.cu and the static shared
    memory of its kernels as loaded on the current device. Raises if the
    plan's constants are not the library's, or if a block's dynamic and
    static bytes together pass `SMEM_LIMIT`."""
    out = (ctypes.c_int * 17)()
    _check("geometry", lib.asr_fe_geometry(out))
    built = tuple(out[:10])
    mine = (_TILE, _STAGES, _CE_ROWS, _CE_MAX_WIDTH, _COL_WIDTH, _RING_BYTES,
            _RING_BYTES + _STATE_BYTES, _THREADS, _GROUP_SMEM,
            _GROUP_MAX_LAYERS)
    if built != mine:
        raise RuntimeError(f"launch_plan is written for the kernel geometry "
                           f"{mine}, the built library has {built}")
    static = dict(zip(("fwd_bn", "dx_bn", "dw_adam", "ce", "bn_fwd",
                       "bn_bwd", "dw_adam_group"), out[10:]))
    dynamic = {"fwd_bn": _RING_BYTES, "dx_bn": _RING_BYTES,
               "dw_adam": _RING_BYTES + _STATE_BYTES,
               "dw_adam_group": _GROUP_SMEM}
    for k, v in static.items():
        if v + dynamic.get(k, 0) > SMEM_LIMIT:
            raise RuntimeError(f"{k}: {v} static + {dynamic.get(k, 0)} "
                               f"dynamic bytes of shared memory a block")
    return {"static_smem": static, "dynamic_smem": dynamic}


_SMALL_ROWS = ("gamma", "m_gamma", "v_gamma", "beta", "m_beta", "v_beta",
               "b", "m_b", "v_b")


class _CudaOps(_ComposedOps):
    """The step's operations as launches of csrc/fused_epoch.cu's kernels
    (and K2's for the projection) on the current stream, in the forms
    `launch_plan(spec)` gives. `launched` counts the kernels enqueued: after
    a capture, the graph's kernel nodes."""

    def __init__(self, spec: FusedStepSpec):
        self.plan = launch_plan(spec)
        self.spec = spec
        self.lib = _lib()
        self.launched = 0
        self.keeps = _keeps(spec)
        self.adam = _AdamArgs(**_adam_consts(spec))
        c = spec.cfg
        self.bn = (int(c.batch_norm), c.bn_eps, c.bn_momentum,
                   1 - c.bn_momentum)

    @staticmethod
    def _stream():
        return torch.cuda.current_stream().cuda_stream

    def _ran(self, name, rc):
        _check(name, rc)
        self.launched += 1

    def _small_rows(self, sm, i, keys=_SMALL_ROWS):
        return (ctypes.c_void_p * len(keys))(
            *[sm[k][i].data_ptr() for k in keys])

    def cast_w16(self, master, w16):
        self._ran("cast", self.lib.asr_fe_cast_bf16(
            master.data_ptr(), w16.data_ptr(), master.numel(), self._stream()))

    def prologue(self, x, w, acts0, denom):
        self._ran("prologue", self.lib.asr_fe_prologue(
            x.data_ptr(), acts0.data_ptr(), w.data_ptr(), denom.data_ptr(),
            x.shape[0], x.shape[1], self._stream()))

    def gemm_fwd(self, i, a16, w16, bias_row, out, n_classes):
        M, K = a16.shape
        self._ran("gemm_fwd", self.lib.asr_fe_gemm_fwd(
            a16.data_ptr(), w16.data_ptr(), bias_row.data_ptr(),
            out.data_ptr(), M, w16.shape[1], K, n_classes,
            self.plan["fwd"][i].dims(), self._stream()))

    def hidden_fwd(self, i, a16, w16, sm, w, sc, xhat, act_next, seeds, s):
        if not self.plan["bn_in_epilogue"]:
            return super().hidden_fwd(i, a16, w16, sm, w, sc, xhat, act_next,
                                      seeds, s)
        use_bn, eps, mom, omm = self.bn
        M, K = a16.shape
        self._ran("fwd_bn", self.lib.asr_fe_fwd_bn(
            a16.data_ptr(), w16.data_ptr(), sm["b"][i].data_ptr(),
            w.data_ptr(), sc["denom"].data_ptr(), sm["gamma"][i].data_ptr(),
            sm["beta"][i].data_ptr(), sm["rmean"][i].data_ptr(),
            sm["rvar"][i].data_ptr(), sc["muvec"][i].data_ptr(),
            sc["sdvec"][i].data_ptr(), xhat.data_ptr(), act_next.data_ptr(),
            M, w16.shape[1], K, use_bn, eps, mom, omm, self.keeps[i],
            seeds.data_ptr(), s, i, self.plan["fwd"][i].dims(),
            self._stream()))

    def bn_fwd(self, i, a, w, denom, sm, muvec, sdvec, xhat, act_next, seeds,
               s):
        use_bn, eps, mom, omm = self.bn
        self._ran("bn_fwd", self.lib.asr_fe_bn_fwd(
            a.data_ptr(), a.shape[0], a.shape[1], w.data_ptr(),
            denom.data_ptr(), sm["gamma"][i].data_ptr(),
            sm["beta"][i].data_ptr(), sm["rmean"][i].data_ptr(),
            sm["rvar"][i].data_ptr(), muvec.data_ptr(), sdvec.data_ptr(),
            xhat.data_ptr(), act_next.data_ptr(), use_bn, eps, mom, omm,
            self.keeps[i], seeds.data_ptr(), s, i,
            self.plan["bn_fwd"][i].dims(), self._stream()))

    def ce_bwd(self, i, logits, y, w, sm, sc, losses, accs, s, dzb, count):
        self._ran("ce", self.lib.asr_fe_ce(
            logits.data_ptr(), y.data_ptr(), w.data_ptr(),
            sc["denom"].data_ptr(), logits.shape[0], logits.shape[1],
            losses.data_ptr(), accs.data_ptr(), s, dzb.data_ptr(),
            sc["ce_part"].data_ptr(), sc["ce_ticket"].data_ptr(),
            self._small_rows(sm, i, ("b", "m_b", "v_b")), count.data_ptr(),
            ctypes.byref(self.adam), self.plan["ce"].dims(), self._stream()))

    def dx_bn_bwd(self, i, dzb_up, w16_up, xhat, w, sm, sc, dzb, seeds, s,
                  count):
        if not self.plan["bn_in_epilogue"]:
            return super().dx_bn_bwd(i, dzb_up, w16_up, xhat, w, sm, sc, dzb,
                                     seeds, s, count)
        self._ran("dx_bn", self.lib.asr_fe_dx_bn(
            dzb_up.data_ptr(), w16_up.data_ptr(), xhat.data_ptr(),
            w.data_ptr(), sc["denom"].data_ptr(), self._small_rows(sm, i),
            sc["muvec"][i].data_ptr(), sc["sdvec"][i].data_ptr(),
            dzb.data_ptr(), dzb_up.shape[0], w16_up.shape[0], w16_up.shape[1],
            1 if self.spec.cfg.batch_norm else 2, self.keeps[i],
            seeds.data_ptr(), s, i, count.data_ptr(),
            ctypes.byref(self.adam), self.plan["dx"][i + 1].dims(),
            self._stream()))

    def bn_bwd(self, i, dD, xhat, w, denom, sm, muvec, sdvec, dzb, seeds, s,
               count):
        self._ran("bn_bwd", self.lib.asr_fe_bn_bwd(
            1 if self.spec.cfg.batch_norm else 2, dD.data_ptr(), dD.shape[0],
            dD.shape[1], xhat.data_ptr(), w.data_ptr(), denom.data_ptr(),
            self._small_rows(sm, i), muvec.data_ptr(), sdvec.data_ptr(),
            dzb.data_ptr(), self.keeps[i], seeds.data_ptr(), s, i,
            count.data_ptr(), ctypes.byref(self.adam),
            self.plan["bn_bwd"][i].dims(), self._stream()))

    def gemm_dx(self, i, dzb, w16, out):
        self._ran("gemm_dx", self.lib.asr_fe_gemm_dx(
            dzb.data_ptr(), w16.data_ptr(), out.data_ptr(), dzb.shape[0],
            w16.shape[0], w16.shape[1], self.plan["dx"][i].dims(),
            self._stream()))

    def gemm_dw_adam(self, i, acts, dzb, fs, count, s):
        K, M = acts.shape
        count_event("k3.dw_layer")
        self._ran("gemm_dw_adam", self.lib.asr_fe_gemm_dw_adam(
            acts.data_ptr(), dzb.data_ptr(), fs["masters"][i].data_ptr(),
            fs["mw"][i].data_ptr(), fs["vw"][i].data_ptr(),
            fs["w16"][i].data_ptr(), M, dzb.shape[1], K, count.data_ptr(), s,
            ctypes.byref(self.adam), int(self.spec.cfg.nonneg),
            self.plan["dw"][i].dims(), self._stream()))

    def dw_adam_all(self, acts, dzbs, fs, count, s):
        """Every layer's dW + Adam in the one grouped launch of the plan
        (`fe_dw_adam_group`), where it has one."""
        g = self.plan["dw_group"]
        if g is None:
            return super().dw_adam_all(acts, dzbs, fs, count, s)
        keys = ("masters", "mw", "vw", "w16")
        ptrs = (ctypes.c_void_p * (6 * len(g.layers)))(*[
            t.data_ptr() for i, _, _, _ in g.layers
            for t in (acts[i], dzbs[i], *(fs[k][i] for k in keys))])
        shape = (ctypes.c_int * (4 * len(g.layers)))(*[
            v for layer in g.layers for v in layer])
        count_event("k3.dw_group")
        self._ran("dw_adam_group", self.lib.asr_fe_dw_adam_group(
            ptrs, shape, len(g.layers), g.depth, count.data_ptr(), s,
            ctypes.byref(self.adam), int(self.spec.cfg.nonneg), g.dims(),
            self._stream()))

    def project(self, fs, sc):
        spec = self.spec
        if spec.fista:
            fista_launch(list(fs["masters"]), list(fs["w16"]),
                         _fista_state_of(fs), _fista_scratch_of(sc),
                         spec.dims, spec.rho, spec.nit, spec.alpha,
                         spec.cfg.nonneg)
            self.launched += 1
            return
        pi_launch(list(fs["w16"]), fs["u"], fs["u"], sc["sigma"],
                  self.spec.pi_iters, _EPS, rho=self.spec.rho,
                  masters=list(fs["masters"]), dims=self.spec.dims)
        self.launched += 1

    def count_add(self, count, n):
        self._ran("count_add", self.lib.asr_fe_count_add(
            count.data_ptr(), n, self._stream()))


# --------------------------------------------------------------------------
# the epoch call: plain twin on the CPU, one CUDA graph per epoch on a card
# --------------------------------------------------------------------------

# K7's part of the state, present under FISTA only
_FISTA_KEYS = ("fista_v", "fista_u", "fista_n")


def _state_map(fn, fs: dict) -> dict:
    out = {k: tuple(fn(t) for t in fs[k])
           for k in ("masters", "w16", "mw", "vw")}
    out["small"] = {k: fn(fs["small"][k]) for k in _SMALL_KEYS}
    for k in ("scales", "u", "count") + _FISTA_KEYS:
        if k in fs:
            out[k] = fn(fs[k])
    return out


def _state_leaves(fs: dict) -> list:
    return ([t for k in ("masters", "w16", "mw", "vw") for t in fs[k]]
            + [fs["small"][k] for k in _SMALL_KEYS]
            + [fs["scales"], fs["u"], fs["count"]]
            + [fs[k] for k in _FISTA_KEYS if k in fs])


def _epoch_inputs(spec, xs, ys, ws, seeds):
    n, B = xs.shape[0], spec.batch
    if xs.shape != (n, B, spec.pdims[0]):
        raise ValueError(f"fused epoch: xs must be (n_batches, {B}, "
                         f"{spec.pdims[0]}), got {tuple(xs.shape)}")
    return (xs.float().contiguous(),
            ys.reshape(n, B).to(torch.int32).contiguous(),
            ws.reshape(n, B).float().contiguous(),
            seeds.reshape(n).to(torch.int32).contiguous())


def fused_epoch_plain(spec: FusedStepSpec, fstate: dict, xs, ys, ws, seeds,
                      ops: _PlainOps | None = None):
    """K3's plain twin: -> (fstate', losses (n, 1), accs (n, 1)) for xs
    (n, B, pdims[0]) float32, ys and ws (n, B, 1) (labels, row weights),
    seeds (n,) int32. `fstate` is not modified. `ops` (default
    `_PlainOps(spec)`) lets a check swap one operation, e.g. to plant a
    fault, or run K3's kernels one launch at a time (`_CudaOps`, after
    `preload_kernels`). Every GEMM operand is bf16-rounded, hence exact in
    TF32, so the caller's TF32 setting does not change the result."""
    xs, ys, ws, seeds = _epoch_inputs(spec, xs, ys, ws, seeds)
    fs = _state_map(lambda t: t.clone(), fstate)
    n = xs.shape[0]
    losses = torch.zeros(n, device=xs.device)
    accs = torch.zeros(n, device=xs.device)
    with torch.no_grad():
        _epoch(ops or _PlainOps(spec), spec, fs, _scratch(spec, xs.device),
               xs, ys, ws, seeds, losses, accs)
    fs["scales"] = torch.ones_like(fs["scales"])
    return fs, losses[:, None], accs[:, None]


class _EpochGraph:
    """Static buffers and the CUDA graph of one (spec, n_batches, device);
    `kernel_nodes` is the number of kernels the graph holds."""

    def __init__(self, spec: FusedStepSpec, n_batches: int, device):
        B, pd = spec.batch, spec.pdims
        ops = _CudaOps(spec)  # the plan refuses what the kernels do not take
        self.spec = spec
        with torch.cuda.device(device):
            zeros = lambda t: torch.zeros_like(t, device=device)  # noqa: E731
            template = _state_map(lambda t: t, _template_state(spec))
            self.fs = _state_map(zeros, template)
            self.xs = torch.zeros((n_batches, B, pd[0]), device=device)
            self.ys = torch.zeros((n_batches, B), dtype=torch.int32,
                                  device=device)
            self.ws = torch.zeros((n_batches, B), device=device)
            self.seeds = torch.zeros(n_batches, dtype=torch.int32,
                                     device=device)
            self.losses = torch.zeros(n_batches, device=device)
            self.accs = torch.zeros(n_batches, device=device)
            self.sc = _scratch(spec, device)
            preload_kernels(ops.lib)
            preload()
            if spec.fista:
                fista_preload(spec.dims)
            torch.cuda.synchronize(device)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                _epoch(ops, spec, self.fs, self.sc, self.xs, self.ys,
                       self.ws, self.seeds, self.losses, self.accs)
            self.kernel_nodes = ops.launched
        self.device = device

    def run(self, fstate, xs, ys, ws, seeds):
        xs, ys, ws, seeds = _epoch_inputs(self.spec, xs, ys, ws, seeds)
        for dst, src in zip(_state_leaves(self.fs), _state_leaves(fstate)):
            if dst.shape != src.shape:
                raise ValueError(f"fused epoch: state leaf {tuple(src.shape)}"
                                 f" where {tuple(dst.shape)} was captured")
            dst.copy_(src)
        for dst, src in ((self.xs, xs), (self.ys, ys), (self.ws, ws),
                         (self.seeds, seeds)):
            dst.copy_(src)
        with torch.cuda.device(self.device):
            self.graph.replay()
        build_fused_epoch_call.launches += 1
        fs = _state_map(lambda t: t.clone(), self.fs)
        fs["scales"] = torch.ones_like(fs["scales"])
        return fs, self.losses.clone()[:, None], self.accs.clone()[:, None]


def _template_state(spec: FusedStepSpec) -> dict:
    """A zero fstate on the CPU with the packed shapes and dtypes."""
    pd, m = spec.pdims, spec.n_layers
    masters = tuple(torch.zeros((pd[i], pd[i + 1])) for i in range(m))
    return _with_fista_state(spec, {
        "masters": masters, "w16": tuple(w.to(_BF16) for w in masters),
        "mw": masters, "vw": masters,
        "small": {k: torch.zeros((m, spec.dmax)) for k in _SMALL_KEYS},
        "scales": torch.ones((1, _LANE)), "u": torch.zeros((1, pd[-1])),
        "count": torch.zeros((1,), dtype=torch.int32),
    }, "cpu")


def build_fused_epoch_call(spec: FusedStepSpec, n_batches: int):
    """-> run(fstate, xs, ys, ws, seeds) -> (fstate', losses, accs): xs
    (n_batches, B, pdims[0]) f32 gathered batches, ys (n_batches, B, 1)
    labels, ws (n_batches, B, 1) f32 row weights, seeds (n_batches,) int32
    per-step dropout seeds; losses/accs (n_batches, 1) f32. fstate' is a new
    state; its bf16 copies are a cast of its masters and its `scales` are 1
    (fold deferred scales into the masters first, as build_fused_epoch_fn
    does). On CUDA tensors the first call per device captures the graph
    (buffers, kernel preload, capture: the span `k3.capture`,
    `utils/profiling.py`); `run.graphs` maps each device to its
    `_EpochGraph` (for profiling)."""
    graphs: dict = {}

    def run(fstate, xs, ys, ws, seeds):
        if xs.shape[0] != n_batches:
            raise ValueError(f"fused epoch built for {n_batches} batches, "
                             f"got {xs.shape[0]}")
        if xs.device.type == "cpu":
            return fused_epoch_plain(spec, fstate, xs, ys, ws, seeds)
        if not xs.is_cuda:
            raise ValueError(f"fused epoch: unsupported device {xs.device}")
        g = graphs.get(xs.device)
        if g is None:
            with span("k3.capture"):
                g = graphs[xs.device] = _EpochGraph(spec, n_batches,
                                                    xs.device)
        return g.run(fstate, xs, ys, ws, seeds)

    run.graphs = graphs
    return run


build_fused_epoch_call.launches = 0


def _pad_batches(xs, ys, ws, pad: int):
    """Append `pad` rows of weight 0 to each gathered batch."""
    if not pad:
        return xs, ys, ws
    pad_rows = torch.nn.functional.pad
    return (pad_rows(xs, (0, 0, 0, pad)), pad_rows(ys, (0, pad)),
            pad_rows(ws, (0, pad)))


def build_fused_epoch_fn(spec: FusedStepSpec, shuffle: bool = True,
                         epochs_per_call: int = 1,
                         reshuffle_inner: bool = False,
                         scan_steps: bool = False):
    """-> `epoch(fstate, data_pad, labels, perm_gen, drop_gen, n_true)` ->
    (fstate', mean_loss, mean_acc): the fused counterpart of
    `train/epoch_scan.py::build_epoch_fn` on the packed state. `data_pad` is
    (N_pad, pdims[0]) float32, feature- and row-padded (a multiple of
    spec.batch); the generators live on its device (drop_gen draws the
    per-step int32 dropout seeds; None gives seed 0).

    K3 runs whole 64-row tiles, so each batch is padded to a multiple of 64
    with rows of weight 0, which the BN statistics, the CCE and every
    gradient ignore (the dropout draw of a real row does not change).

    `scan_steps=True` runs the epoch as a chain of K6 steps instead
    (ops/cuda_step.py::build_fused_step: one graph replay per step, any
    number of batches through one captured graph, no host synchronization
    between steps), with the same shuffle, seeds and weighted means. Its
    result carries the last step's deferred `scales` and its own `w16`; the
    grid path folds such scales into the masters before K3 runs."""
    B = spec.batch
    run_spec = dataclasses.replace(spec, batch=_pad_to(B, 64))
    pad = run_spec.batch - B
    calls: dict = {}
    step = None
    if scan_steps:
        from .cuda_step import build_fused_step

        step = build_fused_step(run_spec)

    def one_epoch(fstate, batches, drop_gen):
        xs, ys, ws = _pad_batches(*batches, pad)
        n_batches = xs.shape[0]
        if drop_gen is None:
            seeds = torch.zeros(n_batches, dtype=torch.int32,
                                device=xs.device)
        else:
            seeds = torch.randint(0, 2 ** 31 - 1, (n_batches,),
                                  generator=drop_gen, device=xs.device,
                                  dtype=torch.int32)
        ns = torch.sum(ws, 1)
        total = torch.sum(ns)
        if step is not None:
            fstate, losses, accs = step.chain(fstate, xs, ys, ws, seeds)
            return (fstate, torch.sum(losses * ns) / total,
                    torch.sum(accs * ns) / total)
        run = calls.get(n_batches)
        if run is None:
            run = calls[n_batches] = build_fused_epoch_call(run_spec,
                                                            n_batches)
        sc = fstate["scales"]
        fstate = {**fstate, "scales": torch.ones_like(sc),
                  "masters": tuple(w * sc[0, i]
                                   for i, w in enumerate(fstate["masters"]))}
        fstate, losses, accs = run(fstate, xs, ys[..., None], ws[..., None],
                                   seeds)
        return (fstate, torch.sum(losses[:, 0] * ns) / total,
                torch.sum(accs[:, 0] * ns) / total)

    def epoch(fstate, data, labels, perm_gen, drop_gen, n_true):
        out = (fstate, None, None)
        batches = None
        for _ in range(epochs_per_call):
            if batches is None or reshuffle_inner:
                batches = shuffle_batches(data, labels, B, shuffle, perm_gen,
                                          n_true)
            out = one_epoch(out[0], batches, drop_gen)
        return out

    return epoch


def parity_bars(steps: int, lr: float = 1e-3) -> dict:
    """The bounds two bf16-class epochs of `steps` Adam steps are held to
    (those of the JAX package's epoch_parity_vs_xla). params: lr * max(8,
    2 * steps), since near-zero gradients flip sign between two bf16-class
    programs and each flip moves a weight by about one Adam step; layer-0
    BN running mean: 6e-3 (the parity gate raises it to
    GATE_SPREAD_FACTOR times the order spread where that is larger);
    epoch loss and accuracy: 3e-2."""
    return {"param": lr * max(8.0, 2.0 * steps), "bn_mean": 6e-3,
            "loss": 3e-2, "acc": 3e-2}


# The parity gate's layer-0 BN bar is max(6e-3, GATE_SPREAD_FACTOR * s), s
# the gap between the twin and the twin with its sums reordered after the
# gate's epoch: the smallest round factor that admits every unfaulted
# reading of chip_smoke.py with a margin of 1.5 (epoch_parity_vs_plain lists
# them).
GATE_SPREAD_FACTOR = 3.0
# steps of the gate's epoch that run K3 and its twin in lockstep: the first
# GATE_LOCKSTEP_STEPS, and the last, which holds the padded rows
GATE_LOCKSTEP_STEPS = 8


def order_spread(spec: FusedStepSpec, fstate: dict, xs, ys, ws,
                 seeds) -> float:
    """The spread summation order alone gives on these batches: the largest
    layer-0 BN running-mean gap between the twin and the twin with its fp32
    sums reordered (`ops/k3_lockstep.py::reordered_ops`) after the same
    epoch from `fstate` (`fused_epoch_plain`'s arguments); 0 without BN."""
    from .k3_lockstep import reordered_ops

    if not spec.cfg.batch_norm:
        return 0.0
    mu = [unpack_params(spec, fused_epoch_plain(
        spec, fstate, xs, ys, ws, seeds, ops=ops)[0])[1]["layers"][0]["mean"]
        for ops in (None, reordered_ops(spec))]
    return float(torch.max(torch.abs(mu[0] - mu[1])))


def bn_bar(steps: int, s: float) -> float:
    """The parity gate's layer-0 BN running-mean bar for an epoch of `steps`
    steps whose order spread is `s`."""
    return max(parity_bars(steps)["bn_mean"], GATE_SPREAD_FACTOR * s)


def _wall(dev) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def epoch_parity_vs_plain(mcfg: MLPConfig, batch: int, data, labels,
                          n_true: int, seeds: tuple[int, int] = (7, 3),
                          candidate=None, projection=None) -> dict:
    """The gate the trainer runs, once per process and configuration,
    before it trains with K3; it raises where the gate fails. One dropout-0
    epoch from one init (`seeds[0]`) and one permutation (`seeds[1]`) under
    the projection: `projection` None is simple_norm at rho 0.1 with 4
    power-iteration rounds (every simple_norm or unconstrained fit), and
    ("fista", rho, nit, alpha) is K7 against make_fista_constraint(rho, nit,
    alpha) in the plain epoch; on the caller's rows: `data` (N_pad,
    in_dim) float32 on the device, row padded to a multiple of `batch`, and
    `labels` (N_pad,), of which the first `n_true` are real. Two parts, and
    the gate fails where either does:

    lockstep (the sharp part): K3 and its twin `_PlainOps` run in lockstep
    (`ops/k3_lockstep.py::K3TwinLockstep`) over the first
    GATE_LOCKSTEP_STEPS steps of the epoch and its last (where the padded
    rows are): each operation of a step runs on K3 and on the twin from
    K3's own state, so summation order cannot build up. It fails where a
    computed quantity (one outside `LOCKSTEP_PARAMS`: activations,
    statistics, gradients, the projection's factors, NonNeg's negative
    part) parts by more than one bf16 ulp of its operands' scale. It runs
    where K3 runs, on a CUDA device; on the CPU K3 is its twin and the part
    runs only for a `candidate`.

    drift, over the whole epoch: K3's epoch (the captured graph, as
    `build_fused_epoch_fn` runs it) against the plain bf16 autograd epoch
    on the same batches: params, loss and accuracy at `parity_bars`, and
    the layer-0 BN running mean at max(6e-3, GATE_SPREAD_FACTOR * s), s the
    layer-0 BN-mean gap between the twin and the twin with its fp32 sums
    reordered (`reordered_ops`) after the same epoch: the spread that
    summation order alone gives on these rows. That gap grows with the
    steps and with how clustered the rows are, so a constant bar (the JAX
    package's 6e-3) refuses a right kernel on a long epoch of steady tones,
    and the JAX package's own Pallas epoch there (ROADMAP.md, F9); a bar
    scaled by c * s alone would pass a real fault (the leaky backward ReLU
    mask read 6.3e-3 on the speaker corpus, where K3 and its twin, apart by
    summation order alone, reach 2.45e-3), which the lockstep refuses.

    GATE_SPREAD_FACTOR (3) is set from chip_smoke.py's unfaulted readings on
    an NVIDIA H100 80GB HBM3 (700 W), layer-0 BN gap / s after the epoch:
    voiced bursts and steady tones at 8 / 16 / 32 / 64 steps of 512, two
    draws each, bursts 1.5e-4 / 1.0e-4, 3.6e-4 / 3.7e-4, 1.1e-3 / 3.7e-3,
    3.9e-3 / 3.8e-3 and 1.5e-4 / 2.4e-4, 6.8e-4 / 4.8e-4, 1.0e-3 / 1.5e-3,
    2.9e-3 / 2.1e-3; tones 1.5e-4 / 1.6e-4, 8.5e-4 / 4.3e-4, 9.6e-3 /
    4.9e-3, 7.6e-3 / 7.0e-3 and 3.1e-4 / 2.2e-4, 2.0e-3 / 2.0e-3, 4.8e-3 /
    5.1e-3, 1.4e-2 / 1.7e-2; the speaker corpus at 1-14 steps of 64, three
    draws, at most 2.4e-3 (s 9.4e-4 there); every K3 fit the script runs,
    the studies' included, at most 6.1e-3 / 9.6e-3 (64 steps of steady
    tones). Only a gap over 4e-3 (6e-3 / 1.5) needs the factor; the
    largest need is 1.5 x 9.6e-3 / 4.9e-3 = 2.9. The lockstep there reads
    at most 1.00 ulp (a single bf16 rounding), and it refuses each fault of
    `tools/gate_faults.py` at the operation that holds it.

    Under FISTA (`projection=("fista", 5, 2, 2.1)`) the same bars hold, read
    on the same card on the digit benchmark corpus (h100bench's
    `digit_fista.train`), two draws: params 3.06e-2 / 2.83e-2 against
    0.066, layer-0 BN mean 1.69e-3 / 8.4e-4 against 6e-3, loss 1.6e-4 /
    8.7e-5 and accuracy 6.0e-4 / 6.0e-5 against 3e-2, the lockstep at most
    1.00 ulp (K7 and its twin's projected masters within rounding); faults
    a-f and `FISTA_FAULTS` g (gamma doubled, refused at step 0's
    projection) are refused.

    `candidate(spec)` -> a set of the step's operations runs in K3's place
    in both parts (`tools/gate_faults.py` plants faults); default: K3's
    kernels on a card, the wrapper's twin on the CPU. Returns {"ok", the
    drift readings "max_dw", "max_db", "max_dmu", "dloss", "dacc", the
    bars "tol_param", "tol_bn_mean" (the BN bar used), "s",
    "spread_factor", "loss_fused", "loss_plain"; the lockstep's
    "lockstep_steps" (empty where it did not run), "lockstep_first" (the
    first departure or None) and "lockstep_worst" (the largest reading of
    a computed quantity); "failed" (the parts that failed), "why" (the
    first failure in words) and "seconds" by part}."""
    from .k3_lockstep import LOCKSTEP_PARAMS, k3_twin_lockstep

    dev = data.device
    t = [_wall(dev)]
    cfg0 = dataclasses.replace(mcfg, dropout=(0.0,) * len(mcfg.dropout))
    params, state = init_mlp(cfg0, _generator(dev, seeds[0]), device=dev)
    if projection is None:
        spec = FusedStepSpec(cfg=cfg0, batch=_pad_to(batch, _TILE), rho=0.1,
                             pi_iters=4)
        con = make_simple_norm_constraint(0.1, n_iter=4, pi_backend="plain")
    else:
        kind, rho, nit, alpha = projection
        spec = FusedStepSpec(cfg=cfg0, batch=_pad_to(batch, _TILE), rho=rho,
                             projection=kind, nit=nit, alpha=alpha)
        con = make_fista_constraint(rho, nit=nit, alpha=alpha)
    fs = pack_state(spec, params, state)

    opt = adam_optimizer(1e-3, "float32")
    ep_plain = build_epoch_fn(cfg0.with_bf16(), opt, constraint=con.apply,
                              batch_size=batch, epochs_per_call=1,
                              reshuffle_inner=False)
    px, sx, _, _, loss_x, acc_x = ep_plain(
        params, state, opt.init(params), con.init(params), data, labels,
        _generator(dev, seeds[1]), None, n_true)
    t.append(_wall(dev))

    # the batches build_fused_epoch_fn gathers: the same permutation
    xs, ys, ws = _pad_batches(*shuffle_batches(
        pad_features(spec, data), labels, batch, True,
        _generator(dev, seeds[1]), n_true), spec.batch - batch)
    n = xs.shape[0]
    zeros = torch.zeros(n, dtype=torch.int32, device=dev)
    batches = (xs, ys[..., None], ws[..., None], zeros)
    cand = None if candidate is None else candidate(spec)
    if cand is None:
        fs_c, losses, accs = build_fused_epoch_call(spec, n)(fs, *batches)
    else:
        if isinstance(cand, _CudaOps):
            preload_kernels(cand.lib)
            preload()
            if spec.fista:
                fista_preload(spec.dims)
        fs_c, losses, accs = fused_epoch_plain(spec, fs, *batches, ops=cand)
    ns = ws.sum(1)
    loss_f = float(torch.sum(losses[:, 0] * ns) / ns.sum())
    acc_f = float(torch.sum(accs[:, 0] * ns) / ns.sum())
    pf, sf = unpack_params(spec, fs_c)
    t.append(_wall(dev))

    s = order_spread(spec, fs, *batches)
    t.append(_wall(dev))

    held, first, worst = [], None, None
    if cand is not None or dev.type == "cuda":
        held = sorted(set(range(min(n, GATE_LOCKSTEP_STEPS))) | {n - 1})
        rows, first = k3_twin_lockstep(dev, spec, fs, xs, ys, ws, zeros,
                                       candidate=cand, held=held)
        worst = max((r for r in rows if r["q"] not in LOCKSTEP_PARAMS),
                    key=lambda r: r["ulps"])
    t.append(_wall(dev))

    def maxdiff(key):
        return max(float(torch.max(torch.abs(a[key] - b[key])))
                   for a, b in zip(pf["layers"], px["layers"]))

    dw, db = maxdiff("w"), maxdiff("b")
    # a model without BatchNorm (speaker_unconstrained) has no running mean
    dmu = float(torch.max(torch.abs(
        sf["layers"][0]["mean"] - sx["layers"][0]["mean"]))) \
        if mcfg.batch_norm else 0.0
    dloss, dacc = abs(loss_f - float(loss_x)), abs(acc_f - float(acc_x))
    bars = parity_bars(n)
    bar_mu = bn_bar(n, s)
    over = [f"{what} {got:.3e} over its bar {bar:.3e}" for what, got, bar in (
        ("params |dW|", dw, bars["param"]), ("params |db|", db, bars["param"]),
        ("layer-0 BN running mean", dmu, bar_mu),
        ("epoch loss", dloss, bars["loss"]), ("epoch accuracy", dacc,
                                              bars["acc"]))
        if not got < bar]
    failed, why = [], None
    if first is not None:
        failed.append("lockstep")
        why = (f"lockstep: step {first['step']}, {first['op']}, "
               f"{first['q']} parts from the twin by {first['ulps']:.2f} "
               f"bf16 ulps of its operands' scale {first['scale']:.3e}")
    if over:
        failed.append("drift")
        why = why or (f"drift over {n} steps: " + "; ".join(over)
                      + f" (BN bar: 6e-3 or {GATE_SPREAD_FACTOR:g} x the "
                      f"order spread {s:.3e})")
    return {"ok": not failed, "max_dw": dw, "max_db": db, "max_dmu": dmu,
            "dloss": dloss, "dacc": dacc, "tol_param": bars["param"],
            "tol_bn_mean": bar_mu, "s": s,
            "spread_factor": GATE_SPREAD_FACTOR, "loss_fused": loss_f,
            "loss_plain": float(loss_x), "lockstep_steps": held,
            "lockstep_first": first, "lockstep_worst": worst,
            "failed": failed, "why": why,
            "seconds": dict(zip(("plain", "candidate", "order_spread",
                                 "lockstep"), np.diff(t).tolist()),
                            total=t[-1] - t[0])}
