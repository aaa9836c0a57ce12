"""Meshes of ranks over torch.distributed, and the collectives the trainers
use.

Counterpart of the JAX package's `parallel/mesh.py`. There a mesh is a grid
of devices in one program and XLA inserts the collectives; here each process
is one rank on one device, a `Mesh` is a grid of ranks with named axes and
one process group per row and column of the grid, and the trainers call the
collectives themselves. A mesh built without a process group has one rank
and runs no collective, as `data_mesh()` on one chip does.

The backend follows the device: NCCL for a CUDA device, gloo for the CPU;
gloo is taken on a CUDA device only when the caller names it (`backend=`).
NCCL needs one card a rank: it refuses two ranks on one GPU. gloo reduces
CUDA tensors through host copies and has no CUDA `all_gather`, so every
gather here is an `all_reduce` of a zero-filled buffer (`gather_rows`).
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "Mesh", "maybe_init_distributed", "data_mesh",
    "replicated", "sharded_batch", "pad_to_multiple", "all_reduce_sum",
    "copy_to_axis", "reduce_from_axis", "reduce_sum", "gather_rows",
    "axis_rows",
]

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """A grid of ranks with named axes: the counterpart of
    `jax.sharding.Mesh(devices, names)`.

    `ranks` is the grid of global ranks (C order, the last axis fastest);
    `shape[name]` its size along an axis, `coords[name]` this rank's place
    on it, `group(name)` the process group of the ranks that share every
    other coordinate with this one (None where the axis has size 1 or no
    process group is up; the collectives then do nothing)."""

    def __init__(self, ranks, axis_names):
        ranks = np.asarray(ranks, dtype=np.int64)
        axis_names = tuple(axis_names)
        if ranks.ndim != len(axis_names):
            raise ValueError(f"a {ranks.ndim}-D rank grid needs "
                             f"{ranks.ndim} axis names, got {axis_names}")
        up = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if up else 1
        if sorted(ranks.ravel().tolist()) != list(range(world)):
            raise ValueError(f"the mesh must hold each of the {world} ranks "
                             f"of the world once, got {ranks.tolist()}")
        self.ranks = ranks
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, ranks.shape))
        self.rank = dist.get_rank() if up else 0
        where = np.argwhere(ranks == self.rank)[0]
        self.coords = {a: int(c) for a, c in zip(axis_names, where)}
        self._groups = {}
        for ax, name in enumerate(axis_names):
            self._groups[name] = None
            if not up or ranks.shape[ax] == 1:
                continue
            # every rank creates every group, in one order (new_group is
            # collective over the world) and keeps the one it belongs to
            lines = np.moveaxis(ranks, ax, -1).reshape(-1, ranks.shape[ax])
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if self.rank in line:
                    self._groups[name] = g

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def group(self, axis: str):
        return self._groups[axis]

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, rank={self.rank}, "
                f"coords={self.coords})")


def maybe_init_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           backend: str | None = None,
                           device=None) -> bool:
    """Join a process group when the environment or the caller names one:
    `coordinator` "host:port", or torch's launcher environment
    (MASTER_ADDR / MASTER_PORT, WORLD_SIZE, RANK, as `torchrun` sets them).
    Returns False and starts nothing when neither is there, or when the
    group is already up.

    `backend=None` is NCCL when the rank computes on a CUDA device (`device`,
    None meaning the port's default, the rank's card) and gloo on the CPU;
    an explicit `backend` is taken as given. A backend that fails to start
    raises: there is no switch to another."""
    if dist.is_initialized():
        return False
    env = os.environ
    if coordinator is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if coordinator is None:
        return False
    world = (num_processes if num_processes is not None
             else int(env.get("WORLD_SIZE", "1")))
    rank = process_id if process_id is not None else int(env.get("RANK", "0"))
    if backend is None:
        on_cpu = device is not None and torch.device(device).type == "cpu"
        backend = "gloo" if on_cpu else "nccl"
    kw = {}
    if backend == "nccl":
        # the rank's card, so NCCL binds its communicator there
        from ..utils.device import resolve_device

        kw["device_id"] = resolve_device(
            device, local_rank=int(env.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(kw["device_id"])
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=600), **kw)
    return True


def data_mesh(n_ranks: int | None = None) -> Mesh:
    """1-D mesh ('data',) over the world's ranks in order; one rank, and no
    collective, without a process group. `n_ranks` must be the world size
    when given (a mesh over part of the world is not supported)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_ranks is not None and n_ranks != world:
        raise ValueError(f"data_mesh({n_ranks}): the mesh spans the whole "
                         f"world of {world} rank(s)")
    return Mesh(np.arange(world), (DATA_AXIS,))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def replicated(mesh: Mesh, tree):
    """Every tensor leaf of `tree` overwritten, in place, by rank
    `mesh.ranks` [0, ...]'s copy (a broadcast over the whole mesh); returns
    the tree. Trainers call it once on their initial state so that every
    rank starts from the same bits."""
    if mesh.size > 1:
        for t in _leaves(tree):
            dist.broadcast(t, src=int(mesh.ranks.flat[0]))
    return tree


def axis_rows(mesh: Mesh, n: int, axis: str = DATA_AXIS) -> tuple[int, int]:
    """[lo, hi) of this rank's contiguous share of `n` rows split over
    `axis`; `n` must divide."""
    k = mesh.shape[axis]
    if n % k:
        raise ValueError(f"{n} rows do not divide over the {k} ranks of "
                         f"axis {axis!r} (pad with pad_to_multiple)")
    per = n // k
    lo = mesh.coords[axis] * per
    return lo, lo + per


def sharded_batch(mesh: Mesh, x, axis: str = DATA_AXIS):
    """This rank's contiguous rows of a batch already padded to a multiple
    of the axis size (`pad_to_multiple`)."""
    lo, hi = axis_rows(mesh, x.shape[0], axis)
    return x[lo:hi]


def pad_to_multiple(x: np.ndarray, m: int, axis: int = 0):
    """Zero-pad `x` along `axis` to a multiple of `m`; returns (padded,
    true_n). Callers mask the padding rows."""
    n = x.shape[axis]
    rem = (-n) % m
    if rem == 0:
        return x, n
    pad_width = [(0, 0)] * x.ndim
    pad_width[axis] = (0, rem)
    return np.pad(x, pad_width), n


def reduce_sum(mesh: Mesh, t: torch.Tensor, axis: str = DATA_AXIS):
    """A sum over `axis` of a tensor that carries no gradient (a copy)."""
    t = t.detach().clone()
    g = mesh.group(axis)
    if g is not None:
        dist.all_reduce(t, group=g)
    return t


class _AllReduceSum(torch.autograd.Function):
    """y = sum over the group of x; dL/dx = sum over the group of dL/dy,
    the gradient of the whole sum of losses with respect to this rank's
    summand."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _CopyToAxis(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce backward (the input of a
    column-parallel layer, whose shards each send back a partial gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromAxis(torch.autograd.Function):
    """Megatron's g: all-reduce forward (the partial products of a
    row-parallel layer), identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_sum(mesh: Mesh, x: torch.Tensor, axis: str = DATA_AXIS):
    """Differentiable sum of `x` over `axis` (identity for one rank)."""
    g = mesh.group(axis)
    return x if g is None else _AllReduceSum.apply(x, g)


def copy_to_axis(mesh: Mesh, x: torch.Tensor, axis: str):
    g = mesh.group(axis)
    return x if g is None else _CopyToAxis.apply(x, g)


def reduce_from_axis(mesh: Mesh, x: torch.Tensor, axis: str):
    g = mesh.group(axis)
    return x if g is None else _ReduceFromAxis.apply(x, g)


def gather_rows(mesh: Mesh, t: torch.Tensor, axis: str = DATA_AXIS,
                dim: int = 0) -> torch.Tensor:
    """Concatenate every rank's `t` along `dim`, in axis order, on every
    rank of the axis: an all_reduce of a zero-filled buffer (gloo has no
    CUDA all_gather; x + 0 is exact, so the result is the ranks' bits).
    Every rank's `t` must have the same shape."""
    g = mesh.group(axis)
    if g is None:
        return t
    k, c = mesh.shape[axis], mesh.coords[axis]
    n = t.shape[dim]
    shape = list(t.shape)
    shape[dim] = n * k
    buf = torch.zeros(shape, dtype=t.dtype, device=t.device)
    buf.narrow(dim, c * n, n).copy_(t)
    dist.all_reduce(buf, group=g)
    return buf

