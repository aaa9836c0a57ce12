"""Data-parallel training over a mesh of ranks.

Counterpart of the JAX package's `parallel/data_parallel.py`. There GSPMD
splits one program over the devices; here every rank runs the step on its
rows of the batch and the collectives are written out:

  - every rank gets the same host batch, pads it with zero rows to a
    multiple of the 'data' axis, gives the padding weight 0 and keeps its
    contiguous rows;
  - the loss is sum(CE * w) over the rank's rows / sum(w) over the whole
    batch, so the ranks' losses sum to the single-device loss and their
    gradients, summed over 'data', to its gradient;
  - BatchNorm takes the weighted moments of the whole batch: the sums
    (sum w*h, sum w) and then sum w*(h - mean)^2 go through a
    *differentiable* all-reduce, whose backward all-reduces the gradient, so
    BN's cross-rank gradient terms are kept (a no-grad reduction of the
    moments would still train, but miss the single-device step). The
    forward is `models/mlp.py::apply_mlp` under `mesh=`, the loss and the
    gradient sum `train/epoch_scan.py::masked_value_and_grad`;
  - dropout draws its mask on the global (B, width) shape from the step's
    generator, as `models/mlp.py::apply_mlp` draws it on one device, and
    each rank keeps its rows: the same masks as the single-device step;
  - the constraint projection runs on the replicated parameters in every
    rank (on the card, K2 once a rank a step).

The tensor-parallel trainer (parallel/tensor_parallel.py) takes the same
forward, loss and evaluation with its layers' splits (`kinds`).
"""

from __future__ import annotations

import torch

from ..models.mlp import MLPConfig
from ..train.epoch_scan import eval_sums, masked_value_and_grad
from ..train.trainer import Trainer, apply_update
from .mesh import DATA_AXIS, Mesh, axis_rows, reduce_sum, replicated

__all__ = ["DataParallelTrainer", "psum_train_step", "rank_rows",
           "sharded_eval"]


def rank_rows(mesh: Mesh, x, y):
    """This rank's rows of a whole batch (every rank holds the same one):
    -> (x_rows, y_rows, w_rows, (lo, n)). The batch is zero-padded to a
    multiple of 'data'; padding rows have weight 0. With one rank on 'data'
    the rows are the batch and w_rows is None."""
    n = x.shape[0]
    k = mesh.shape[DATA_AXIS]
    if k == 1:
        return x, y, None, (0, n)
    lo, hi = axis_rows(mesh, -(-n // k) * k)
    take = max(0, min(hi, n) - lo)
    xs = x.new_zeros((hi - lo,) + tuple(x.shape[1:]))
    ys = y.new_zeros((hi - lo,))
    ws = torch.zeros(hi - lo, device=x.device)
    xs[:take], ys[:take], ws[:take] = x[lo: lo + take], y[lo: lo + take], 1.0
    return xs, ys, ws, (lo, n)


def sharded_eval(cfg, mesh, params, state, x, y, kinds=None, split=True):
    """-> (loss, acc, pred) of a whole batch. With `split` each rank scores
    its rows and the sums and the predictions (through an all-reduce of a
    zero-filled buffer) are combined over 'data'; without, every rank
    scores the whole batch."""
    n = x.shape[0]
    xs, ys, ws, lo = x, y, None, 0
    if split:
        xs, ys, ws, (lo, _) = rank_rows(mesh, x, y)
    with torch.no_grad():
        loss, hits, pred = eval_sums(
            cfg, params, state, xs, ys,
            torch.ones(xs.shape[0], device=x.device) if ws is None else ws,
            mesh, kinds)
        sums = torch.stack([loss, hits])
        if ws is not None:
            sums = reduce_sum(mesh, sums)
            k = mesh.shape[DATA_AXIS]
            full = torch.zeros(-(-n // k) * k, dtype=pred.dtype,
                               device=pred.device)
            full[lo: lo + pred.shape[0]] = pred
            pred = reduce_sum(mesh, full)[:n]
    return sums[0] / n, sums[1] / n, pred


class DataParallelTrainer(Trainer):
    """Trainer whose train/eval steps run on this rank's rows of each batch
    over `mesh` ('data' axis); parameters and optimizer state are
    replicated (every rank applies the same summed gradient). Checkpoints
    and metrics are written by rank 0 alone."""

    def __init__(self, model_cfg: MLPConfig, mesh: Mesh, train_cfg=None,
                 **kw):
        self.mesh = mesh
        super().__init__(model_cfg, train_cfg, **kw)

    def _build_steps(self):
        cfg, opt, mesh = self.model_cfg, self.optimizer, self.mesh

        def train_step(params, state, opt_state, cstate, x, y, gen):
            xs, ys, ws, rows = rank_rows(mesh, x, y)
            (loss, (state, acc)), grads = masked_value_and_grad(
                cfg, params, state, xs, ys, ws, gen, mesh, rows)
            params, opt_state, cstate = apply_update(
                opt, cfg, self.constraint, grads, params, opt_state, cstate)
            return params, state, opt_state, cstate, loss, acc

        def eval_step(params, state, x, y):
            return sharded_eval(cfg, mesh, params, state, x, y)

        self.train_step = train_step
        self.eval_step = eval_step

    def _init_train_state(self, gen):
        return replicated(self.mesh, super()._init_train_state(gen))

    def _adopt_train_state(self, params, state, opt_state=None):
        return replicated(self.mesh, super()._adopt_train_state(
            params, state, opt_state))

    @property
    def writes_files(self) -> bool:
        return self.mesh.rank == 0


def psum_train_step(model_cfg: MLPConfig, optimizer, mesh: Mesh):
    """The explicit-collective step: each rank takes the loss sum(CE) over
    its rows / the global row count, the gradients are summed over 'data',
    the loss summed and the accuracy averaged; no constraint. It refuses BN
    models, as the JAX package's does (their batch moments would be per
    rank): use DataParallelTrainer there.

    -> `step(params, state, opt_state, x, y, generator)` -> (params, state,
    opt_state, loss, acc) on the whole batch (every rank the same; its size
    must divide over 'data'); dropout draws the single-device masks."""
    if model_cfg.batch_norm:
        raise ValueError(
            "psum_train_step is the explicit-collective path and supports "
            "batch_norm=False models; use DataParallelTrainer for BN models "
            "(its BN moments span the global batch)")

    def step(params, state, opt_state, x, y, generator):
        n = x.shape[0]
        lo, hi = axis_rows(mesh, n)
        xs, ys = x[lo:hi], y[lo:hi]
        ws = torch.ones(hi - lo, device=x.device) if hi - lo < n else None
        (loss, (new_state, acc)), grads = masked_value_and_grad(
            model_cfg, params, state, xs, ys, ws, generator, mesh, (lo, n))
        params, opt_state, _ = apply_update(optimizer, model_cfg, None, grads,
                                            params, opt_state, None)
        return params, new_state, opt_state, loss, acc

    return step
