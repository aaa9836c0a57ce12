"""Device-resident epoch training: the whole split on the device, one call
per epoch.

Counterpart of the JAX package's `train/epoch_scan.py`. The JAX version
compiles the epoch into one XLA program (a lax.scan); here it is a Python loop
of autograd steps over batches gathered on the device, the plain path that
the fused epoch (K3, ops/cuda_train.py) is held against. Semantics match
Trainer.fit: same update rule, NonNeg clamp, constraint projection,
reshuffle flag and metrics. The trailing ragged batch is padded and its
padding rows carry weight 0 in the loss, the metrics and the BN moments.
"""

from __future__ import annotations

import torch

from ..models.mlp import MLPConfig, apply_mlp, data_sum
from .trainer import (_tree_leaves, _tree_map, _value_and_grad, apply_update,
                      cce_from_logits)

__all__ = ["build_epoch_fn", "build_eval_fn", "epoch_program", "eval_program",
           "eval_sums", "masked_value_and_grad", "shuffle_batches"]


def _masked_forward_loss(model_cfg, params, state, x, y, w, gen, mesh=None,
                         rows=None, kinds=None):
    """Row-weighted CCE and accuracy; BN moments leave out weight-0 rows.
    Under a `mesh` (apply_mlp's `mesh`, `rows`, `kinds`) `x` holds this
    rank's rows: the loss is their CE sum over the whole batch's weight, so
    the ranks' losses sum to the whole batch's, and the accuracy is the
    whole batch's. `w=None` (the batch whole and unpadded here) is the
    plain mean, as `Trainer`'s step takes it."""
    logits, new_state = apply_mlp(model_cfg, params, state, x, train=True,
                                  generator=gen, weights=w, mesh=mesh,
                                  rows=rows, kinds=kinds)
    hits = (torch.argmax(logits, -1) == y).float()
    if w is None:
        return cce_from_logits(logits, y), (new_state, torch.mean(hits))
    denom = data_sum(mesh, torch.sum(w), grad=False) + 1e-9
    logp = torch.log_softmax(logits, -1)
    per = -torch.gather(logp, -1, y[:, None].long())[:, 0]
    loss = torch.sum(per * w) / denom
    acc = data_sum(mesh, torch.sum(hits * w), grad=False) / denom
    return loss, (new_state, acc)


def masked_value_and_grad(model_cfg, params, state, x, y, w, gen, mesh=None,
                          rows=None, kinds=None):
    """-> (loss, (new_state, acc)), grads of `_masked_forward_loss`. Under a
    mesh, with `w` (the rows of a batch split over 'data'), the loss and the
    gradients are summed over 'data' in one all-reduce: every rank gets the
    whole batch's loss and its gradient with respect to this rank's
    parameters."""
    (loss, aux), grads = _value_and_grad(
        lambda p: _masked_forward_loss(model_cfg, p, state, x, y, w, gen,
                                       mesh, rows, kinds), params)
    if mesh is None or w is None:
        return (loss, aux), grads
    from ..parallel.mesh import DATA_AXIS, reduce_sum

    if mesh.group(DATA_AXIS) is None:
        return (loss, aux), grads
    leaves = _tree_leaves(grads)
    flat = reduce_sum(mesh, torch.cat([loss.reshape(1)]
                                      + [g.reshape(-1) for g in leaves]))
    it = iter(torch.split(flat[1:], [g.numel() for g in leaves]))
    return (flat[0], aux), _tree_map(lambda g: next(it).view_as(g), grads)


def shuffle_batches(data, labels, batch_size, shuffle, perm_gen, n_true):
    """Gather the padded split into (n_batches, batch_size, ...) -> (xs, ys,
    ws): only the n_true real rows are permuted (a torch.Generator on the
    data's device draws the order), the padded tail stays last, and ws is 1
    on real rows and 0 on padding."""
    n_pad = data.shape[0]
    n_batches = n_pad // batch_size
    dev = data.device
    if shuffle:
        perm = torch.randperm(n_true, generator=perm_gen, device=dev)
        if n_pad > n_true:
            perm = torch.cat([perm, torch.arange(n_true, n_pad, device=dev)])
    else:
        perm = torch.arange(n_pad, device=dev)
    xs = data[perm].reshape(n_batches, batch_size, -1)
    ys = labels[perm].reshape(n_batches, batch_size)
    ws = (perm.reshape(n_batches, batch_size) < n_true).float()
    return xs, ys, ws


def epoch_program(model_cfg: MLPConfig, optimizer, constraint=None,
                  batch_size: int = 256, shuffle: bool = True,
                  epochs_per_call: int = 1, reshuffle_inner: bool = True,
                  mesh=None):
    """-> `epoch(params, state, opt_state, cstate, data, labels, perm_gen,
    drop_gen, n_true)` -> (params, state, opt_state, cstate, mean_loss,
    mean_acc).

    `data`/`labels` are the whole split on the device, padded to a multiple
    of batch_size; rows from n_true on are padding. `perm_gen` draws the
    shuffle, `drop_gen` the dropout masks (None: no dropout); both are
    torch.Generators on the data's device. `epochs_per_call` > 1 runs E
    epochs per call and reports the last one's loss/acc; the permutation is
    drawn once per call unless `reshuffle_inner`, while dropout always draws
    afresh.

    With a `mesh` (a 'data' axis of ranks; parallel/mesh.py) every rank
    holds the whole split and draws the same permutation, and trains on its
    contiguous rows of each batch (`batch_size` must divide over the axis):
    the BN moments, the loss and the gradients span the whole batch
    (parallel/data_parallel.py), the dropout masks are the single-device
    ones."""
    lo, hi, rows = 0, batch_size, None
    if mesh is not None:
        from ..parallel.mesh import axis_rows

        lo, hi = axis_rows(mesh, batch_size)
        rows = (lo, batch_size)

    def run_steps(params, state, opt_state, cstate, xs, ys, ws, drop_gen):
        losses, accs = [], []
        for i in range(xs.shape[0]):
            (loss, (state, acc)), grads = masked_value_and_grad(
                model_cfg, params, state, xs[i][lo:hi], ys[i][lo:hi],
                ws[i][lo:hi], drop_gen, mesh, rows)
            params, opt_state, cstate = apply_update(
                optimizer, model_cfg, constraint, grads, params, opt_state,
                cstate)
            losses.append(loss)
            accs.append(acc)
        ns = torch.sum(ws, 1)
        total = torch.sum(ns)
        mean_loss = torch.sum(torch.stack(losses) * ns) / total
        mean_acc = torch.sum(torch.stack(accs) * ns) / total
        return params, state, opt_state, cstate, mean_loss, mean_acc

    def epoch(params, state, opt_state, cstate, data, labels, perm_gen,
              drop_gen, n_true):
        out = (params, state, opt_state, cstate, None, None)
        batches = None
        for _ in range(epochs_per_call):
            if batches is None or reshuffle_inner:
                batches = shuffle_batches(data, labels, batch_size, shuffle,
                                          perm_gen, n_true)
            out = run_steps(*out[:4], *batches, drop_gen)
        return out

    return epoch


def build_epoch_fn(model_cfg: MLPConfig, optimizer, constraint=None,
                   batch_size: int = 256, shuffle: bool = True,
                   epochs_per_call: int = 1, reshuffle_inner: bool = True,
                   mesh=None):
    """-> `epoch_program` (same signature). PyTorch runs it eagerly."""
    return epoch_program(model_cfg, optimizer, constraint,
                         batch_size=batch_size, shuffle=shuffle,
                         epochs_per_call=epochs_per_call,
                         reshuffle_inner=reshuffle_inner, mesh=mesh)


def eval_sums(model_cfg, params, state, x, y, w, mesh=None, kinds=None):
    """Eval-mode forward of the rows `x` (apply_mlp's `mesh`, `kinds`) ->
    (sum of CE * w, sum of hits * w, predictions), over these rows only."""
    logits, _ = apply_mlp(model_cfg, params, state, x, train=False,
                          mesh=mesh, kinds=kinds)
    logp = torch.log_softmax(logits, -1)
    per = -torch.gather(logp, -1, y[:, None].long())[:, 0]
    pred = torch.argmax(logits, -1)
    return torch.sum(per * w), torch.sum((pred == y).float() * w), pred


def eval_program(model_cfg: MLPConfig, batch_size: int = 1024, mesh=None):
    """-> `evaluate(params, state, data, labels, n_true)` -> (loss, acc) over
    a padded device-resident split; rows from n_true on are left out. With
    a `mesh`, each rank scores its rows of each batch (`batch_size` must
    divide over 'data') and the sums are added over the axis."""
    if mesh is not None:
        from ..parallel.mesh import axis_rows, reduce_sum

        lo, hi = axis_rows(mesh, batch_size)
    else:
        lo, hi = 0, batch_size

    @torch.no_grad()
    def evaluate(params, state, data, labels, n_true):
        n_pad = data.shape[0]
        loss_sum = torch.zeros((), device=data.device)
        hit_sum = torch.zeros((), device=data.device)
        for i in range(0, n_pad, batch_size):
            x, y = data[i + lo: i + hi], labels[i + lo: i + hi]
            w = (torch.arange(i + lo, i + lo + x.shape[0], device=data.device)
                 < n_true).float()
            loss, hits, _ = eval_sums(model_cfg, params, state, x, y, w)
            loss_sum = loss_sum + loss
            hit_sum = hit_sum + hits
        if mesh is not None:
            loss_sum, hit_sum = reduce_sum(
                mesh, torch.stack([loss_sum, hit_sum]))
        return loss_sum / n_true, hit_sum / n_true

    return evaluate


def build_eval_fn(model_cfg: MLPConfig, batch_size: int = 1024, mesh=None):
    """-> `eval_program` (same signature)."""
    return eval_program(model_cfg, batch_size=batch_size, mesh=mesh)
