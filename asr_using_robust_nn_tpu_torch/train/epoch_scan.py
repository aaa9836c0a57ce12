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

from ..models.mlp import MLPConfig, apply_mlp
from .trainer import _value_and_grad, apply_update

__all__ = ["build_epoch_fn", "build_eval_fn", "epoch_program", "eval_program",
           "shuffle_batches"]


def _masked_forward_loss(model_cfg, params, state, x, y, w, gen):
    """Row-weighted CCE and accuracy; BN moments leave out weight-0 rows."""
    logits, new_state = apply_mlp(model_cfg, params, state, x, train=True,
                                  generator=gen, weights=w)
    denom = torch.sum(w) + 1e-9
    logp = torch.log_softmax(logits, -1)
    per = -torch.gather(logp, -1, y[:, None].long())[:, 0]
    loss = torch.sum(per * w) / denom
    acc = torch.sum((torch.argmax(logits, -1) == y).float() * w) / denom
    return loss, (new_state, acc)


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
                  epochs_per_call: int = 1, reshuffle_inner: bool = True):
    """-> `epoch(params, state, opt_state, cstate, data, labels, perm_gen,
    drop_gen, n_true)` -> (params, state, opt_state, cstate, mean_loss,
    mean_acc).

    `data`/`labels` are the whole split on the device, padded to a multiple
    of batch_size; rows from n_true on are padding. `perm_gen` draws the
    shuffle, `drop_gen` the dropout masks (None: no dropout); both are
    torch.Generators on the data's device. `epochs_per_call` > 1 runs E
    epochs per call and reports the last one's loss/acc; the permutation is
    drawn once per call unless `reshuffle_inner`, while dropout always draws
    afresh."""

    def run_steps(params, state, opt_state, cstate, xs, ys, ws, drop_gen):
        losses, accs = [], []
        for i in range(xs.shape[0]):
            (loss, (state, acc)), grads = _value_and_grad(
                lambda p, s, x, y, w: _masked_forward_loss(
                    model_cfg, p, s, x, y, w, drop_gen),
                params, state, xs[i], ys[i], ws[i])
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
                   epochs_per_call: int = 1, reshuffle_inner: bool = True):
    """-> `epoch_program` (same signature). PyTorch runs it eagerly; meshes
    wait for the parallel slice."""
    return epoch_program(model_cfg, optimizer, constraint,
                         batch_size=batch_size, shuffle=shuffle,
                         epochs_per_call=epochs_per_call,
                         reshuffle_inner=reshuffle_inner)


def eval_program(model_cfg: MLPConfig, batch_size: int = 1024):
    """-> `evaluate(params, state, data, labels, n_true)` -> (loss, acc) over
    a padded device-resident split; rows from n_true on are left out."""

    @torch.no_grad()
    def evaluate(params, state, data, labels, n_true):
        n_pad = data.shape[0]
        loss_sum = torch.zeros((), device=data.device)
        hit_sum = torch.zeros((), device=data.device)
        for i in range(0, n_pad, batch_size):
            x, y = data[i: i + batch_size], labels[i: i + batch_size]
            w = (torch.arange(i, i + x.shape[0], device=data.device)
                 < n_true).float()
            logits, _ = apply_mlp(model_cfg, params, state, x, train=False)
            logp = torch.log_softmax(logits, -1)
            per = -torch.gather(logp, -1, y[:, None].long())[:, 0]
            loss_sum = loss_sum + torch.sum(per * w)
            hit_sum = hit_sum + torch.sum(
                (torch.argmax(logits, -1) == y).float() * w)
        return loss_sum / n_true, hit_sum / n_true

    return evaluate


def build_eval_fn(model_cfg: MLPConfig, batch_size: int = 1024):
    """-> `eval_program` (same signature)."""
    return eval_program(model_cfg, batch_size=batch_size)
