"""Multi-run training: R independent trainings on one device-resident split.

Counterpart of the JAX package's `train/multi_run.py`. The thesis protocol
is many runs (seed studies, constraint-strength sweeps); here R sets of
(params, optimizer state, constraint state, generators) train on the same
split, stacked on a leading runs axis. The JAX version vmaps the plain epoch
over that axis and scans the fused epoch over it. The port does the same
with an explicit runs axis: the plain epoch computes all R runs at once
(every Dense as one `torch.bmm` over stacked `(R, d_in, d_out)` kernels, BN
moments, the loss and Adam per run, Adam's `count` of shape `(R,)`), and
only the constraint's projection loops over the runs (K2 is a custom op
with no batching rule: one launch per run a step). The fused backend loops
over the runs, each a replay of K3's CUDA graph with that run's state.

Two sweep axes compose, in any combination:

- seeds: per-run inits, shuffles and dropout draws (`init_multi_run_state`),
  each derived as `Trainer.fit` derives them for `TrainConfig(seed=s)`:
  init from `_generator(device, s, 0)`, the shuffle of an epoch from
  `_generator(device, s, 1, epoch or 0)`, its dropout from
  `_generator(device, s, 2, epoch)`. Each run draws its shuffle and its
  dropout masks from its own generator in the order a solo fit draws them,
  so on the CPU with one torch thread run r equals the solo run of seed r
  bit for bit (a `torch.bmm` slice is then the `torch.mm` of the solo
  program; with several threads, or on the card, the GEMMs may sum in
  another order).
- constraint strength rho: `constraint_factory` (a `constraints/engine.py`
  factory) plus one rho per run.

Per-run early stopping and best-snapshot retention stay exact by freezing:
once a run's patience is exhausted its state is carried over bit for bit
(the `active` mask), so its trajectory, best snapshot and validation metrics
are those of a run that stopped. A frozen run is not computed.

With a `mesh` (parallel/mesh.py), the runs axis splits over the ranks of
its first axis: rank k of W trains runs [k R/W, (k+1) R/W) with the batched
plain epoch, each run with its own seed-derived generators, so the split
changes no draw, and the results are gathered so that every rank returns
all R runs in order. The ranks stop together, when no run of any rank is
active. The runs share nothing, so training runs no collective.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.mlp import MLPConfig, init_mlp
from ..utils.device import resolve_device
from .epoch_scan import eval_program, shuffle_batches
from .trainer import (_generator, _nonneg_clamp, _tree_leaves, _tree_map,
                      adam_optimizer)

__all__ = [
    "init_multi_run_state",
    "build_multi_run_epoch_fn",
    "build_multi_run_eval_fn",
    "apply_mlp_runs",
    "init_multi_run_fused_state",
    "build_multi_run_fused_epoch_fn",
    "fold_runs",
    "fit_multi_run",
]


def _stack(trees):
    """A list of equal trees -> one tree with a leading runs axis."""
    return _tree_map(lambda *xs: torch.stack(xs), *trees)


def _run(tree, r):
    """Run r's tree (views) out of a stacked tree."""
    return _tree_map(lambda t: t[r], tree)


def _run_keys(seeds):
    """Per-run key words of the shuffle and the dropout generators."""
    seeds = [int(s) for s in np.asarray(seeds, np.uint32)]
    return seeds, [(s, 1) for s in seeds], [(s, 2) for s in seeds]


def fold_runs(keys, word: int, device) -> list:
    """One torch.Generator per run on `device`, seeded from the run's key
    words and `word` (the epoch): the port's stand-in for vmapped
    `jax.random.fold_in`."""
    return [_generator(device, *k, word) for k in keys]


def init_multi_run_fused_state(spec, seeds, device=None):
    """Packed fused states for R runs, stacked on a leading runs axis ->
    (fstates, perm_keys, drop_keys). Run r's init is `Trainer.fit`'s for
    seed seeds[r]; the keys go to `fold_runs`."""
    from ..ops.cuda_train import pack_state

    dev = resolve_device(device)
    seeds, kps, kds = _run_keys(seeds)
    packed = [pack_state(spec, *init_mlp(spec.cfg, _generator(dev, s, 0),
                                         device=dev)) for s in seeds]
    return _stack(packed), kps, kds


def build_multi_run_fused_epoch_fn(spec, *, shuffle: bool = True,
                                   epochs_per_call: int = 1,
                                   reshuffle_inner: bool = False):
    """R independent trainings through the fused epoch (K3): a loop over the
    runs axis of stacked packed states, each run one call of
    `build_fused_epoch_fn`'s epoch (on a card: one replay of the one captured
    CUDA graph per epoch) with that run's state.

    -> `fn(fstates, data_pad, labels, perm_gens, drop_gens, active, n_true)`
    -> (fstates', mean_loss[R], mean_acc[R]). `data_pad` is the shared
    split, feature-padded (`pad_features`) and row-padded to a multiple of
    spec.batch; `perm_gens`/`drop_gens` are per-run generator lists
    (`fold_runs`); `active` is an optional bool [R] mask: an inactive run is
    not trained, its state is carried over bit for bit and its loss and
    accuracy read NaN. `fstates` is not modified."""
    from ..ops.cuda_train import build_fused_epoch_fn

    ep = build_fused_epoch_fn(spec, shuffle=shuffle,
                              epochs_per_call=epochs_per_call,
                              reshuffle_inner=reshuffle_inner)

    def fn(fstates, data_pad, labels, perm_gens, drop_gens, active, n_true):
        n_runs = fstates["count"].shape[0]
        out = _tree_map(lambda t: t.clone(), fstates)
        nan = torch.full((), float("nan"), device=data_pad.device)
        losses, accs = [nan] * n_runs, [nan] * n_runs
        for r in range(n_runs):
            if active is not None and not bool(active[r]):
                continue
            fs2, losses[r], accs[r] = ep(
                _run(fstates, r), data_pad, labels, perm_gens[r],
                drop_gens[r], n_true)
            _tree_map(lambda dst, src: dst[r].copy_(src), out, fs2)
        return out, torch.stack(losses), torch.stack(accs)

    return fn


def init_multi_run_state(model_cfg: MLPConfig, optimizer, seeds,
                         constraint_init=None, mesh=None, device=None):
    """-> (params, state, opt_state, cstate, perm_keys, drop_keys): the four
    trees stacked on a leading runs axis of len(seeds) (`cstate` is () with
    no `constraint_init`), the keys per-run words for `fold_runs`.

    Run r sees the init, shuffles and dropout draws of a solo
    `Trainer.fit` with `TrainConfig(seed=seeds[r])`. `constraint_init` is a
    `Constraint.init` (params -> cstate); every engine constraint's init
    depends only on the kernels' shapes. With a `mesh`, the result holds
    this rank's share of the runs (`_run_share`)."""
    dev = resolve_device(device)
    if mesh is not None:
        lo, hi = _run_share(mesh, len(seeds))
        seeds = list(seeds)[lo:hi]
    seeds, kps, kds = _run_keys(seeds)
    runs = []
    for s in seeds:
        params, state = init_mlp(model_cfg, _generator(dev, s, 0), device=dev)
        cstate = () if constraint_init is None else constraint_init(params)
        runs.append((params, state, optimizer.init(params), cstate))
    params, state, opt_state, cstate = _stack(runs)
    return params, state, opt_state, cstate, kps, kds


def _rows(v, t):
    """A per-run (R,) vector shaped to broadcast against the stacked t."""
    return v.reshape((-1,) + (1,) * (t.dim() - 1))


def apply_mlp_runs(cfg: MLPConfig, params: dict, state: dict,
                   x: torch.Tensor, train: bool = False, drop_gens=None,
                   weights: torch.Tensor | None = None):
    """`models/mlp.py::apply_mlp` over a leading runs axis -> (logits
    (R, B, n_classes), new_state). `params`/`state` are stacked trees,
    `x` is (R, B, d) or a shared (B, d), `weights` (R, B) row weights for
    the BN batch moments. Every Dense is one `torch.bmm` over the runs;
    `drop_gens` (one generator per run) draw each run's dropout masks in
    the order a solo forward draws them."""
    if x.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False  # fp32 GEMMs, never TF32
    n_runs = params["layers"][0]["w"].shape[0]
    h = x if x.dim() == 3 else x.expand(n_runs, *x.shape)
    n_hidden = len(cfg.hidden)
    new_slayers = []
    if weights is not None:
        denom = (torch.sum(weights, 1) + 1e-9)[:, None]
    for i, p in enumerate(params["layers"]):
        if cfg.compute_dtype == "bfloat16":
            h = torch.bmm(h.to(torch.bfloat16).float(),
                          p["w"].to(torch.bfloat16).float()) + p["b"][:, None]
        else:
            h = torch.bmm(h, p["w"]) + p["b"][:, None]
        if i == n_hidden:  # output layer: logits
            new_slayers.append(dict(state["layers"][i]))
            break
        h = torch.relu(h)
        s = state["layers"][i]
        if cfg.batch_norm:
            if train:
                if weights is not None:
                    mean = torch.sum(h * weights[:, :, None], 1) / denom
                    var = torch.sum(((h - mean[:, None]) ** 2)
                                    * weights[:, :, None], 1) / denom
                else:
                    mean = torch.mean(h, dim=1)
                    var = torch.var(h, dim=1, unbiased=False)
                m = cfg.bn_momentum
                new_slayers.append({"mean": s["mean"] * m + mean * (1 - m),
                                    "var": s["var"] * m + var * (1 - m)})
            else:
                mean, var = s["mean"], s["var"]
                new_slayers.append(dict(s))
            h = (h - mean[:, None]) * torch.rsqrt(var[:, None] + cfg.bn_eps)
            h = h * p["gamma"][:, None] + p["beta"][:, None]
        else:
            new_slayers.append(dict(s))
        rate = cfg.dropout[i] if i < len(cfg.dropout) else 0.0
        if train and rate > 0.0 and drop_gens is not None:
            keep = 1.0 - rate
            mask = torch.stack([
                torch.rand(h.shape[1:], generator=g, device=h.device)
                for g in drop_gens]) < keep
            h = torch.where(mask, h / keep, 0.0)
    return h, {"layers": new_slayers}


def _masked_loss_runs(model_cfg, params, state, x, y, w, drop_gens):
    """Per-run row-weighted CCE and accuracy (R,): `epoch_scan.py`'s
    `_masked_forward_loss` over the runs axis."""
    logits, new_state = apply_mlp_runs(model_cfg, params, state, x,
                                       train=True, drop_gens=drop_gens,
                                       weights=w)
    denom = torch.sum(w, 1) + 1e-9
    logp = torch.log_softmax(logits, -1)
    per = -torch.gather(logp, -1, y[..., None].long())[..., 0]
    loss = torch.sum(per * w, 1) / denom
    acc = torch.sum((torch.argmax(logits, -1) == y).float() * w, 1) / denom
    return loss, new_state, acc


def _adam_runs(opt, grads, state):
    """`Adam.update` with a per-run `count` (R,): the bias corrections are
    each run's own scalars, computed as a solo step computes its one."""
    b1, b2 = opt.b1, opt.b2
    mu = _tree_map(lambda m, g: (1 - b1) * g + b1 * m.float(),
                   state["mu"], grads)
    nu = _tree_map(lambda v, g: (1 - b2) * (g * g) + b2 * v.float(),
                   state["nu"], grads)
    count = state["count"] + 1
    c = count.float()
    bc1 = torch.stack([1 - b1 ** c[r] for r in range(c.shape[0])])
    bc2 = torch.stack([1 - b2 ** c[r] for r in range(c.shape[0])])
    updates = _tree_map(
        lambda m, v: ((m / _rows(bc1, m))
                      / (torch.sqrt(v / _rows(bc2, v)) + opt.eps))
        * (-opt.lr), mu, nu)
    cast = lambda t: t.to(opt.moments_dtype)  # noqa: E731
    return updates, {"count": count, "mu": _tree_map(cast, mu),
                     "nu": _tree_map(cast, nu)}


def _epoch_runs(model_cfg, optimizer, constraints, batch_size, shuffle,
                epochs_per_call, reshuffle_inner):
    """-> `epoch(params, state, opt_state, cstate, data, labels, perm_gens,
    drop_gens, n_true)` on stacked trees of the runs to train: the batched
    form of `epoch_scan.py::epoch_program`. `constraints` holds one
    projection per run (or None)."""

    def step(params, state, opt_state, cstate, x, y, w, drop_gens):
        p_req = _tree_map(lambda t: t.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, state, acc = _masked_loss_runs(model_cfg, p_req, state, x,
                                                 y, w, drop_gens)
            leaves = _tree_leaves(p_req)
            # the runs are independent, so the gradient of the sum is each
            # run's own gradient, exactly
            it = iter(torch.autograd.grad(loss.sum(), leaves))
        grads = _tree_map(lambda _: next(it), p_req)
        state = _tree_map(lambda t: t.detach(), state)
        with torch.no_grad():
            updates, opt_state = _adam_runs(optimizer, grads, opt_state)
            params = _tree_map(lambda p, u: p + u, params, updates)
            if model_cfg.nonneg:
                params = _nonneg_clamp(params)
            if constraints is not None:
                # K2 has no batching rule: one projection per run
                runs = [con(_run(params, r), _run(cstate, r))
                        for r, con in enumerate(constraints)]
                params = _stack([p for p, _ in runs])
                cstate = _stack([c for _, c in runs])
        return params, state, opt_state, cstate, loss.detach(), acc.detach()

    def epoch(params, state, opt_state, cstate, data, labels, perm_gens,
              drop_gens, n_true):
        n_runs = opt_state["count"].shape[0]
        batches = None
        for _ in range(epochs_per_call):
            if batches is None or reshuffle_inner:
                per_run = [shuffle_batches(data, labels, batch_size, shuffle,
                                           perm_gens[r], n_true)
                           for r in range(n_runs)]
                batches = [torch.stack(t, 1) for t in zip(*per_run)]
            xs, ys, ws = batches
            losses, accs = [], []
            for i in range(xs.shape[0]):
                params, state, opt_state, cstate, loss, acc = step(
                    params, state, opt_state, cstate, xs[i], ys[i], ws[i],
                    drop_gens)
                losses.append(loss)
                accs.append(acc)
            ls, acs = torch.stack(losses, 1), torch.stack(accs, 1)
            ns = torch.sum(ws, 2)  # (steps, R)
            # each run's weighted means, summed as a solo epoch sums them
            mean_loss = torch.stack([torch.sum(ls[r] * ns[:, r])
                                     / torch.sum(ns[:, r])
                                     for r in range(n_runs)])
            mean_acc = torch.stack([torch.sum(acs[r] * ns[:, r])
                                    / torch.sum(ns[:, r])
                                    for r in range(n_runs)])
        return params, state, opt_state, cstate, mean_loss, mean_acc

    return epoch


def build_multi_run_epoch_fn(
    model_cfg: MLPConfig,
    optimizer,
    constraint=None,
    *,
    constraint_factory=None,
    batch_size: int = 256,
    shuffle: bool = True,
    epochs_per_call: int = 1,
    reshuffle_inner: bool = True,
):
    """-> `fn(params, state, opt_state, cstate, data, labels, perm_gens,
    drop_gens, active, rhos, n_true)` where the four train-state trees are
    stacked on a leading runs axis, the generators are per-run lists
    (`fold_runs`; `drop_gens` None: no dropout) and `data`/`labels` are
    shared (padded to a multiple of batch_size).

    `active` is an optional bool [R] mask: an inactive run is not trained
    (nor computed), its state is carried over bit for bit and its loss and
    accuracy read NaN. `rhos` is a float [R] vector consumed by
    `constraint_factory` (None with a fixed `constraint`); only one of
    `constraint` / `constraint_factory` may be given. Returns stacked
    (params, state, opt_state, cstate, mean_loss[R], mean_acc[R]); the
    inputs are not modified. The active runs train as one batched program
    (`apply_mlp_runs`: a `torch.bmm` per Dense), the constraint's
    projection once per run. The runs are independent: under a mesh the
    function trains the runs its trees hold, this rank's share from
    `init_multi_run_state(mesh=...)`, with no collective."""
    if constraint is not None and constraint_factory is not None:
        raise ValueError("pass either constraint or constraint_factory")

    def fn(params, state, opt_state, cstate, data, labels, perm_gens,
           drop_gens, active, rhos, n_true):
        trees = (params, state, opt_state, cstate)
        n_runs = opt_state["count"].shape[0]
        idx = [r for r in range(n_runs)
               if active is None or bool(active[r])]
        out = _tree_map(lambda t: t.clone(), trees)
        loss = torch.full((n_runs,), float("nan"), device=data.device)
        acc = loss.clone()
        if not idx:
            return (*out, loss, acc)
        if constraint_factory is not None:
            cons = [constraint_factory(float(rhos[r])).apply for r in idx]
        else:
            cons = None if constraint is None else [constraint] * len(idx)
        sel = torch.as_tensor(idx, device=data.device)
        sub = _tree_map(lambda t: t.index_select(0, sel), trees)
        epoch = _epoch_runs(model_cfg, optimizer, cons, batch_size, shuffle,
                            epochs_per_call, reshuffle_inner)
        *new, l_sub, a_sub = epoch(
            *sub, data, labels, [perm_gens[r] for r in idx],
            None if drop_gens is None else [drop_gens[r] for r in idx],
            n_true)
        _tree_map(lambda dst, src: dst.index_copy_(0, sel, src), out,
                  tuple(new))
        loss[sel], acc[sel] = l_sub, a_sub
        return (*out, loss, acc)

    return fn


def build_multi_run_eval_fn(model_cfg: MLPConfig, batch_size: int = 1024):
    """-> `evaluate(params, state, data, labels, n_true)` with params/state
    stacked on a runs axis -> (val_loss[R], val_acc[R]): every run's
    forward on each shared batch as one batched program. Under a mesh it
    scores the runs its trees hold (this rank's share), as
    `build_multi_run_epoch_fn` trains them."""

    @torch.no_grad()
    def fn(params, state, data, labels, n_true):
        n_runs = params["layers"][0]["w"].shape[0]
        n_pad = data.shape[0]
        loss_sum = torch.zeros((n_runs,), device=data.device)
        hit_sum = torch.zeros((n_runs,), device=data.device)
        for i in range(0, n_pad, batch_size):
            x, y = data[i: i + batch_size], labels[i: i + batch_size]
            w = (torch.arange(i, i + x.shape[0], device=data.device)
                 < n_true).float()
            logits, _ = apply_mlp_runs(model_cfg, params, state, x)
            logp = torch.log_softmax(logits, -1)
            per = -torch.gather(
                logp, -1, y[None, :, None].long().expand(n_runs, -1, 1))[..., 0]
            loss_sum = loss_sum + torch.sum(per * w, 1)
            hit_sum = hit_sum + torch.sum(
                (torch.argmax(logits, -1) == y).float() * w, 1)
        return loss_sum / n_true, hit_sum / n_true

    return fn


def _run_share(mesh, n_runs: int) -> tuple[int, int]:
    """[lo, hi) of the runs this rank trains: the runs axis split over the
    mesh's first axis; ValueError unless it divides."""
    from ..parallel.mesh import axis_rows

    axis = mesh.axis_names[0]
    if n_runs % mesh.shape[axis]:
        raise ValueError(f"runs axis ({n_runs}) must divide across the "
                         f"{mesh.shape[axis]}-rank mesh")
    return axis_rows(mesh, n_runs, axis)


def _where_runs(better, new, old):
    """Per-run select over stacked trees: better is bool [R]."""
    def sel(n, o):
        return torch.where(better.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)

    return _tree_map(sel, new, old)


def fit_multi_run(
    model_cfg: MLPConfig,
    train_cfg,
    train_x,
    train_y,
    val_x,
    val_y,
    seeds,
    *,
    constraint=None,
    constraint_init=None,
    constraint_factory=None,
    rhos=None,
    mesh=None,
    epoch_backend: str = "plain",
    device=None,
) -> dict:
    """Train len(seeds) runs to early stopping on one device-resident split;
    the multi-run analog of `Trainer.fit(device_resident=True)` with the same
    per-run semantics (generator derivation, epoch math, Keras EarlyStopping
    patience on val_loss, best-snapshot retention), except that early
    stopping is evaluated per run at `epochs_per_dispatch` granularity and
    finished runs are frozen while the rest continue. Everything runs on
    `device` (None: the CUDA device; "cpu" for the CPU).

    Pass a fixed `constraint` (+ `constraint_init`) for a seed study, or
    `constraint_factory` + `rhos` (one per run) for a constraint-strength
    sweep; seeds and rhos pair elementwise.

    `epoch_backend="fused"` trains each chunk through the fused epoch (K3 on
    a card, its twin on the CPU; `build_multi_run_fused_epoch_fn`): either no
    constraint or the full simple_norm at a fixed rho; it evaluates each run
    as a solo fit does. The default is "plain" (autograd: the active runs'
    epoch and the evaluation as one batched program, `apply_mlp_runs`):
    dropout draws differ between the backends, so a seed study must not
    switch engines between merged invocations.

    Returns a dict of stacked results, runs axis leading: params, state,
    opt_state, constraint_state (device tensors), best_params / best_state /
    best_opt_state (host tensors), best_val_loss [R], best_epoch [R],
    epochs_run [R] and history arrays of shape [n_chunks, R] (numpy). After
    a run freezes, its val_loss/val_acc rows repeat its frozen values and its
    train loss/acc rows read NaN; epochs_run[r] marks where run r's history
    ends.

    `mesh` splits the runs axis over the ranks of the mesh's first axis
    (len(seeds) must divide, ValueError otherwise; the plain backend only,
    as in the JAX package): each rank trains its share and every rank
    returns all the runs, gathered in order."""
    from ..parallel.mesh import pad_to_multiple

    if constraint is not None and constraint_factory is not None:
        raise ValueError("pass either constraint or constraint_factory")
    if (constraint_factory is None) != (rhos is None):
        raise ValueError("constraint_factory and rhos go together")
    if len(val_x) == 0:
        raise ValueError(
            "fit_multi_run() needs a non-empty validation split (early "
            "stopping and best-snapshot retention monitor val_loss)")
    cfg = train_cfg
    if cfg.epochs_per_dispatch < 1:
        raise ValueError(f"TrainConfig.epochs_per_dispatch must be >= 1, got "
                         f"{cfg.epochs_per_dispatch}")
    if epoch_backend not in ("plain", "fused"):
        raise ValueError(f"unknown epoch_backend {epoch_backend!r} (valid: "
                         f"plain, fused)")
    use_fused = epoch_backend == "fused"
    if use_fused:
        kind = getattr(constraint, "_asrtpu_kind", None)
        meta = getattr(constraint, "_asrtpu_meta", None) or {}
        if mesh is not None or constraint_factory is not None or (
                constraint is not None
                and not (kind == "simple_norm" and meta.get("affected_all"))):
            raise ValueError(
                "epoch_backend='fused' supports single-device runs with "
                "either no constraint or the full (all-layers) simple_norm "
                "at a fixed rho: the configurations the fused epoch "
                "implements (pass epoch_backend='plain' otherwise)")
    seeds = np.asarray(seeds)
    n_runs = len(seeds)
    rho_list = None
    if constraint_factory is not None:
        rho_list = np.asarray(rhos, np.float32)
        if rho_list.shape != (n_runs,):
            raise ValueError(f"rhos must have one entry per run: got "
                             f"{rho_list.shape} for {n_runs} runs")
        if constraint_init is None:
            # every engine constraint's init is independent of rho
            constraint_init = constraint_factory(1.0).init
    if mesh is not None:
        lo, hi = _run_share(mesh, n_runs)
        seeds = seeds[lo:hi]
        rho_list = None if rho_list is None else rho_list[lo:hi]
        n_runs = hi - lo

    dev = resolve_device(device)
    bs = cfg.batch_size

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    d_tr, n_true = pad_to_multiple(np.asarray(train_x, np.float32), bs)
    l_tr, _ = pad_to_multiple(np.asarray(train_y, np.int64), bs)
    vx = np.asarray(val_x, np.float32)
    vy = np.asarray(val_y, np.int64)
    vb = 1024 if len(vx) >= 1024 else max(8, len(vx))
    d_v, _ = pad_to_multiple(vx, vb)
    l_v, _ = pad_to_multiple(vy, vb)
    d_train, l_train = put(d_tr, torch.float32), put(l_tr, torch.int64)
    d_val, l_val = put(d_v, torch.float32), put(l_v, torch.int64)

    optimizer = adam_optimizer(cfg.learning_rate, cfg.adam_moments_dtype)
    fstates = spec = None
    params = state = opt_state = cstate = None
    if use_fused:
        from ..ops.cuda_train import (FusedStepSpec, pad_features,
                                      unpack_opt_state, unpack_params)

        meta = getattr(constraint, "_asrtpu_meta", None) or {}
        con = constraint is not None
        spec = FusedStepSpec(cfg=model_cfg, batch=bs, lr=cfg.learning_rate,
                             rho=meta["rho"] if con else None,
                             pi_iters=meta.get("n_iter", 4) if con else 4)
        fstates, key_perm, key_drop = init_multi_run_fused_state(
            spec, seeds, device=dev)
        data_fused = pad_features(spec, d_train)

        def unpack_all(fs_stacked):
            """-> stacked (params, state, opt_state) of every run."""
            runs = []
            for r in range(n_runs):
                fs_r = _run(fs_stacked, r)
                p_r, s_r = unpack_params(spec, fs_r)
                runs.append((p_r, s_r, unpack_opt_state(spec, fs_r, optimizer,
                                                        p_r)))
            return _stack(runs)

        def make_epoch_fn(e_per_call):
            return build_multi_run_fused_epoch_fn(
                spec, shuffle=cfg.shuffle, epochs_per_call=e_per_call,
                reshuffle_inner=cfg.reshuffle_each_epoch)
    else:
        params, state, opt_state, cstate, key_perm, key_drop = (
            init_multi_run_state(model_cfg, optimizer, seeds,
                                 constraint_init, device=dev))

        def make_epoch_fn(e_per_call):
            return build_multi_run_epoch_fn(
                model_cfg, optimizer, constraint,
                constraint_factory=constraint_factory, batch_size=bs,
                shuffle=cfg.shuffle, epochs_per_call=e_per_call,
                reshuffle_inner=cfg.reshuffle_each_epoch)

    epoch_fns = {cfg.epochs_per_dispatch: make_epoch_fn(
        cfg.epochs_per_dispatch)}
    if use_fused:
        # the fused backend is a loop of solo programs, its evaluation too:
        # run r stays bit-equal to a solo fit on the card, where a batched
        # GEMM may sum in another order than a single one
        solo_eval = eval_program(model_cfg, batch_size=vb)

        def eval_fn(params, state, data, labels, n_true):
            outs = [solo_eval(_run(params, r), _run(state, r), data, labels,
                              n_true) for r in range(n_runs)]
            return tuple(torch.stack(o) for o in zip(*outs))
    else:
        eval_fn = build_multi_run_eval_fn(model_cfg, batch_size=vb)

    best_val = np.full((n_runs,), np.inf, np.float64)
    best = None  # the stacked snapshot on the device, per run
    best_epoch = np.zeros((n_runs,), np.int64)
    wait = np.zeros((n_runs,), np.int64)
    epochs_run = np.zeros((n_runs,), np.int64)
    history = {"loss": [], "acc": [], "val_loss": [], "val_acc": []}

    ep_stride = cfg.epochs_per_dispatch
    for epoch in range(0, cfg.epochs, ep_stride):
        active_np = wait < cfg.patience
        if not _any_active(mesh, active_np, dev):
            break
        this_stride = min(ep_stride, cfg.epochs - epoch)
        if this_stride not in epoch_fns:
            epoch_fns[this_stride] = make_epoch_fn(this_stride)
        pg = fold_runs(key_perm, epoch if cfg.reshuffle_each_epoch else 0,
                       dev)
        dg = fold_runs(key_drop, epoch, dev)
        if use_fused:
            fstates, mloss, macc = epoch_fns[this_stride](
                fstates, data_fused, l_train, pg, dg, active_np, n_true)
            params, state, opt_state = unpack_all(fstates)
        else:
            params, state, opt_state, cstate, mloss, macc = epoch_fns[
                this_stride](params, state, opt_state, cstate, d_train,
                             l_train, pg, dg, active_np, rho_list, n_true)
        vl, va = eval_fn(params, state, d_val, l_val, len(vx))
        vl_np = vl.double().cpu().numpy()
        history["loss"].append(mloss.cpu().numpy())
        history["acc"].append(macc.cpu().numpy())
        history["val_loss"].append(vl_np)
        history["val_acc"].append(va.cpu().numpy())
        epochs_run += np.where(active_np, this_stride, 0)

        improved = (vl_np < best_val) & active_np
        cur = (params, state, opt_state)
        if best is None:
            best = _tree_map(lambda t: t.clone(), cur)
        else:
            best = _where_runs(torch.as_tensor(improved, device=dev), cur,
                               best)
        best_val = np.where(improved, vl_np, best_val)
        best_epoch = np.where(improved, epochs_run, best_epoch)
        # Keras EarlyStopping per run: reset on improvement, else add the
        # whole dispatch's epochs (Trainer.fit does the same)
        wait = np.where(improved, 0,
                        wait + np.where(active_np, this_stride, 0))

    if use_fused:
        if params is None:  # epochs == 0
            params, state, opt_state = unpack_all(fstates)
        cstate = ({"u": fstates["u"][:, 0, :model_cfg.n_classes].clone()}
                  if constraint is not None else ())
    if best is None:
        best = (params, state, opt_state)
    history = {k: np.stack(v) if v else np.zeros((0, n_runs))
               for k, v in history.items()}
    if mesh is not None:
        (params, state, opt_state, cstate, best, best_val, best_epoch,
         epochs_run, history) = _gather_runs(
            mesh, (params, state, opt_state, cstate, best, best_val,
                   best_epoch, epochs_run, history), dev)
    best_params, best_state, best_opt = _tree_map(
        lambda t: t.detach().cpu().clone(), best)
    return {
        "params": params,
        "state": state,
        "opt_state": opt_state,
        "constraint_state": cstate,
        "best_params": best_params,
        "best_state": best_state,
        "best_opt_state": best_opt,
        "best_val_loss": best_val,
        "best_epoch": best_epoch,
        "epochs_run": epochs_run,
        "history": history,
    }


def _any_active(mesh, active_np, dev) -> bool:
    """Whether any run of any rank still trains: every rank reads the same
    reduced value, so all leave the loop together."""
    if mesh is None:
        return bool(active_np.any())
    from ..parallel.mesh import reduce_sum

    n = torch.tensor(float(active_np.sum()), device=dev)
    return bool(reduce_sum(mesh, n, mesh.axis_names[0]) > 0)


def _gather_runs(mesh, trees, dev):
    """Every tensor and numpy leaf of `trees` with its runs axis gathered
    over the mesh's first axis, in rank order (history arrays: the runs
    axis is the second). A collective: every rank calls it."""
    from ..parallel.mesh import gather_rows

    axis = mesh.axis_names[0]

    def gather(x, dim):
        if isinstance(x, torch.Tensor):
            return gather_rows(mesh, x, axis, dim)
        t = torch.as_tensor(np.ascontiguousarray(x), device=dev)
        return gather_rows(mesh, t, axis, dim).cpu().numpy()

    *head, history = trees
    out = _tree_map(lambda x: gather(x, 0), tuple(head))
    return (*out, {k: gather(v, 1) for k, v in history.items()})
