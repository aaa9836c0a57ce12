"""The constrained training loop on tensors.

Counterpart of the JAX package's `train/trainer.py`. One train step is
forward + CCE + backward (autograd) + Adam + NonNeg clamp + Lipschitz
projection, in that order. Keras-parity knobs: Adam(lr=1e-3, eps=1e-7),
categorical cross-entropy from logits, early stopping on val_loss and best-val
snapshot retention.

Pytrees are plain dicts of tensors in the JAX layout; `_tree_map` walks them.
The Adam state is {"count": int32 0-d tensor, "mu": tree, "nu": tree}, the
fields of optax's ScaleByAdamState (models/convert.py moves it across).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from ..models.mlp import MLPConfig, apply_mlp, init_mlp, predict_probs
from ..utils.device import resolve_device
from ..utils.profiling import count, span

__all__ = ["TrainConfig", "Trainer", "Adam", "adam_optimizer", "apply_update",
           "cce_from_logits", "FusedEpochRefused"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 256
    epochs: int = 10000
    patience: int = 200  # EarlyStopping(monitor='val_loss') patience
    learning_rate: float = 1e-3
    seed: int = 0
    shuffle: bool = True
    reshuffle_each_epoch: bool = False  # tf.data reshuffle_each_iteration
    log_every: int = 0  # epochs between metric prints; 0 = silent
    device_resident: bool = False  # keep the split on the device and run
    # each epoch as one program (train/epoch_scan.py or the fused epoch)
    epochs_per_dispatch: int = 1  # device-resident only: E epochs per call;
    # history and early stopping then move in steps of E epochs
    adam_moments_dtype: str = "float32"  # 'bfloat16' stores the Adam moments
    # in bf16 (the math stays fp32), see `Adam`
    epoch_backend: str = "auto"  # device-resident epoch implementation:
    # 'plain' = train/epoch_scan.py (autograd); 'fused' = K3, the fused epoch
    # (ops/cuda_train.py: hand-written kernels replayed as one CUDA graph per
    # epoch; on a CPU device its plain twin runs); 'auto' = 'fused' iff the
    # device is CUDA, the fit has no mesh, the optimizer state is fresh and
    # the constraint is the full simple_norm (or None), else 'plain'.
    # The fused epoch is held once per process and configuration by
    # `epoch_parity_vs_plain` (fit's result carries the verdict as
    # `epoch_gate`). A refused check raises `FusedEpochRefused` under
    # 'fused' and 'auto' alike: 'auto' chooses from what it sees before any
    # launch, never from a kernel's failure, so the user reruns with 'plain'.


class FusedEpochRefused(RuntimeError):
    """The fused epoch's parity gate refused this configuration (`gate`:
    its verdict). The fit stops before its first epoch; the plain epoch
    trains it (`epoch_backend="plain"`, the CLI's `--epoch-backend plain`)."""

    def __init__(self, gate):
        self.gate = gate
        super().__init__(
            f"fused epoch parity check failed ({gate['why']}): {gate}; "
            f"rerun with --epoch-backend plain (epoch_backend='plain') to "
            f"train on the plain epoch")


def _tree_map(fn, *trees):
    """Map `fn` over the tensor leaves of dict/list/tuple trees."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _tree_leaves(t)]
    return [tree]


def _value_and_grad(loss_fn, params, *args):
    """(loss, aux), grads of `loss_fn(params, *args) -> (loss, aux)` with
    respect to every params leaf; the returned values carry no graph."""
    p_req = _tree_map(lambda t: t.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, aux = loss_fn(p_req, *args)
        leaves = _tree_leaves(p_req)
        grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    grad_tree = _tree_map(lambda _: next(it), p_req)
    aux = _tree_map(lambda t: t.detach(), aux)
    return (loss.detach(), aux), grad_tree


@dataclasses.dataclass(frozen=True)
class Adam:
    """Functional Adam with Keras' defaults: b1 0.9, b2 0.999, eps 1e-7
    (torch's own Adam uses 1e-8).

    moments_dtype float32 follows optax.adam; bfloat16 follows the JAX
    package's `_scale_by_adam_stored`: the moments are stored in bf16 and
    every step reads them up to fp32, updates, bias-corrects and writes them
    back down."""

    lr: float = 1e-3
    moments_dtype: torch.dtype = torch.float32
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-7

    def init(self, params) -> dict:
        leaves = _tree_leaves(params)
        dev = leaves[0].device if leaves else "cpu"
        z = lambda p: torch.zeros_like(p, dtype=self.moments_dtype)  # noqa: E731
        return {"count": torch.zeros((), dtype=torch.int32, device=dev),
                "mu": _tree_map(z, params), "nu": _tree_map(z, params)}

    def update(self, grads, state) -> tuple:
        """-> (updates, new_state); params += updates applies the step."""
        b1, b2 = self.b1, self.b2
        mu = _tree_map(lambda m, g: (1 - b1) * g + b1 * m.float(),
                       state["mu"], grads)
        nu = _tree_map(lambda v, g: (1 - b2) * (g * g) + b2 * v.float(),
                       state["nu"], grads)
        count = state["count"] + 1
        c = count.float()
        bc1 = 1 - b1 ** c
        bc2 = 1 - b2 ** c
        updates = _tree_map(
            lambda m, v: ((m / bc1) / (torch.sqrt(v / bc2) + self.eps))
            * (-self.lr), mu, nu)
        cast = lambda t: t.to(self.moments_dtype)  # noqa: E731
        return updates, {"count": count, "mu": _tree_map(cast, mu),
                         "nu": _tree_map(cast, nu)}


def adam_optimizer(lr: float = 1e-3, moments_dtype: str = "float32") -> Adam:
    """Keras 'adam' (eps 1e-7); 'bfloat16' stores the moments half-width."""
    return Adam(lr=lr, moments_dtype=getattr(torch, moments_dtype))


def cce_from_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean categorical cross-entropy; labels are int classes."""
    logp = torch.log_softmax(logits, -1)
    return -torch.mean(torch.gather(logp, -1, labels[:, None].long()))


def _nonneg_clamp(params: dict) -> dict:
    """Keras NonNeg kernel constraint: w *= (w >= 0), after each update."""
    layers = [dict(p, w=p["w"] * (p["w"] >= 0.0)) for p in params["layers"]]
    return dict(params, layers=layers)


def apply_update(optimizer, model_cfg, constraint, grads, params, opt_state,
                 cstate):
    """The one post-gradient sequence: optimizer update, NonNeg clamp,
    constraint projection, in that order."""
    with torch.no_grad():
        updates, opt_state = optimizer.update(grads, opt_state)
        params = _tree_map(lambda p, u: p + u, params, updates)
        if model_cfg.nonneg:
            params = _nonneg_clamp(params)
        if constraint is not None:
            params, cstate = constraint(params, cstate)
    return params, opt_state, cstate


def _generator(device, *words) -> torch.Generator:
    """A torch.Generator on `device` seeded from integer words (the port's
    stand-in for JAX's fold_in/split keys)."""
    seed = int(np.random.SeedSequence(list(words)).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(seed)


# once-per-process parity verdicts of the fused epoch, keyed by (model cfg,
# batch, rho, pi_iters, device)
_FUSED_EPOCH_GATE: dict = {}


class Trainer:
    """Train/eval steps with early stopping and best-params retention.
    `constraint` is an optional projection `(params, cstate) -> (params,
    cstate)` from constraints/engine.py, applied after the Adam update and
    the NonNeg clamp. Everything runs on `device` (None: the CUDA device, an
    error where there is none; "cpu" for the CPU)."""

    # the ranks a parallel trainer's steps span (parallel/mesh.py); a
    # single-device trainer has none
    mesh = None

    def __init__(
        self,
        model_cfg: MLPConfig,
        train_cfg: TrainConfig | None = None,
        constraint: Callable | None = None,
        constraint_state=None,
        epoch_callbacks: tuple[Callable, ...] = (),
        device=None,
    ):
        self.model_cfg = model_cfg
        self.cfg = train_cfg or TrainConfig()
        self.constraint = constraint
        self.constraint_state = constraint_state
        self.epoch_callbacks = tuple(epoch_callbacks)
        self.device = resolve_device(device)
        self.optimizer = adam_optimizer(self.cfg.learning_rate,
                                        self.cfg.adam_moments_dtype)
        self._build_steps()

    def _build_steps(self):
        model_cfg = self.model_cfg
        optimizer = self.optimizer

        def loss_fn(params, state, x, y, gen):
            logits, new_state = apply_mlp(model_cfg, params, state, x,
                                          train=True, generator=gen)
            loss = cce_from_logits(logits, y)
            acc = torch.mean((torch.argmax(logits, -1) == y).float())
            return loss, (new_state, acc)

        def train_step(params, state, opt_state, cstate, x, y, gen):
            (loss, (state, acc)), grads = _value_and_grad(
                loss_fn, params, state, x, y, gen)
            params, opt_state, cstate = apply_update(
                optimizer, model_cfg, self.constraint, grads, params,
                opt_state, cstate)
            return params, state, opt_state, cstate, loss, acc

        @torch.no_grad()
        def eval_step(params, state, x, y):
            logits, _ = apply_mlp(model_cfg, params, state, x, train=False)
            pred = torch.argmax(logits, -1)
            return (cce_from_logits(logits, y),
                    torch.mean((pred == y).float()), pred)

        self.train_step = train_step
        self.eval_step = eval_step

    def _resolve_epoch_backend(self, fresh_opt: bool) -> bool:
        """Whether a device-resident fit runs the fused epoch
        (TrainConfig.epoch_backend). It implements a fresh optimizer state
        (pack_state zeroes the moments) and either no constraint or the full
        all-layers simple_norm."""
        cfg = self.cfg
        if cfg.epoch_backend == "plain":
            return False
        if cfg.epoch_backend not in ("auto", "fused"):
            raise ValueError(f"unknown epoch_backend {cfg.epoch_backend!r} "
                             f"(valid: auto, plain, fused)")
        kind = getattr(self.constraint, "_asrtpu_kind", None)
        meta = getattr(self.constraint, "_asrtpu_meta", None) or {}
        supported = self.mesh is None and fresh_opt and (
            self.constraint is None
            or (kind == "simple_norm" and meta.get("affected_all")))
        if cfg.epoch_backend == "fused":
            if not supported:
                raise ValueError(
                    "epoch_backend='fused' needs a single-device fit (no "
                    "mesh) with a fresh optimizer state and either no "
                    "constraint or the full (all-layers) simple_norm "
                    "constraint: the configurations the fused epoch "
                    "implements")
            return True
        return supported and self.device.type == "cuda"

    def _init_train_state(self, gen):
        params, state = init_mlp(self.model_cfg, gen, device=self.device)
        opt_state = self.optimizer.init(params)
        cstate = _tree_map(lambda t: t.to(self.device).clone(),
                           self.constraint_state)
        return params, state, opt_state, cstate

    def _adopt_train_state(self, params, state, opt_state=None):
        """Warm start: copies of the caller's trees on this device; a given
        optimizer state is adopted, else Adam starts fresh."""
        own = lambda t: t.to(self.device).clone()  # noqa: E731
        params = _tree_map(own, params)
        state = _tree_map(own, state)
        opt_state = (self.optimizer.init(params) if opt_state is None
                     else _tree_map(own, opt_state))
        cstate = _tree_map(own, self.constraint_state)
        return params, state, opt_state, cstate

    @property
    def writes_files(self) -> bool:
        """Whether this process writes the fit's checkpoints and metrics
        (under a mesh: rank 0 alone; two ranks would race on one file)."""
        return True

    def _full_trees(self, params, state, opt_state=None):
        """The whole (params, state, opt_state) trees behind this process's
        own; a trainer whose ranks hold shards gathers them here."""
        return params, state, opt_state

    def _place_batch(self, x, y):
        """A host batch -> (x, y) tensors on this trainer's device."""
        return self._tensor(x, torch.float32), self._tensor(y, torch.int64)

    def _batches(self, n, rng):
        idx = np.arange(n)
        if self.cfg.shuffle:
            rng.shuffle(idx)
        bs = self.cfg.batch_size
        return [idx[i: i + bs] for i in range(0, n, bs)]

    def _tensor(self, a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=self.device)

    def evaluate(self, params, state, x, y, batch_size: int | None = None):
        """-> (loss, accuracy) over a dataset, batched like model.evaluate."""
        bs = batch_size or self.cfg.batch_size
        x = np.asarray(x, dtype=np.float32)
        y = np.asarray(y, dtype=np.int64)
        loss_sum, acc_sum = 0.0, 0.0
        for i in range(0, len(x), bs):
            n = len(x[i: i + bs])
            l, a, _ = self.eval_step(params, state,
                                     self._tensor(x[i: i + bs], torch.float32),
                                     self._tensor(y[i: i + bs], torch.int64))
            loss_sum += float(l) * n
            acc_sum += float(a) * n
            count("trainer.host_reads", 2)
        return loss_sum / len(x), acc_sum / len(x)

    def predict(self, params, state, x, batch_size: int | None = None):
        """Softmax probabilities, batched: `model.predict`."""
        bs = batch_size or self.cfg.batch_size
        x = np.asarray(x, dtype=np.float32)
        out = []
        with torch.no_grad():
            for i in range(0, len(x), bs):
                xb = self._tensor(x[i: i + bs], torch.float32)
                out.append(predict_probs(self.model_cfg, params, state,
                                         xb).cpu().numpy())
        return np.concatenate(out, axis=0)

    def fit(self, train_x, train_y, val_x, val_y, params=None, state=None,
            opt_state=None, initial_best_val=None, checkpoint_dir=None,
            metrics_dir=None) -> dict:
        """Full training loop with early stopping; returns best params (by
        val_loss, as host copies) and the history. Streaming mode copies
        each batch to the device per step; device-resident mode keeps the
        split there (TrainConfig.device_resident).

        Resume: pass params/state (+ opt_state to continue Adam) and the
        stored val_loss as `initial_best_val`; without the latter the
        resumed run starts from best = inf and its first epoch would
        overwrite a better saved best.

        `checkpoint_dir`: every val improvement is saved there
        (`train/checkpoints.py::CheckpointManager.save_best`: params, state,
        Adam state, epoch, val_loss). `metrics_dir`: per-epoch scalars loss,
        acc, val_loss, val_acc (`utils/profiling.py::MetricWriter`). The
        result names the epoch backend that ran ("streaming", "plain" or
        "fused"), the fused epoch's parity verdict (`epoch_gate`: None
        where no gate ran) and what the checkpoint writes cost.

        While a torch profiler records, the fit opens the spans
        `trainer.fit` (a new fit id), `trainer.setup`, and per epoch
        `trainer.dispatch`, `trainer.read`, `trainer.validate` and, on an
        improvement, `trainer.snapshot`; it counts `trainer.epochs` and
        `trainer.host_reads` (each blocking device-to-host read: a scalar,
        or a snapshot's leaf) (`utils/profiling.py`)."""
        with span("trainer.fit", new_fit=True):
            return self._fit(train_x, train_y, val_x, val_y, params, state,
                             opt_state, initial_best_val, checkpoint_dir,
                             metrics_dir)

    def _fit(self, train_x, train_y, val_x, val_y, params, state, opt_state,
             initial_best_val, checkpoint_dir, metrics_dir) -> dict:
        cfg = self.cfg
        dev = self.device
        if len(val_x) == 0:
            raise ValueError(
                "fit() needs a non-empty validation split (early stopping "
                "and best-checkpoint retention monitor val_loss)")
        fresh_opt = opt_state is None
        if params is None:
            params, state, opt_state, cstate = self._init_train_state(
                _generator(dev, cfg.seed, 0))
        else:
            params, state, opt_state, cstate = self._adopt_train_state(
                params, state, opt_state)

        train_x = np.asarray(train_x, dtype=np.float32)
        train_y = np.asarray(train_y, dtype=np.int64)
        rng = np.random.default_rng(cfg.seed)
        batch_idx = self._batches(len(train_x), rng)

        def host(t):
            count("trainer.host_reads")
            return t.detach().cpu().clone()

        def snapshot(full):
            with span("trainer.snapshot"):
                return _tree_map(host, full[:2])

        best_val = np.inf if initial_best_val is None else float(
            initial_best_val)
        best = None if initial_best_val is None else snapshot(
            self._full_trees(params, state))
        wait = 0
        history = {"loss": [], "acc": [], "val_loss": [], "val_acc": []}
        ckpt = writer = None
        if checkpoint_dir is not None and self.writes_files:
            from .checkpoints import CheckpointManager

            ckpt = CheckpointManager(checkpoint_dir)
        if metrics_dir is not None and self.writes_files:
            from ..utils.profiling import MetricWriter

            writer = MetricWriter(metrics_dir)

        dr = None
        backend = "streaming"
        gate = None
        if cfg.device_resident:
            with span("trainer.setup"):
                dr = self._device_resident_setup(train_x, train_y, val_x,
                                                 val_y, params, state,
                                                 fresh_opt)
            backend, gate = dr[-2:]

        t0 = time.perf_counter()
        steps = 0
        examples_seen = 0
        epochs_done = 0
        ep_stride = cfg.epochs_per_dispatch if dr is not None else 1
        drop_gen = _generator(dev, cfg.seed, 977)
        for epoch in range(0, cfg.epochs, ep_stride):
            if dr is not None:
                (epoch_fns, make_epoch_fn, eval_fn, d_train, l_train, n_true,
                 d_val, l_val, n_val, _, _) = dr
                this_stride = min(ep_stride, cfg.epochs - epoch)
                with span("trainer.dispatch"):
                    if this_stride not in epoch_fns:
                        epoch_fns[this_stride] = make_epoch_fn(this_stride)
                    pg = _generator(dev, cfg.seed, 1,
                                    epoch if cfg.reshuffle_each_epoch else 0)
                    dg = _generator(dev, cfg.seed, 2, epoch)  # fresh dropout
                    params, state, opt_state, cstate, mloss, macc = epoch_fns[
                        this_stride](params, state, opt_state, cstate,
                                     d_train, l_train, pg, dg, n_true)
                with span("trainer.read"):
                    ep_loss, ep_acc, ep_n = float(mloss), float(macc), 1.0
                    count("trainer.host_reads", 2)
                steps += -(-n_true // cfg.batch_size) * this_stride
                examples_seen += n_true * this_stride
                epochs_done += this_stride
                count("trainer.epochs", this_stride)
                with span("trainer.validate"):
                    vl, va = eval_fn(params, state, d_val, l_val, n_val)
                    val_loss, val_acc = float(vl), float(va)
                    count("trainer.host_reads", 2)
            else:
                if cfg.reshuffle_each_epoch:
                    batch_idx = self._batches(len(train_x), rng)
                # device scalars, read once per epoch
                losses, accs, ns = [], [], []
                with span("trainer.dispatch"):
                    for bidx in batch_idx:
                        bx, by = self._place_batch(train_x[bidx],
                                                   train_y[bidx])
                        params, state, opt_state, cstate, loss, acc = \
                            self.train_step(params, state, opt_state, cstate,
                                            bx, by, drop_gen)
                        losses.append(loss)
                        accs.append(acc)
                        ns.append(len(bidx))
                        steps += 1
                w = np.asarray(ns, np.float64)
                with span("trainer.read"):
                    ep_loss = float(torch.stack(losses).cpu().numpy() @ w)
                    ep_acc = float(torch.stack(accs).cpu().numpy() @ w)
                    count("trainer.host_reads", 2)
                ep_n = float(w.sum())
                examples_seen += int(ep_n)
                epochs_done += 1
                count("trainer.epochs")
                with span("trainer.validate"):
                    val_loss, val_acc = self.evaluate(params, state, val_x,
                                                      val_y)
            history["loss"].append(ep_loss / ep_n)
            history["acc"].append(ep_acc / ep_n)
            history["val_loss"].append(val_loss)
            history["val_acc"].append(val_acc)
            if self.epoch_callbacks:
                cb_params, cb_state, _ = self._full_trees(params, state)
                for cb in self.epoch_callbacks:
                    cb(epoch, cb_params, cb_state, history)
            if writer is not None:
                writer.scalars(
                    {"loss": history["loss"][-1], "acc": history["acc"][-1],
                     "val_loss": val_loss, "val_acc": val_acc}, epoch)
            if cfg.log_every and self.writes_files \
                    and (epoch % cfg.log_every) < ep_stride:
                print(f"epoch {epoch}: loss={history['loss'][-1]:.4f} "
                      f"acc={history['acc'][-1]:.4f} val_loss={val_loss:.4f} "
                      f"val_acc={val_acc:.4f}")
            # every rank of a mesh reads the same reduced val_loss, so all
            # take the same branch (a rank-local one would deadlock the next
            # collective)
            if val_loss < best_val:
                best_val = val_loss
                full = self._full_trees(
                    params, state,
                    opt_state if checkpoint_dir is not None else None)
                best = snapshot(full)
                wait = 0
                if ckpt is not None:
                    ckpt.save_best(*best, full[2], epoch, val_loss)
            else:
                # patience counts epochs, whatever each dispatch fuses
                wait += ep_stride if dr is not None else 1
                if wait >= cfg.patience:
                    break
        elapsed = time.perf_counter() - t0
        if writer is not None:
            writer.close()
        if best is None:
            best = snapshot(self._full_trees(params, state))
        return {
            "params": params,
            "state": state,
            "opt_state": opt_state,
            "constraint_state": cstate,
            "best_params": best[0],
            "best_state": best[1],
            "best_val_loss": best_val,
            "history": history,
            "epochs_run": epochs_done,
            "steps": steps,
            "seconds": elapsed,
            "examples_per_sec": examples_seen / max(elapsed, 1e-9),
            "epoch_backend": backend,
            "epoch_gate": gate,
            "checkpoint_writes": 0 if ckpt is None else ckpt.writes,
            "checkpoint_seconds": 0.0 if ckpt is None else ckpt.write_seconds,
        }

    def _device_resident_setup(self, train_x, train_y, val_x, val_y, params,
                               state, fresh_opt):
        """The split on the device and the epoch/eval programs of a
        device-resident fit (plain autograd epoch or the fused epoch); the
        last two entries name the one chosen and the parity gate's verdict
        (None where no gate ran)."""
        from ..parallel.mesh import pad_to_multiple
        from .epoch_scan import build_epoch_fn, build_eval_fn

        cfg = self.cfg
        dev = self.device
        if cfg.epochs_per_dispatch < 1:
            raise ValueError(f"TrainConfig.epochs_per_dispatch must be >= 1, "
                             f"got {cfg.epochs_per_dispatch}")
        bs = cfg.batch_size
        mesh = self.mesh
        n_data = 1 if mesh is None else mesh.shape["data"]
        if bs % n_data:
            raise ValueError(
                f"device_resident over a {n_data}-rank mesh needs "
                f"batch_size divisible by it (got {bs})")
        d_tr, n_true = pad_to_multiple(train_x, bs)
        l_tr, _ = pad_to_multiple(train_y, bs)
        d_train = self._tensor(d_tr, torch.float32)
        l_train = self._tensor(l_tr, torch.int64)
        vx = np.asarray(val_x, np.float32)
        vy = np.asarray(val_y, np.int64)
        vb = 1024 if len(vx) >= 1024 else max(8, len(vx))
        vb = -(-vb // n_data) * n_data
        d_v, _ = pad_to_multiple(vx, vb)
        l_v, _ = pad_to_multiple(vy, vb)
        d_val = self._tensor(d_v, torch.float32)
        l_val = self._tensor(l_v, torch.int64)

        fused = self._resolve_epoch_backend(fresh_opt)
        gate = None
        if fused:
            from ..ops.cuda_train import (
                FusedStepSpec, build_fused_epoch_fn, epoch_parity_vs_plain,
                pack_state, pad_features, unpack_opt_state, unpack_params)

            meta = getattr(self.constraint, "_asrtpu_meta", None) or {}
            con = self.constraint is not None
            spec = FusedStepSpec(
                cfg=self.model_cfg, batch=bs, lr=cfg.learning_rate,
                rho=meta["rho"] if con else None,
                pi_iters=meta.get("n_iter", 4) if con else 4)
            gate_key = (self.model_cfg, bs, spec.rho, spec.pi_iters, str(dev))
            if gate_key not in _FUSED_EPOCH_GATE:
                _FUSED_EPOCH_GATE[gate_key] = epoch_parity_vs_plain(
                    self.model_cfg, bs, d_train, l_train, n_true)
            gate = _FUSED_EPOCH_GATE[gate_key]
            if not gate["ok"]:
                raise FusedEpochRefused(gate)
            data_fused = pad_features(spec, d_train)
            fstate_cell = {"fs": pack_state(spec, params, state)}
            dims_last = self.model_cfg.n_classes

            def make_epoch_fn(e_per_call, _spec=spec):
                ep = build_fused_epoch_fn(
                    _spec, shuffle=cfg.shuffle, epochs_per_call=e_per_call,
                    reshuffle_inner=cfg.reshuffle_each_epoch)

                def fn(params, state, opt_state, cstate, d, l, pg, dg,
                       n_true):
                    fs, mloss, macc = ep(fstate_cell["fs"], data_fused, l, pg,
                                         dg, n_true=n_true)
                    fstate_cell["fs"] = fs
                    p2, s2 = unpack_params(_spec, fs)
                    o2 = unpack_opt_state(_spec, fs, self.optimizer, p2)
                    c2 = cstate
                    if isinstance(cstate, dict) and "u" in cstate:
                        c2 = {"u": fs["u"][0, :dims_last].clone()}
                    return p2, s2, o2, c2, mloss, macc

                return fn
        else:
            def make_epoch_fn(e_per_call):
                return build_epoch_fn(
                    self.model_cfg, self.optimizer, self.constraint,
                    batch_size=bs, shuffle=cfg.shuffle, mesh=mesh,
                    epochs_per_call=e_per_call,
                    reshuffle_inner=cfg.reshuffle_each_epoch)

        epoch_fns = {cfg.epochs_per_dispatch: make_epoch_fn(
            cfg.epochs_per_dispatch)}
        eval_fn = build_eval_fn(self.model_cfg, batch_size=vb, mesh=mesh)
        return (epoch_fns, make_epoch_fn, eval_fn, d_train, l_train, n_true,
                d_val, l_val, len(vx), "fused" if fused else "plain", gate)
