"""Tensor-parallel training over a 2-D ('data', 'model') mesh of ranks.

Counterpart of the JAX package's `parallel/tensor_parallel.py`, with its
Megatron-style alternation over the Dense stack, leaf for leaf:

    hidden layer 0:  w (None, "model")     column-parallel: each rank holds
                     b/BN ("model",)        its output columns
    hidden layer 1:  w ("model", None)     row-parallel: the partial
                     b/BN ()                products are summed over 'model'
    ... alternating; the output layer is row-parallel when its input
    arrives split.

A spec names, for each leaf, the axis split over 'model' (a PartitionSpec
of the JAX package as a tuple). There GSPMD inserts the collectives; here
`models/mlp.py::apply_mlp` runs them under `mesh=` and `kinds=`: Megatron's
identity/all-reduce pair on a column-parallel layer's input, an all-reduce
of a row-parallel layer's partial products, BN moments over 'data' only
(the features of a column-parallel layer are this rank's), dropout on this
rank's rows and, on a column-parallel layer, its columns of the global
(B, width) draw.

The constraint needs the whole kernels (simple_norm's sigma is the norm of
their product): every rank gathers them over 'model', runs the projection
on the whole tree (on the card, K2) identically, and keeps its slices of
the result, so no two ranks see different sigma.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.mlp import MLPConfig, dense_kernels, init_mlp, predict_probs, \
    set_dense_kernels
from ..train.epoch_scan import masked_value_and_grad
from ..train.trainer import Trainer, _tree_map, apply_update
from .data_parallel import rank_rows, sharded_eval
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, gather_rows, replicated

__all__ = ["MODEL_AXIS", "tp_mesh", "mlp_tp_specs", "shard_mlp",
           "TensorParallelTrainer"]


def tp_mesh(n_data: int, n_model: int) -> Mesh:
    """2-D mesh ('data', 'model'), data-major: the ranks of one 'model'
    group are consecutive (rank = d * n_model + m). It must span the world
    (n_data * n_model ranks; 1 x 1 without a process group)."""
    return Mesh(np.arange(n_data * n_model).reshape(n_data, n_model),
                (DATA_AXIS, MODEL_AXIS))


def _layer_specs(i: int, n_hidden: int) -> tuple[tuple, tuple]:
    """(kernel spec, feature spec) for Dense layer i under the alternation;
    the feature spec covers the bias, BN gamma/beta and the moving
    stats."""
    if i == n_hidden:  # output layer: row-parallel iff its input is split
        if i > 0 and (i - 1) % 2 == 0:
            return (MODEL_AXIS, None), ()
        return (None, None), ()
    if i % 2 == 0:
        return (None, MODEL_AXIS), (MODEL_AXIS,)
    return (MODEL_AXIS, None), ()


def _kind(w_spec) -> str:
    return {(None, MODEL_AXIS): "col", (MODEL_AXIS, None): "row"}.get(
        tuple(w_spec), "rep")


def mlp_tp_specs(cfg: MLPConfig) -> tuple[dict, dict]:
    """Spec trees for (params, state) in init_mlp's layout."""
    p_layers, s_layers = [], []
    n_hidden = len(cfg.hidden)
    for i in range(cfg.n_dense):
        w_spec, f_spec = _layer_specs(i, n_hidden)
        p = {"w": w_spec, "b": f_spec}
        s = {}
        if i < n_hidden and cfg.batch_norm:
            p["gamma"] = f_spec
            p["beta"] = f_spec
            s["mean"] = f_spec
            s["var"] = f_spec
        p_layers.append(p)
        s_layers.append(s)
    return {"layers": p_layers}, {"layers": s_layers}


def _check_divisible(cfg: MLPConfig, n_model: int) -> None:
    dims = (cfg.in_dim,) + tuple(cfg.hidden) + (cfg.n_classes,)
    for i in range(cfg.n_dense):
        w_spec, _ = _layer_specs(i, len(cfg.hidden))
        for axis, dim in zip(w_spec, (dims[i], dims[i + 1])):
            if axis == MODEL_AXIS and dim % n_model != 0:
                raise ValueError(
                    f"layer {i}: dim {dim} not divisible by model axis "
                    f"size {n_model}")


def _specs_for_tree(params: dict, state: dict) -> tuple[dict, dict]:
    """Specs from the tree itself (BN present or not), by `_layer_specs`."""
    n_hidden = len(params["layers"]) - 1
    p_layers, s_layers = [], []
    for i, (p, s) in enumerate(zip(params["layers"], state["layers"])):
        w_spec, f_spec = _layer_specs(i, n_hidden)
        p_layers.append({k: (w_spec if k == "w" else f_spec) for k in p})
        s_layers.append({k: f_spec for k in s})
    return {"layers": p_layers}, {"layers": s_layers}


def _split_dim(spec):
    return list(spec).index(MODEL_AXIS) if MODEL_AXIS in spec else None


def _slice(mesh: Mesh, t, spec):
    """This rank's slice (a contiguous copy) of a whole leaf."""
    d = _split_dim(spec)
    if d is None:
        return t.clone()
    n = mesh.shape[MODEL_AXIS]
    if t.shape[d] % n:
        raise ValueError(f"a leaf of shape {tuple(t.shape)} does not split "
                         f"{n} ways along dim {d}")
    k = t.shape[d] // n
    return t.narrow(d, mesh.coords[MODEL_AXIS] * k, k).contiguous()


def _whole(mesh: Mesh, t, spec):
    """The whole leaf from every rank's slice (a collective over 'model')."""
    d = _split_dim(spec)
    return t if d is None else gather_rows(mesh, t, MODEL_AXIS, dim=d)


def shard_mlp(mesh: Mesh, params: dict, state: dict) -> tuple[dict, dict]:
    """This rank's slices (contiguous copies) of whole (params, state)
    trees, as `models/convert.py::params_from_numpy` gives them."""
    p_specs, s_specs = _specs_for_tree(params, state)
    take = lambda t, spec: _slice(mesh, t, spec)  # noqa: E731
    return (_tree_map(take, params, p_specs), _tree_map(take, state, s_specs))


def _gather(mesh: Mesh, tree: dict, specs: dict) -> dict:
    return _tree_map(lambda t, spec: _whole(mesh, t, spec), tree, specs)


class TensorParallelTrainer(Trainer):
    """Trainer whose parameters, BN state and Adam moments are split over
    'model' as `mlp_tp_specs` says, and whose batches split over 'data'.
    `fit` trains on the shards (`_init_train_state` / `_adopt_train_state`)
    and returns the rank's shards as params/state/opt_state, and whole
    host trees as best_params/best_state; checkpoints hold whole trees,
    written by rank 0 alone. A batch that does not divide over 'data' runs
    whole on every data rank (replicated over 'data')."""

    def __init__(self, model_cfg: MLPConfig, mesh: Mesh, train_cfg=None,
                 **kw):
        if mesh.axis_names != (DATA_AXIS, MODEL_AXIS):
            raise ValueError(
                f"mesh axes must be ({DATA_AXIS!r}, {MODEL_AXIS!r})")
        _check_divisible(model_cfg, mesh.shape[MODEL_AXIS])
        if train_cfg is not None and train_cfg.device_resident:
            raise NotImplementedError(
                "TensorParallelTrainer does not support device_resident=True "
                "(the device-resident epoch keeps replicated parameters); "
                "use the streaming fit")
        self.mesh = mesh
        super().__init__(model_cfg, train_cfg, **kw)
        self._kinds = [_kind(_layer_specs(i, len(model_cfg.hidden))[0])
                       for i in range(model_cfg.n_dense)]
        self._p_specs, self._s_specs = mlp_tp_specs(model_cfg)

    def _build_steps(self):
        cfg, opt, mesh = self.model_cfg, self.optimizer, self.mesh

        def project(params, cstate):
            """The constraint on the whole kernels, the same in every
            rank; each keeps its slices."""
            specs = [sp["w"] for sp in self._p_specs["layers"]]
            ws = [_whole(mesh, w, sp)
                  for w, sp in zip(dense_kernels(params), specs)]
            whole, cstate = self.constraint(set_dense_kernels(params, ws),
                                            cstate)
            mine = [_slice(mesh, w, sp)
                    for w, sp in zip(dense_kernels(whole), specs)]
            return set_dense_kernels(params, mine), cstate

        def train_step(params, state, opt_state, cstate, x, y, gen):
            split = x.shape[0] % mesh.shape[DATA_AXIS] == 0
            if split:
                xs, ys, ws, rows = rank_rows(mesh, x, y)
            else:  # a ragged batch runs whole on every data rank
                xs, ys, ws, rows = x, y, None, (0, x.shape[0])
            (loss, (state, acc)), grads = masked_value_and_grad(
                cfg, params, state, xs, ys, ws, gen, mesh, rows, self._kinds)
            con = project if self.constraint is not None else None
            params, opt_state, cstate = apply_update(
                opt, cfg, con, grads, params, opt_state, cstate)
            return params, state, opt_state, cstate, loss, acc

        def eval_step(params, state, x, y):
            return sharded_eval(cfg, mesh, params, state, x, y,
                                kinds=self._kinds,
                                split=x.shape[0]
                                % mesh.shape[DATA_AXIS] == 0)

        self.train_step = train_step
        self.eval_step = eval_step

    def make_train_state(self, generator=None):
        """-> (params, state, opt_state, cstate): this rank's shards of an
        init_mlp draw (`generator`, default seeded by the config's seed; rank
        0's draw is broadcast), Adam moments like the shards, and a copy of
        the constraint state."""
        if generator is None:
            from ..train.trainer import _generator

            generator = _generator(self.device, self.cfg.seed, 0)
        params, state = init_mlp(self.model_cfg, generator,
                                 device=self.device)
        return self._adopt_train_state(params, state)

    def place_batch(self, x, y):
        """A host batch -> tensors on this rank's device; the step takes the
        whole batch on every rank and keeps its rows."""
        return self._place_batch(x, y)

    def _init_train_state(self, gen):
        return self.make_train_state(gen)

    def _adopt_train_state(self, params, state, opt_state=None):
        """Whole (params, state) trees -> this rank's shards (copies), fresh
        Adam moments and a copy of the constraint state."""
        if opt_state is not None:
            raise NotImplementedError(
                "TensorParallelTrainer cannot adopt a restored optimizer "
                "state yet (its moments would need splitting like the "
                "params); resume with params/state only")
        own = lambda t: t.to(self.device).clone()  # noqa: E731
        params, state = replicated(self.mesh, (_tree_map(own, params),
                                               _tree_map(own, state)))
        self._check_whole(params)
        params, state = shard_mlp(self.mesh, params, state)
        cstate = _tree_map(own, self.constraint_state)
        return params, state, self.optimizer.init(params), cstate

    def _check_whole(self, params):
        dims = ((self.model_cfg.in_dim,) + tuple(self.model_cfg.hidden)
                + (self.model_cfg.n_classes,))
        got = [tuple(w.shape) for w in dense_kernels(params)]
        want = list(zip(dims[:-1], dims[1:]))
        if got != want:
            raise ValueError(f"expected whole kernels {want}, got {got} "
                             f"(pass whole trees, e.g. fit()'s best_params)")

    def _full_trees(self, params, state, opt_state=None):
        p_specs, s_specs = self._p_specs, self._s_specs
        full_opt = None
        if opt_state is not None:
            full_opt = {"count": opt_state["count"],
                        "mu": _gather(self.mesh, opt_state["mu"], p_specs),
                        "nu": _gather(self.mesh, opt_state["nu"], p_specs)}
        return (_gather(self.mesh, params, p_specs),
                _gather(self.mesh, state, s_specs), full_opt)

    def predict(self, params, state, x, batch_size: int | None = None):
        """Softmax probabilities from this rank's shards (gathered once);
        every rank computes the whole batch."""
        params, state, _ = self._full_trees(params, state)
        bs = batch_size or self.cfg.batch_size
        x = np.asarray(x, dtype=np.float32)
        with torch.no_grad():
            return np.concatenate([
                predict_probs(self.model_cfg, params, state,
                              self._tensor(x[i: i + bs], torch.float32))
                .cpu().numpy() for i in range(0, len(x), bs)], axis=0)

    @property
    def writes_files(self) -> bool:
        return self.mesh.rank == 0
