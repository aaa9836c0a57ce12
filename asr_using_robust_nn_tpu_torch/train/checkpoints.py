"""Checkpoints: a best-val store of the port's own, and HDF5 interop with
Keras.

Counterpart of the JAX package's `train/checkpoints.py`, whose store is
Orbax. The port's store needs neither Orbax nor h5py:

  <dir>/best.npz   params, state and the Adam state (count, mu, nu), flat
                   keys in the JAX tree layout ("params/layers/0/w", ...,
                   "opt_state/count", "opt_state/mu/layers/0/w", ...) plus
                   "__tree__", a JSON skeleton of the nesting (empty state
                   dicts included); read with allow_pickle=False
  <dir>/meta.json  {"epoch", "val_loss"}, the JAX package's keys

Both files are written under a temporary name and moved into place with
`os.replace`, so an interrupted save leaves the previous best whole. The
h5 helpers read and write the Keras weight layouts (both of them) and import
h5py inside the function; where it is missing they raise RuntimeError. A
JAX-trained model reaches the port through the .h5 file the JAX package's
`export_h5` writes: `import_keras_h5` here, then `CheckpointManager.save_best`.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

__all__ = ["CheckpointManager", "export_h5", "import_keras_h5",
           "validate_model_tree", "require_h5py"]

_TREE_KEY = "__tree__"


def _numpy(v) -> np.ndarray:
    """A host numpy copy of a leaf (tensor or array); floating tensors go
    through float32 (bf16 moments widen exactly)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.is_floating_point():
            v = v.float()
        return v.numpy()
    return np.asarray(v)


def _flatten(tree, prefix: str, out: dict):
    """Fill `out` with prefix/key/... -> leaf and return the skeleton: the
    same nesting with every leaf replaced by its flat key."""
    def key(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if isinstance(tree, dict):
        return {k: _flatten(v, key(k), out) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_flatten(v, key(i), out) for i, v in enumerate(tree)]
    out[prefix] = _numpy(tree)
    return prefix


def _unflatten(skeleton, arrays):
    if isinstance(skeleton, dict):
        return {k: _unflatten(v, arrays) for k, v in skeleton.items()}
    if isinstance(skeleton, list):
        return [_unflatten(v, arrays) for v in skeleton]
    return arrays[skeleton]


def _keystr(path) -> str:
    """A leaf path in `jax.tree_util.keystr`'s form: ['layers'][0]['w']."""
    return "".join(f"[{k!r}]" for k in path)


def _leaf_shapes(tree, path=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaf_shapes(v, path + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaf_shapes(v, path + (i,)))
        return out
    shape = tree.shape if isinstance(tree, torch.Tensor) else np.shape(tree)
    return {_keystr(path): tuple(shape)}


def validate_model_tree(params, state, cfg) -> None:
    """Check a restored {params, state} (tensors or arrays) against
    `init_mlp(cfg)`: the same tree structure and leaf shapes. A wrong-task or
    wrong-variant checkpoint fails here with a readable message instead of a
    shape error at the first forward. The expected tree is built on the CPU
    (a few MB, ~0.03 s): on the meta device init_mlp's arithmetic first
    loads torch's Python meta kernels, which took seconds."""
    from ..models.mlp import init_mlp

    want_p, want_s = init_mlp(cfg, None, device="cpu")
    for label, got, want in (("params", params, want_p),
                             ("state", state, want_s)):
        got_paths = _leaf_shapes(got)
        want_paths = _leaf_shapes(want)
        if got_paths.keys() != want_paths.keys():
            missing = sorted(want_paths.keys() - got_paths.keys())[:4]
            extra = sorted(got_paths.keys() - want_paths.keys())[:4]
            raise ValueError(
                f"checkpoint {label} tree does not match the model config "
                f"(in_dim={cfg.in_dim}, hidden={cfg.hidden}, "
                f"n_classes={cfg.n_classes}) — wrong --task/--variant? "
                f"missing leaves: {missing}; unexpected leaves: {extra}")
        bad = [(k, got_paths[k], want_paths[k]) for k in want_paths
               if got_paths[k] != want_paths[k]]
        if bad:
            k, g, w = bad[0]
            raise ValueError(
                f"checkpoint {label} leaf {k} has shape {g}, model config "
                f"expects {w} (in_dim={cfg.in_dim}, hidden={cfg.hidden}, "
                f"n_classes={cfg.n_classes}) — wrong --task/--variant? "
                f"({len(bad)} mismatched leaves total)")


def _replace_atomically(path: str, write) -> None:
    """`write(f)` into a temporary file beside `path`, then move it over
    `path` in one step."""
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            write(f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


class CheckpointManager:
    """Best-val checkpoint store: `<dir>/best.npz` + `<dir>/meta.json`.
    `writes` and `write_seconds` count what `save_best` cost."""

    def __init__(self, directory):
        self.directory = os.path.abspath(str(directory))
        os.makedirs(self.directory, exist_ok=True)
        self.writes = 0
        self.write_seconds = 0.0

    @property
    def best_path(self) -> str:
        return os.path.join(self.directory, "best.npz")

    def _meta_path(self) -> str:
        return os.path.join(self.directory, "meta.json")

    def save_best(self, params, state, opt_state, epoch: int,
                  val_loss: float) -> None:
        """Write the trees (tensors or arrays; the Adam state as the port's
        {"count", "mu", "nu"}) and the meta, replacing the previous best."""
        t0 = time.perf_counter()
        arrays: dict = {}
        skeleton = _flatten({"params": params, "state": state,
                             "opt_state": opt_state}, "", arrays)
        arrays[_TREE_KEY] = np.asarray(json.dumps(skeleton))
        _replace_atomically(self.best_path,
                            lambda f: np.savez(f, **arrays))
        meta = json.dumps({"epoch": int(epoch),
                           "val_loss": float(val_loss)}).encode()
        _replace_atomically(self._meta_path(), lambda f: f.write(meta))
        self.writes += 1
        self.write_seconds += time.perf_counter() - t0

    def load_best(self) -> tuple[dict, dict]:
        """-> ({"params", "state", "opt_state"} as numpy trees, meta)."""
        with np.load(self.best_path, allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}
        skeleton = json.loads(str(arrays.pop(_TREE_KEY)[()]))
        tree = _unflatten(skeleton, arrays)
        meta = {}
        if os.path.exists(self._meta_path()):
            with open(self._meta_path()) as f:
                meta = json.load(f)
        return tree, meta


def require_h5py():
    """The h5py module, or RuntimeError where it is not installed."""
    try:
        import h5py
    except ImportError as e:
        raise RuntimeError(
            "reading or writing .h5 weight files needs h5py, which is not "
            "installed here; use the .npz checkpoint store "
            "(CheckpointManager) instead") from e
    return h5py


def export_h5(path, params: dict, state: dict | None = None) -> None:
    """Write weights in the Keras-TF2 h5 layout: one group per layer with
    kernel/bias (Dense) and gamma/beta/moving_mean/moving_variance (BN),
    plus the `layer_names`/`weight_names` attributes Keras's `load_weights`
    walks. Leaves may be tensors or arrays."""
    h5py = require_h5py()

    def _wn(layer_name, weights):
        return np.asarray(
            [f"{layer_name}/{w}".encode() for w in weights], dtype="S64")

    with h5py.File(path, "w") as f:
        mw = f.create_group("model_weights")
        layer_names = []
        for i, layer in enumerate(params["layers"]):
            name = f"dense_{i}" if i else "dense"
            layer_names.append(name)
            outer = mw.create_group(name)
            g = outer.create_group(name)
            g.create_dataset("kernel:0", data=_numpy(layer["w"]))
            g.create_dataset("bias:0", data=_numpy(layer["b"]))
            outer.attrs["weight_names"] = _wn(name, ("kernel:0", "bias:0"))
            if "gamma" in layer:
                bname = (f"batch_normalization_{i}" if i
                         else "batch_normalization")
                layer_names.append(bname)
                bouter = mw.create_group(bname)
                bg = bouter.create_group(bname)
                gamma, beta = _numpy(layer["gamma"]), _numpy(layer["beta"])
                bg.create_dataset("gamma:0", data=gamma)
                bg.create_dataset("beta:0", data=beta)
                s = (state or {"layers": [{}] * len(params["layers"])})[
                    "layers"][i]
                bg.create_dataset("moving_mean:0", data=_numpy(
                    s.get("mean", np.zeros_like(beta))))
                bg.create_dataset("moving_variance:0", data=_numpy(
                    s.get("var", np.ones_like(gamma))))
                bouter.attrs["weight_names"] = _wn(
                    bname, ("gamma:0", "beta:0", "moving_mean:0",
                            "moving_variance:0"))
        mw.attrs["layer_names"] = np.asarray(
            [n.encode() for n in layer_names], dtype="S64")
        mw.attrs["backend"] = np.bytes_(b"tensorflow")


_K3_DENSE = {"0": "kernel", "1": "bias"}
_K3_BN = {"0": "gamma", "1": "beta", "2": "moving_mean",
          "3": "moving_variance"}


def _order_key(name: str) -> int:
    parts = name.rsplit("_", 1)
    if len(parts) == 2 and parts[1].isdigit():
        return int(parts[1])
    return 0


def import_keras_h5(path, cfg) -> tuple[dict, dict]:
    """Load a Keras-saved (or `export_h5`-saved) weights file into the port's
    tree, as float32 numpy leaves.

    Both HDF5 layouts Keras has used: TF2 legacy
    (`model_weights/<layer>/<layer>/kernel:0`, or the same without the
    `model_weights` wrapper) and Keras 3 `.weights.h5`
    (`layers/<layer>/vars/<idx>`, positional: Dense 0=kernel 1=bias,
    BatchNormalization 0=gamma 1=beta 2=moving_mean 3=moving_variance).
    Dense and BatchNormalization layers are taken in creation order
    (dense, dense_1, ...). The Dense count and the BatchNormalization count
    must both match `cfg`: variants can share every Dense shape and differ
    only in batch_norm, and without the second check a BN model would load
    with its BN weights left at their initial values."""
    h5py = require_h5py()

    with h5py.File(path, "r") as f:
        mw = f["model_weights"] if "model_weights" in f else f
        dense, bn = {}, {}

        def visit(name, obj):
            if not isinstance(obj, h5py.Dataset):
                return
            parts = name.split("/")
            if parts[0] == "layers" and len(parts) >= 4 and (
                    parts[-2] == "vars"):
                lname, idx = parts[1], parts[-1]
                if lname.startswith("dense") and idx in _K3_DENSE:
                    dense.setdefault(lname, {})[_K3_DENSE[idx]] = np.array(obj)
                elif lname.startswith("batch_normalization") and idx in _K3_BN:
                    bn.setdefault(lname, {})[_K3_BN[idx]] = np.array(obj)
                return
            lname = parts[0]
            dname = parts[-1].split(":")[0]
            if lname.startswith("dense"):
                dense.setdefault(lname, {})[dname] = np.array(obj)
            elif lname.startswith("batch_normalization"):
                bn.setdefault(lname, {})[dname] = np.array(obj)

        mw.visititems(visit)

    dense_names = sorted(dense, key=_order_key)
    bn_names = sorted(bn, key=_order_key)
    n_dense = len(cfg.hidden) + 1
    if len(dense_names) != n_dense:
        raise ValueError(
            f"checkpoint has {len(dense_names)} dense layers, model config "
            f"expects {n_dense} (hidden={cfg.hidden}) — wrong --task/--variant?")
    bn_idx = list(range(len(cfg.hidden))) if cfg.batch_norm else []
    if len(bn_names) != len(bn_idx):
        raise ValueError(
            f"checkpoint has {len(bn_names)} BatchNormalization layers, "
            f"model config expects {len(bn_idx)} "
            f"(batch_norm={cfg.batch_norm}) — wrong --variant?")
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    params = {"layers": [{"w": f32(dense[n]["kernel"]),
                          "b": f32(dense[n]["bias"])} for n in dense_names]}
    state = {"layers": [{} for _ in dense_names]}
    for i, name in zip(bn_idx, bn_names):
        params["layers"][i]["gamma"] = f32(bn[name]["gamma"])
        params["layers"][i]["beta"] = f32(bn[name]["beta"])
        state["layers"][i]["mean"] = f32(bn[name]["moving_mean"])
        state["layers"][i]["var"] = f32(bn[name]["moving_variance"])
    validate_model_tree(params, state, cfg)
    return params, state
