"""Move MLP parameters and training state between the JAX package and the
port.

Both packages keep one layout, {"layers": [{"w": (d_in, d_out), "b",
"gamma", "beta"}]} for params and {"layers": [{"mean", "var"}]} for state,
so conversion is a leaf-by-leaf copy with no transposes. The same holds for
the Adam state (optax's ScaleByAdamState count/mu/nu; the port keeps them in
a dict), the simple_norm constraint state {"u"} and the fused epoch's packed
state (`pack_state`'s dict). The JAX side is handled as numpy arrays
(`np.asarray` of each leaf; bf16 leaves cross as float32, which is exact),
so nothing here imports JAX.

Every conversion is leaf by leaf, so two things hold without special cases:
a per-step (K6) packed state crosses unchanged, with `scales` != 1 and its
own `w16` (no fold into the masters, no recast of the bf16 copies), and a
multi-run state, every leaf stacked on a leading runs axis (Adam's `count`
then has shape (R,)), crosses as it is.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["params_from_numpy", "params_to_numpy", "adam_state_from_numpy",
           "adam_state_to_numpy", "cstate_from_numpy", "cstate_to_numpy",
           "fstate_from_numpy", "fstate_to_numpy"]


def _map_layers(tree: dict, fn) -> dict:
    return {"layers": [{k: fn(v) for k, v in layer.items()}
                       for layer in tree["layers"]]}


def _tensor(v, device, dtype=torch.float32) -> torch.Tensor:
    """A copy of an array leaf (numpy, anything `np.asarray` takes, or a
    tensor) as a `dtype` tensor on `device`; never aliases the caller's."""
    if isinstance(v, torch.Tensor):
        return v.detach().to(device=device, dtype=dtype, copy=True)
    a = np.asarray(v)
    if a.dtype.kind == "f" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.tensor(a, device=device).to(dtype)


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.is_floating_point():
        t = t.float()
    return t.numpy()


def params_from_numpy(params: dict, state: dict,
                      device=None) -> tuple[dict, dict]:
    """(params, state) with array leaves (numpy, anything `np.asarray`
    takes, or tensors) -> float32 tensors on `device` (None: the CUDA
    device). Leaves are copied, so the result never aliases the caller's
    (possibly read-only) buffers."""
    device = resolve_device(device)

    def leaf(v):
        return _tensor(v, device)

    return _map_layers(params, leaf), _map_layers(state, leaf)


def params_to_numpy(params: dict, state: dict) -> tuple[dict, dict]:
    """The port's (params, state) -> float32 numpy arrays, in the layout the
    JAX package's `apply_mlp` takes."""
    def leaf(v):
        return v.detach().to("cpu", torch.float32).numpy()

    return _map_layers(params, leaf), _map_layers(state, leaf)


def adam_state_from_numpy(count, mu: dict, nu: dict, device=None,
                          moments_dtype=torch.float32) -> dict:
    """optax ScaleByAdamState fields (count, mu, nu) -> the port's Adam state
    {"count": int32 tensor (0-d, or (R,) for a stacked multi-run state),
    "mu", "nu"} on `device` (None: the CUDA device)."""
    device = resolve_device(device)
    return {"count": _tensor(count, device, torch.int32),
            "mu": _map_layers(mu, lambda v: _tensor(v, device, moments_dtype)),
            "nu": _map_layers(nu, lambda v: _tensor(v, device, moments_dtype))}


def adam_state_to_numpy(opt_state: dict) -> tuple:
    """The port's Adam state -> (count, mu, nu) as numpy (float32 moments),
    the fields of optax's ScaleByAdamState."""
    return (_numpy(opt_state["count"]).astype(np.int32)[()],
            _map_layers(opt_state["mu"], _numpy),
            _map_layers(opt_state["nu"], _numpy))


def cstate_from_numpy(cstate: dict, device=None) -> dict:
    """simple_norm constraint state {"u"} -> tensors on `device` (None: the
    CUDA device)."""
    return {"u": _tensor(cstate["u"], resolve_device(device))}


def cstate_to_numpy(cstate: dict) -> dict:
    return {"u": _numpy(cstate["u"])}


_FSTATE_STACKS = {"masters": torch.float32, "w16": torch.bfloat16,
                  "mw": torch.float32, "vw": torch.float32}


def fstate_from_numpy(fs: dict, device=None) -> dict:
    """A packed fused-epoch state (`pack_state`'s dict: masters, w16, mw, vw,
    small, scales, u, count) -> tensors on `device` (None: the CUDA device)
    in the port's dtypes."""
    device = resolve_device(device)
    out = {k: tuple(_tensor(v, device, dt) for v in fs[k])
           for k, dt in _FSTATE_STACKS.items()}
    out["small"] = {k: _tensor(v, device) for k, v in fs["small"].items()}
    out["scales"] = _tensor(fs["scales"], device)
    out["u"] = _tensor(fs["u"], device)
    out["count"] = _tensor(fs["count"], device, torch.int32)
    return out


def fstate_to_numpy(fs: dict) -> dict:
    """The port's packed state -> numpy (w16 as float32, count int32)."""
    out = {k: tuple(_numpy(v) for v in fs[k]) for k in _FSTATE_STACKS}
    out["small"] = {k: _numpy(v) for k, v in fs["small"].items()}
    for k in ("scales", "u", "count"):
        out[k] = _numpy(fs[k])
    return out
