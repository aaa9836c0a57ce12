"""Move MLP parameters between the JAX package and the port.

Both packages keep one layout, {"layers": [{"w": (d_in, d_out), "b",
"gamma", "beta"}]} for params and {"layers": [{"mean", "var"}]} for state,
so conversion is a leaf-by-leaf copy with no transposes. The JAX side is
handled as numpy arrays (`np.asarray` of each leaf), so nothing here
imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_numpy", "params_to_numpy"]


def _map_layers(tree: dict, fn) -> dict:
    return {"layers": [{k: fn(v) for k, v in layer.items()}
                       for layer in tree["layers"]]}


def params_from_numpy(params: dict, state: dict,
                      device="cpu") -> tuple[dict, dict]:
    """(params, state) with array leaves (numpy, anything `np.asarray`
    takes, or tensors) -> float32 tensors on `device`. Array leaves are
    copied, so the result never aliases the caller's (possibly read-only)
    buffers."""
    def leaf(v):
        if isinstance(v, torch.Tensor):
            return v.to(device=device, dtype=torch.float32)
        return torch.tensor(np.asarray(v, dtype=np.float32), device=device)

    return _map_layers(params, leaf), _map_layers(state, leaf)


def params_to_numpy(params: dict, state: dict) -> tuple[dict, dict]:
    """The port's (params, state) -> float32 numpy arrays, in the layout the
    JAX package's `apply_mlp` takes."""
    def leaf(v):
        return v.detach().to("cpu", torch.float32).numpy()

    return _map_layers(params, leaf), _map_layers(state, leaf)
