"""Mesh helpers. Only `pad_to_multiple`, which the trainer's device-resident
path uses, is ported so far; meshes wait for the parallel slice."""

from __future__ import annotations

import numpy as np

__all__ = ["pad_to_multiple"]


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
