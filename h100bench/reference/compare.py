"""The numbers that decide `correct`: how far what the timed path produced
lies from the plain reference. Each is a gap, 0 where the two agree; a run is
correct when every number compared lies under its limit."""

from __future__ import annotations

import statistics

import torch

__all__ = ["max_abs_gap", "rel_series_gap", "leaf_gaps", "leaf_norm_gap"]


def max_abs_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| over all elements (float64); inf where the
    shapes differ or `got` holds a value that is not finite."""
    if got.shape != want.shape:
        return float("inf")
    d = (got.double() - want.double()).abs()
    return float("inf") if not torch.isfinite(d).all() else float(d.max())


def rel_series_gap(got, want) -> float:
    """The largest |got_e - want_e| / |want_e| over a series (per-epoch
    losses); inf where the lengths differ or a value is not finite."""
    if len(got) != len(want) or not len(want):
        return float("inf")
    gaps = [abs(g - w) / abs(w) for g, w in zip(got, want)]
    return max(gaps) if all(g == g and g != float("inf") for g in gaps) \
        else float("inf")


def leaf_gaps(got: dict, want: dict) -> dict:
    """Each leaf's (‖got‖, ‖want‖), for a report beside the numbers."""
    return {k: (float(torch.linalg.vector_norm(got[k].double())),
                float(torch.linalg.vector_norm(want[k].double())))
            for k in want if k in got}


def leaf_norm_gap(got: dict, want: dict, gate: dict | None = None) -> float:
    """The worst leaf's gap of norms: |‖got_k‖ - ‖want_k‖| / max(‖want_k‖,
    the median leaf's ‖want‖), over the leaves of `want` (name -> tensor).
    Where `gate` (name -> the reference's gradient of the leaf) is given, a
    leaf whose gradient norm is under a thousandth of the median leaf's moves
    by round-off alone and is left out."""
    norms = {k: float(torch.linalg.vector_norm(v.double()))
             for k, v in want.items()}
    keys = list(want)
    if gate is not None:
        g = {k: float(torch.linalg.vector_norm(gate[k].double()))
             for k in keys}
        g_med = statistics.median(g.values())
        keys = [k for k in keys if g[k] >= 1e-3 * g_med]
    med = statistics.median(norms[k] for k in keys)
    worst = 0.0
    for k in keys:
        if k not in got or got[k].shape != want[k].shape:
            return float("inf")
        n = float(torch.linalg.vector_norm(got[k].double()))
        if n != n or n == float("inf"):
            return float("inf")
        worst = max(worst, abs(n - norms[k]) / max(norms[k], med, 1e-30))
    return worst
