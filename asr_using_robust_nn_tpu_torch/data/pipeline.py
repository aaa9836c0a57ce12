"""Dataset helpers of the serving path, in numpy.

The part of the JAX package's `data/pipeline.py` that serving needs: the
reference's 1-s slicing of long recordings and its fit-on-all scaler.
"""

from __future__ import annotations

import numpy as np

__all__ = ["slice_seconds", "standardize_fit_all"]


def slice_seconds(y: np.ndarray, sr: int = 22050) -> np.ndarray:
    """Split audio into 1-s windows, dropping the first and last second.

    Reference semantics: with L = len(y) and W = sr, keep
    y[W : (floor(L/W)-1)*W] and cut it into floor(./W) windows.
    Returns (n_windows, sr); n_windows may be 0 for short recordings.
    """
    w = sr
    audio_len = int(len(y) / w)
    y = y[w : (audio_len - 1) * w]
    n = int(len(y) / w)
    if n <= 0:
        return np.zeros((0, w), dtype=np.float32)
    return np.asarray(y[: n * w], dtype=np.float32).reshape(n, w)


def standardize_fit_all(
    train: np.ndarray, dev: np.ndarray, test: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Z-score using mean/std fit on train+dev+test *combined*, as the
    reference's scaler does (StandardScaler fit on the concatenation, then
    re-sliced). Returns (train, dev, test, mean, scale); scale uses ddof=0
    like sklearn, and a constant feature gets scale 1."""
    all_data = np.concatenate((train, dev, test), axis=0)
    mean = all_data.mean(axis=0)
    scale = all_data.std(axis=0)
    scale = np.where(scale == 0.0, 1.0, scale)  # sklearn constant-feature rule
    f = lambda x: (x - mean) / scale  # noqa: E731
    return f(train), f(dev), f(test), mean, scale
