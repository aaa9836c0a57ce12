"""On-device polyphase resampling as one frames-x-matrix product: the
counterpart of the JAX package's `ops/resample.py`.

Moves the last host-side DSP stage of the reference's `librosa.load`
(resampling to 22.05 kHz) onto the GPU: decode WAVs on the host (cheap), ship
the batch at its native rate, resample on the device, feed the fused MFCC
kernels.

Math: with the shared anti-alias FIR h (`utils/audio_io.design_resample_filter`,
the same taps as the numpy and C++ paths, so all three produce the same
samples to fp32 rounding), output m of up/down resampling is

    y[m] = sum_j x[u_m - j] * h[r_m + up*j],   a_m = m*down + half,
    u_m = a_m // up,  r_m = a_m % up,  j in [0, K),  K = ceil(n_taps/up).

Writing m = q*up + s, the phase quantities r_s and c_s = (s*down+half)//up
depend only on s, so a frame matrix F[q, t] = x[q*down + c_min + t] (a
strided view, as in the MFCC frontend) turns the whole resampler into one
product F @ H with H[t, s] = h[r_s + up*(c_s - c_min - t)]. That product lies
outside every kernel of the JAX package and is a plain `torch.matmul` here.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.audio_io import design_resample_filter
from .mfcc_torch import frame_signal

__all__ = ["resample_matrix", "resample_batch_device"]


@functools.lru_cache(maxsize=None)
def resample_matrix(up: int, down: int) -> tuple[np.ndarray, int, int]:
    """-> (H (W, up) float32, c_min, W) for the shared FIR design."""
    taps = design_resample_filter(up, down)
    n_taps = len(taps)
    half = (n_taps - 1) // 2
    k = -(-n_taps // up)
    taps_pad = np.zeros(up * k, dtype=np.float64)
    taps_pad[:n_taps] = taps
    s = np.arange(up)
    a = s * down + half
    c = a // up  # c_s
    r = a % up  # r_s
    c_min = int(c.min()) - (k - 1)
    w = int(c.max()) - c_min + 1
    h = np.zeros((w, up), dtype=np.float64)
    for si in range(up):
        for j in range(k):
            t = c[si] - c_min - j
            h[t, si] = taps_pad[r[si] + up * j]
    return h.astype(np.float32), c_min, w


@functools.lru_cache(maxsize=8)
def _device_matrix(up: int, down: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(resample_matrix(up, down)[0]).to(device)


def resample_batch_device(x: torch.Tensor, orig_sr: int,
                          target_sr: int) -> torch.Tensor:
    """(B, L) waveforms at orig_sr -> (B, ceil(L*up/down)) at target_sr, on
    the tensor's device.

    Matches `utils/audio_io.resample` (and the C++ path) to fp32 rounding:
    same filter, same alignment.
    """
    x = x.to(torch.float32)
    if orig_sr == target_sr:
        return x
    if x.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False  # fp32 GEMM, never TF32
    g = int(np.gcd(orig_sr, target_sr))
    up, down = target_sr // g, orig_sr // g
    _, c_min, w = resample_matrix(up, down)
    h = _device_matrix(up, down, x.device)
    b, n = x.shape
    n_out = -(-n * up // down)
    n_q = -(-n_out // up)

    # frames F[q, t] = x[q*down + c_min + t]; shift the signal so index 0
    # corresponds to c_min (may be negative -> left zero pad)
    xp = F.pad(x, (max(0, -c_min), 0))
    if c_min > 0:
        xp = xp[:, c_min:]
    frames = frame_signal(xp, n_q, w, down)  # (B, n_q, W), a strided view
    out = frames @ h
    return out.reshape(b, n_q * up)[:, :n_out]
