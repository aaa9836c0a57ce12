"""Host-side constructors for the constant matrices of the MFCC frontend.

A numpy copy of `asr_using_robust_nn_tpu/ops/filters.py`, kept free of the
JAX package so the port never imports it. These reproduce the constants
librosa builds internally for `librosa.feature.mfcc(y, sr)`:

  * periodic Hann window (scipy `get_window('hann', n, fftbins=True)`),
    center-padded to n_fft,
  * Slaney-style mel filterbank, 128 bands, fmin=0, fmax=sr/2, slaney norm,
  * orthonormal DCT-II (scipy `dct(type=2, norm='ortho')`), first n_mfcc rows,
  * real-DFT analysis matrices with the window folded in, so that the whole
    spectrogram becomes two GEMMs: P = (F@Cr)^2 + (F@Ci)^2.

All functions are pure and cached; callers copy the outputs to the device.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = [
    "hann_window",
    "pad_center",
    "mel_filterbank",
    "dct_matrix",
    "rdft_matrices",
    "n_fft_bins",
]


def n_fft_bins(n_fft: int) -> int:
    return 1 + n_fft // 2


@functools.lru_cache(maxsize=None)
def hann_window(win_length: int) -> np.ndarray:
    """Periodic (fftbins=True) Hann window, float64."""
    n = np.arange(win_length, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)


def pad_center(x: np.ndarray, size: int) -> np.ndarray:
    """Center-pad a 1-D array to `size` (librosa util.pad_center semantics)."""
    lpad = (size - len(x)) // 2
    if lpad < 0:
        raise ValueError(f"cannot pad array of {len(x)} to {size}")
    out = np.zeros(size, dtype=x.dtype)
    out[lpad : lpad + len(x)] = x
    return out


def _hz_to_mel(freqs: np.ndarray) -> np.ndarray:
    """Slaney (htk=False) Hz->mel: linear below 1 kHz, log above."""
    freqs = np.asanyarray(freqs, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freqs - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = freqs >= min_log_hz
    mels = np.where(
        log_t,
        min_log_mel + np.log(np.maximum(freqs, min_log_hz) / min_log_hz) / logstep,
        mels,
    )
    return mels


def _mel_to_hz(mels: np.ndarray) -> np.ndarray:
    mels = np.asanyarray(mels, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = mels >= min_log_mel
    freqs = np.where(
        log_t, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs
    )
    return freqs


@functools.lru_cache(maxsize=None)
def mel_filterbank(
    sr: int, n_fft: int, n_mels: int = 128, fmin: float = 0.0, fmax: float | None = None
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape (n_mels, 1+n_fft//2).

    Matches `librosa.filters.mel(sr=sr, n_fft=n_fft, n_mels=n_mels)` defaults
    (htk=False, norm='slaney').
    """
    if fmax is None:
        fmax = sr / 2.0
    # librosa fft_frequencies == np.fft.rfftfreq: bin k at k*sr/n_fft
    # (linspace(0, sr/2, bins) is equivalent only for even n_fft; for the
    # odd speaker preset n_fft=441 it mis-places every bin by up to 25 Hz)
    fftfreqs = np.arange(n_fft_bins(n_fft), dtype=np.float64) * (sr / n_fft)
    mel_f = _mel_to_hz(
        np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    )
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    # Slaney-style normalization: each triangle integrates to ~equal energy
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights


@functools.lru_cache(maxsize=None)
def dct_matrix(n_mfcc: int, n_mels: int) -> np.ndarray:
    """Orthonormal DCT-II matrix, shape (n_mfcc, n_mels).

    y[k] = sqrt(2/N) * f(k) * sum_n x[n] cos(pi k (2n+1) / (2N)),
    f(0) = 1/sqrt(2), f(k>0) = 1 — identical to
    scipy.fftpack.dct(x, type=2, norm='ortho') as called by librosa.feature.mfcc.
    """
    n = np.arange(n_mels, dtype=np.float64)
    k = np.arange(n_mfcc, dtype=np.float64)
    basis = np.cos(np.pi * k[:, None] * (2.0 * n[None, :] + 1.0) / (2.0 * n_mels))
    basis *= np.sqrt(2.0 / n_mels)
    basis[0] *= 1.0 / np.sqrt(2.0)
    return basis


@functools.lru_cache(maxsize=None)
def rdft_matrices(n_fft: int, win_length: int) -> tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT analysis matrices (Cr, Ci), each (n_fft, 1+n_fft//2).

    For a frame row-vector f (length n_fft, *unwindowed*),
        Re(rfft(f * w))[k] = f @ Cr[:, k],   Im(rfft(f * w))[k] = f @ Ci[:, k]
    with the (center-padded) Hann window w folded into the matrices.
    """
    w = pad_center(hann_window(win_length), n_fft)
    n = np.arange(n_fft, dtype=np.float64)
    k = np.arange(n_fft_bins(n_fft), dtype=np.float64)
    ang = 2.0 * np.pi * n[:, None] * k[None, :] / n_fft
    cr = np.cos(ang) * w[:, None]
    ci = -np.sin(ang) * w[:, None]
    return cr, ci
