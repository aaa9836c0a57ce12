"""The plain reference's MFCC: librosa's pipeline in numpy float64.

A frozen copy of the oracle the port is held against (its `ops/filters.py`
and `ops/frontend_ref.py`), kept here so that the benchmark's reference
imports nothing of the program:

  stft(center=True, pad_mode='constant', hann window)  -> |.|^2
  -> slaney mel filterbank (128 bands, fmin=0, fmax=sr/2)
  -> power_to_db(ref=1.0, amin=1e-10, top_db=80)  [top_db couples to the
     per-utterance max]
  -> orthonormal DCT-II along the mel axis, first n_mfcc rows.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["mfcc_ref", "mfcc_fixed_length_ref", "power_to_db_ref",
           "stft_power_ref", "num_frames", "hann_window", "pad_center",
           "mel_filterbank", "dct_matrix"]


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


def num_frames(n_samples, hop_length: int, n_fft: int = 2048):
    """Frame count of a centered STFT: 1 + (n + 2*(n_fft//2) - n_fft) // hop.

    Equals 1 + n//hop for even n_fft; for odd n_fft (speaker preset,
    n_fft=441) the center pad is n_fft-1 in total, so lengths divisible by
    hop produce one frame fewer, as librosa does."""
    return 1 + (n_samples + 2 * (n_fft // 2) - n_fft) // hop_length


def stft_power_ref(
    y: np.ndarray, n_fft: int, hop_length: int, win_length: int,
    pad_mode: str = "constant",
) -> np.ndarray:
    """Power spectrogram |STFT|^2, shape (1+n_fft//2, n_frames), float64."""
    y = np.asarray(y, dtype=np.float64)
    pad = n_fft // 2
    ypad = np.pad(y, (pad, pad), mode=pad_mode)
    n_frames = 1 + (len(ypad) - n_fft) // hop_length
    window = pad_center(hann_window(win_length), n_fft)
    frames = np.stack(
        [ypad[t * hop_length : t * hop_length + n_fft] for t in range(n_frames)]
    )
    spec = np.fft.rfft(frames * window[None, :], axis=-1)
    return (np.abs(spec) ** 2).T


def power_to_db_ref(
    s: np.ndarray, amin: float = 1e-10, top_db: float = 80.0
) -> np.ndarray:
    """librosa.power_to_db with its defaults (ref=1.0)."""
    log_spec = 10.0 * np.log10(np.maximum(amin, s))
    return np.maximum(log_spec, log_spec.max() - top_db)


def mfcc_ref(
    y: np.ndarray,
    sr: int = 22050,
    n_mfcc: int = 20,
    n_fft: int = 2048,
    hop_length: int = 512,
    win_length: int | None = None,
    n_mels: int = 128,
    pad_mode: str = "constant",
) -> np.ndarray:
    """MFCCs of a single waveform, shape (n_mfcc, n_frames)."""
    if win_length is None:
        win_length = n_fft
    power = stft_power_ref(y, n_fft, hop_length, win_length, pad_mode)
    mel = mel_filterbank(sr, n_fft, n_mels) @ power
    db = power_to_db_ref(mel)
    return dct_matrix(n_mfcc, n_mels) @ db


def mfcc_fixed_length_ref(
    y: np.ndarray, utterance_length: int, **kwargs
) -> np.ndarray:
    """MFCC truncated/zero-padded on the time axis to `utterance_length`
    frames — the reference's extract_features behavior."""
    m = mfcc_ref(y, **kwargs)
    if m.shape[1] > utterance_length:
        return m[:, :utterance_length]
    return np.pad(m, ((0, 0), (0, utterance_length - m.shape[1])))
