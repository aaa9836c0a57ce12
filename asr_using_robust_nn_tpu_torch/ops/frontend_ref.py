"""Numpy f64 reference implementation of the librosa MFCC pipeline.

A copy of `asr_using_robust_nn_tpu/ops/frontend_ref.py`, the oracle both
packages are held against:

  stft(center=True, pad_mode='constant', hann window)  -> |.|^2
  -> slaney mel filterbank (128 bands, fmin=0, fmax=sr/2)
  -> power_to_db(ref=1.0, amin=1e-10, top_db=80)  [top_db couples to the
     per-utterance max]
  -> orthonormal DCT-II along the mel axis, first n_mfcc rows.
"""

from __future__ import annotations

import numpy as np

from . import filters

__all__ = ["mfcc_ref", "mfcc_fixed_length_ref", "power_to_db_ref",
           "stft_power_ref", "num_frames"]


def num_frames(n_samples, hop_length: int, n_fft: int = 2048):
    """Frame count of a centered STFT: 1 + (n + 2*(n_fft//2) - n_fft) // hop.

    Equals 1 + n//hop for even n_fft, but for odd n_fft (speaker preset,
    n_fft=441) the center pad is n_fft-1 in total, so lengths divisible by
    hop produce one frame fewer, as librosa does.

    The single copy of this formula in the port: FrontendConfig.num_frames
    and the per-utterance valid-frame mask both delegate here (`n_samples`
    may be an int, an integer array or an integer tensor — the arithmetic is
    pure floor division)."""
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
    window = filters.pad_center(filters.hann_window(win_length), n_fft)
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
    mel = filters.mel_filterbank(sr, n_fft, n_mels) @ power
    db = power_to_db_ref(mel)
    return filters.dct_matrix(n_mfcc, n_mels) @ db


def mfcc_fixed_length_ref(
    y: np.ndarray, utterance_length: int, **kwargs
) -> np.ndarray:
    """MFCC truncated/zero-padded on the time axis to `utterance_length`
    frames — the reference's extract_features behavior."""
    m = mfcc_ref(y, **kwargs)
    if m.shape[1] > utterance_length:
        return m[:, :utterance_length]
    return np.pad(m, ((0, 0), (0, utterance_length - m.shape[1])))
