"""Dolphin (ultrasound) attack generator, a Python port of dolphin_attack.m.

Counterpart of the JAX package's `attacks/dolphin.py` (numpy and scipy on
the host; no device work). Reference: `Voice digit recogniton/
dolphin_attack.m` (MATLAB): band-pass the voice 100 Hz-7 kHz with a
10th-order Butterworth (:28-30), resample to 192 kHz (:52-54),
amplitude-modulate onto a 30 kHz carrier with a 0.001 carrier leak
(:57-62), peak-normalize, write the attack WAV (:84-86).
"""

from __future__ import annotations

import numpy as np

from ..utils import audio_io

__all__ = ["dolphin_attack", "generate_dolphin_wav"]


def dolphin_attack(
    voice: np.ndarray,
    sample_rate: int,
    carrier_freq: float = 30_000.0,
    ultra_rate: int = 192_000,
    band=(100.0, 7000.0),
    order: int = 10,
    carrier_leak: float = 0.001,
) -> tuple[np.ndarray, int]:
    """Voice waveform -> ultrasound attack waveform at ultra_rate."""
    from scipy.signal import butter, sosfilt

    if sample_rate <= 2 * band[1]:
        raise ValueError(
            f"sample_rate={sample_rate} cannot represent the "
            f"{band[1]:.0f} Hz band edge (needs > {2 * band[1]:.0f} Hz)"
        )
    # The MATLAB script designs the band-pass in transfer-function (b, a)
    # form (:28), a 20th-order polynomial that is numerically unstable in
    # double precision at every common sample rate. The same filter as
    # second-order sections has the identical transfer function and
    # evaluates stably (docs/PARITY.md #15).
    sos = butter(
        order,
        [2 * band[0] / sample_rate, 2 * band[1] / sample_rate],
        btype="bandpass",
        output="sos",
    )
    filtered = sosfilt(sos, np.asarray(voice, dtype=np.float64))

    resampled = audio_io.resample(
        filtered.astype(np.float32), sample_rate, ultra_rate
    ).astype(np.float64)
    peak = np.max(np.abs(resampled))
    if peak > 0:
        resampled = resampled / peak

    t = np.arange(len(resampled)) / ultra_rate
    carrier = np.cos(2 * np.pi * carrier_freq * t)
    ultrasound = resampled * carrier + carrier_leak * carrier
    peak = np.max(np.abs(ultrasound))
    if peak > 0:
        ultrasound = ultrasound / peak
    return ultrasound.astype(np.float32), ultra_rate


def generate_dolphin_wav(voice_path, out_path, **kwargs) -> str:
    """File to file, as the MATLAB script runs end to end: read at the
    file's native rate (audioread, :5), the first channel of a
    multi-channel file (voice_signal(:,1), :30)."""
    channels, sr = audio_io.read_wav(voice_path)
    ultrasound, ultra_rate = dolphin_attack(channels[0], sr, **kwargs)
    audio_io.write_wav(out_path, ultrasound, ultra_rate)
    return str(out_path)
