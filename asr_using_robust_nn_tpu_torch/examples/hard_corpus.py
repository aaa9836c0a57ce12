"""Hard synthetic corpora: controllable class overlap, label noise, voices.

The port's own copy of `examples/hard_corpus.py` (its generators
`make_hard_corpus` `:30`, `make_speaker_corpus` `:116` and `flip_labels`
`:184`): the same seed writes the same WAV bytes and the same labels, so a
corpus the JAX study trained on can be rebuilt here bit for bit.

`make_hard_corpus` writes the digit-task layout: class overlap grows as the
formant gaps shrink toward the per-utterance formant jitter, the noise
floor rises, and `shortcut_amp` > 0 plants weakly class-modulated high-band
energy (non-robust features in the sense of Ilyas et al. 2019) that an
unconstrained net can aggregate with large weights and a norm-bounded net
cannot. `make_speaker_corpus` writes 20 synthetic voices (an f0 and a
three-formant envelope each) in the speaker-task layout. `flip_labels`
flips a fraction of labels to a uniformly drawn wrong class.

Everything here is numpy; nothing runs at import time.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils import audio_io

WORDS = ["zero", "one", "two", "three", "four",
         "five", "six", "seven", "eight", "nine"]


def make_hard_corpus(
    root: str,
    n_classes: int = 10,
    files_per_class: int = 40,
    f1_gap: float = 25.0,
    f1_jitter: float = 18.0,
    f2_gap: float = 45.0,
    f2_jitter: float = 30.0,
    noise_floor: float = 0.18,
    seed: int = 0,
    sr: int = 16000,
    pitch_lo: float = 0.92,
    pitch_hi: float = 1.1,
    shortcut_amp: float = 0.0,
    shortcut_eta: float = 0.35,
    shortcut_bands: int = 16,
) -> str:
    """Write a <root>/data/<word>/*.wav corpus (digit-task layout,
    `Voice digit recogniton/extract_features_construct_dataset.py:21-37`).

    Class wi lives at f1 = 300 + f1_gap*wi, f2 = 950 + f2_gap*(wi%5) +
    220*(wi//5); each utterance jitters both formants by N(0, jitter) —
    when jitter ~ gap, neighboring classes overlap and the Bayes margin is
    genuinely small. NOTE: pitch multiplies the formant frequencies, so wide
    (pitch_lo, pitch_hi) ranges swamp small gaps at high f1 — keep the range
    tight when the formants are meant to be learnable.

    `shortcut_amp` > 0 plants NON-ROBUST FEATURES (Ilyas et al. 2019, "
    Adversarial Examples Are Not Bugs, They Are Features"): `shortcut_bands`
    narrow noise bands in 3.5-7 kHz whose per-band energy is weakly
    class-modulated, energy_k = amp*(1 + eta*s_k(class)) with a random
    balanced sign signature s per class and per-utterance lognormal energy
    jitter. Each band alone is barely informative (sub-sigma separation in
    standardized MFCC units), but aggregating all of them with LARGE weights
    separates classes perfectly — exactly the brittle shortcut a
    Lipschitz-unconstrained net takes and a constrained net cannot (the
    required gain exceeds its operator-norm budget). Small input noise
    destroys the band signal while leaving the formants intact, which is the
    regime where the thesis's constrained-more-robust ordering
    (`Voice digit recogniton/attacks.py:359-366`) must appear.
    """
    rng = np.random.default_rng(seed)
    t = np.arange(sr) / sr
    # class band signatures: balanced +-1, fixed given seed
    sig_rng = np.random.default_rng(seed + 1000)
    half = shortcut_bands // 2
    signatures = np.stack([
        sig_rng.permutation(
            np.concatenate([np.ones(half), -np.ones(shortcut_bands - half)])
        )
        for _ in range(n_classes)
    ])
    band_lo = np.linspace(3500.0, 7000.0, shortcut_bands + 1)[:-1]
    band_w = (7000.0 - 3500.0) / shortcut_bands
    for wi, w in enumerate(WORDS[:n_classes]):
        d = os.path.join(root, "data", w)
        os.makedirs(d, exist_ok=True)
        f1c = 300.0 + f1_gap * wi
        f2c = 950.0 + f2_gap * (wi % 5) + 220.0 * (wi // 5)
        for i in range(files_per_class):
            f1 = f1c + rng.normal(0, f1_jitter)
            f2 = f2c + rng.normal(0, f2_jitter)
            pitch = rng.uniform(pitch_lo, pitch_hi)
            env = np.minimum(1.0, 8 * t) * np.minimum(1.0, 8 * (1 - t))
            y = 0.45 * np.sin(2 * np.pi * f1 * pitch * t)
            y += 0.3 * np.sin(2 * np.pi * f2 * pitch * t)
            y += 0.12 * np.sin(2 * np.pi * 2 * f1 * pitch * t)
            if shortcut_amp > 0:
                # 6 random-phase tones per band ~ narrowband noise
                fk = (band_lo[:, None]
                      + rng.uniform(0, band_w, (shortcut_bands, 6)))
                ph = rng.uniform(0, 2 * np.pi, (shortcut_bands, 6))
                band = np.sin(
                    2 * np.pi * fk[..., None] * t + ph[..., None]
                ).sum(1) / np.sqrt(6)  # (bands, t)
                amp_k = shortcut_amp * (
                    1.0 + shortcut_eta * signatures[wi]
                ) * rng.lognormal(0.0, 0.25, shortcut_bands)
                y = y + amp_k @ band
            y = y * env + noise_floor * rng.standard_normal(sr)
            y *= rng.uniform(0.55, 1.0)
            audio_io.write_wav(os.path.join(d, f"{i}.wav"),
                               y.astype(np.float32), sr)
    return os.path.join(root, "data")


def make_speaker_corpus(
    root: str,
    n_speakers: int = 20,
    recordings: int = 30,
    duration_s: float = 4.0,
    f0_gap: float = 8.0,
    f0_jitter: float = 3.0,
    formant_jitter: float = 0.04,
    noise_lo: float = 0.03,
    noise_hi: float = 0.12,
    seed: int = 0,
    sr: int = 16000,
) -> str:
    """Synthetic 20-speaker corpus, RoDigits layout `dataset/<speaker>/*.wav`
    (`Speaker recognition/extract_features_construct_dataset.py:116-133`).

    Each speaker is a voice: an f0 (pitch) near 90 + f0_gap*si Hz and a
    speaker-specific vocal-tract envelope (three formant bands drawn once
    per speaker). A recording is a harmonic series under that envelope with
    per-recording pitch drift, formant jitter (multiplicative, so speakers
    genuinely overlap), a random noise level in [noise_lo, noise_hi], and
    amplitude wobble — enough recording-to-recording variation that an
    unregularized interpolating model (the reference's plain speaker MLP,
    `SR/train_no_constraints.py:52-75`) must extrapolate at test time."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(duration_s * sr)) / sr
    for si in range(n_speakers):
        d = os.path.join(root, "data", f"speaker{si:02d}")
        os.makedirs(d, exist_ok=True)
        f0_base = 90.0 + f0_gap * si
        sp_rng = np.random.default_rng(seed + 7000 + si)
        formants = np.array([
            sp_rng.uniform(350, 850),
            sp_rng.uniform(900, 1900),
            sp_rng.uniform(2000, 3200),
        ])
        bws = sp_rng.uniform(80, 160, 3)
        for ri in range(recordings):
            f0 = f0_base + rng.normal(0, f0_jitter)
            fmt = formants * (1 + rng.normal(0, formant_jitter, 3))
            drift = 1.0 + 0.01 * np.sin(
                2 * np.pi * rng.uniform(0.2, 0.5) * t
                + rng.uniform(0, 2 * np.pi)
            )
            y = np.zeros_like(t)
            n_harm = int(3400 // f0)
            for h in range(1, n_harm + 1):
                fh = h * f0
                gain = np.sum(
                    np.exp(-0.5 * ((fh - fmt) / bws) ** 2)
                ) + 0.05
                gain /= h ** 0.5
                y += gain * np.sin(
                    2 * np.pi * fh * np.cumsum(drift) / sr
                    + rng.uniform(0, 2 * np.pi)
                )
            y /= np.max(np.abs(y)) + 1e-9
            wob = 1.0 + 0.25 * np.sin(
                2 * np.pi * rng.uniform(1.5, 4.0) * t
                + rng.uniform(0, 2 * np.pi)
            )
            y = y * wob * rng.uniform(0.5, 1.0)
            y += rng.uniform(noise_lo, noise_hi) * rng.standard_normal(len(t))
            audio_io.write_wav(os.path.join(d, f"{ri}.wav"),
                               y.astype(np.float32), sr)
    return os.path.join(root, "data")


def flip_labels(labels: np.ndarray, frac: float, n_classes: int,
                seed: int = 0) -> np.ndarray:
    """Flip `frac` of labels to a uniformly-drawn WRONG class."""
    if frac <= 0:
        return labels
    rng = np.random.default_rng(seed + 1)
    labels = labels.copy()
    idx = rng.random(len(labels)) < frac
    shift = rng.integers(1, n_classes, idx.sum())
    labels[idx] = (labels[idx] + shift) % n_classes
    return labels
