"""Black-box noise attacks: white, Gaussian-mixture impulse, SNR-targeted.

Counterpart of the JAX package's `attacks/blackbox.py` (the reference's
`Voice digit recogniton/attacks.py:73-294`). Each noise family is a pure
function of the input and its unit normal draws (`white_noise`,
`mixture_noise`, `snr_noise`, and `apply_noise` for the audio attack's
branch rule); the public functions are thin wrappers that draw those units
from an explicit `torch.Generator` on the input's device, so a test can
feed the same draws to both packages.

A whole noisy batch goes through the frontend in one call: on the card the
audio forms run K1 (`Frontend(cfg, backend="cuda")`), on a CPU tensor its
plain twin.
"""

from __future__ import annotations

import numbers

import numpy as np
import torch

from ..frontend.mfcc import Frontend, to_float_waves
from ..ops.mfcc_torch import FrontendConfig
from ..utils.device import resolve_device

__all__ = [
    "add_white_noise",
    "mixtgauss",
    "add_noise",
    "add_white_noise_with_snr",
    "add_white_noise_on_dataset",
    "add_noise_mixture_on_dataset",
    "add_snr_noise_on_dataset",
    "audio_noise_features",
    "audio_noise_features_sliced",
]


def _randn(shape, generator: torch.Generator) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=generator,
                       device=generator.device, dtype=torch.float32)


# -- pure noise families: input and unit draws in, noisy input out ------------

def white_noise(x: torch.Tensor, sigma, z: torch.Tensor) -> torch.Tensor:
    """x + sigma * z."""
    return x + sigma * z


def mixture_noise(p, sigma0, sigma1, q: torch.Tensor,
                  z: torch.Tensor) -> torch.Tensor:
    """The mixture's noise from its two unit draws: an impulse where
    |q| < p; sigma1 at impulses, sigma0 elsewhere, times z."""
    u = (torch.abs(q) < p).to(z.dtype)
    return (sigma0 * (1.0 - u) + sigma1 * u) * z


def snr_noise(audio: torch.Tensor, target_snr_db, z: torch.Tensor,
              lengths: torch.Tensor | None = None) -> torch.Tensor:
    """audio + white noise at `target_snr_db` below the mean signal power of
    each row of (..., N) (k = 1: no signal renormalization).

    `lengths` (...) marks each row's true sample count in a zero-padded
    batch: the power is averaged over those samples only, divided by
    max(length, 1), and the noise is zero past them."""
    if lengths is None:
        power = torch.mean(audio ** 2, dim=-1, keepdim=True)
        mask = None
    else:
        lengths = lengths.to(audio.device)[..., None]
        idx = torch.arange(audio.shape[-1], device=audio.device)
        mask = (idx < lengths).to(audio.dtype)
        power = torch.sum((audio * mask) ** 2, dim=-1, keepdim=True) \
            / torch.clamp(lengths, min=1)
    signal_db = 10.0 * torch.log10(power)
    noise_watts = torch.pow(10.0, (signal_db - target_snr_db) / 10.0)
    noise = torch.sqrt(noise_watts) * z
    if mask is not None:
        noise = noise * mask
    return audio + noise


# -- the same families drawing from a generator --------------------------------

def add_white_noise(x: torch.Tensor, sigma, generator) -> torch.Tensor:
    """x + N(0, sigma^2), elementwise (`attacks.py:73-86`)."""
    return white_noise(x, sigma, _randn(x.shape, generator))


def mixtgauss(shape, p, sigma0, sigma1, generator) -> torch.Tensor:
    """Gaussian mixture noise (`attacks.py:145-162`): impulse locations are
    where |N(0,1)| < p; sigma1 at impulses, sigma0 elsewhere, times an
    independent N(0,1) draw (drawn second)."""
    q = _randn(shape, generator)
    return mixture_noise(p, sigma0, sigma1, q, _randn(shape, generator))


def add_noise(x: torch.Tensor, p, alpha, generator) -> torch.Tensor:
    """Mixture noise with sigma0 = alpha, sigma1 = 10 alpha
    (`attacks.py:165-183`)."""
    return x + mixtgauss(x.shape, p, alpha, 10.0 * alpha, generator)


def add_white_noise_with_snr(audio: torch.Tensor, target_snr_db, generator,
                             length=None) -> torch.Tensor:
    """White noise at a target SNR (dB) relative to the mean signal power
    (`attacks.py:222-245`); see `snr_noise` for `length`."""
    if length is not None:
        length = torch.as_tensor(length, device=audio.device)
    return snr_noise(audio, target_snr_db, _randn(audio.shape, generator),
                     length)


def _dataset(a, generator) -> torch.Tensor:
    return to_float_waves(a, generator.device)


def add_white_noise_on_dataset(dataset, sigma, generator) -> torch.Tensor:
    """White noise directly on MFCC features (`attacks.py:186-201`), on the
    generator's device."""
    return add_white_noise(_dataset(dataset, generator), sigma, generator)


def add_noise_mixture_on_dataset(dataset, p, alpha, generator):
    """Mixture noise on MFCC features (`attacks.py:204-219`)."""
    return add_noise(_dataset(dataset, generator), p, alpha, generator)


def add_snr_noise_on_dataset(waves, target_snr_db, generator, lengths=None):
    """`add_white_noise_with_snr` on every row of a (B, N) batch, each at
    its own signal power (and true length)."""
    waves = _dataset(waves, generator)
    if lengths is not None:
        lengths = torch.as_tensor(np.asarray(lengths), device=waves.device)
    return snr_noise(waves, target_snr_db, _randn(waves.shape, generator),
                     lengths)


# -- the audio attack's noise stage ---------------------------------------------

def _on(v) -> bool:
    """A strength is off when it is None or any static numeric zero (int 0
    and numpy zeros included); a tensor always counts as on."""
    return v is not None and not (
        isinstance(v, numbers.Number) and float(v) == 0.0)


def noise_kind(sigma=0.0, p=0.0, alpha=0.0, snr_db=None) -> str:
    """The reference's branch rule (`attacks.py:105-111`, `:277-294`): sigma
    wins; else the mixture, which needs both p and alpha on (alpha alone is
    clean audio, not white noise); else SNR if given; else clean."""
    if _on(sigma):
        return "white"
    if _on(alpha) and _on(p):
        return "mixture"
    if snr_db is not None:
        return "snr"
    return "clean"


def unit_draws(kind: str, shape, generator) -> tuple:
    """The unit normals `apply_noise` takes for `kind`, in draw order."""
    n = {"white": 1, "mixture": 2, "snr": 1, "clean": 0}[kind]
    return tuple(_randn(shape, generator) for _ in range(n))


def apply_noise(kind: str, waves: torch.Tensor, draws: tuple, sigma=0.0,
                p=0.0, alpha=0.0, snr_db=None,
                lengths: torch.Tensor | None = None) -> torch.Tensor:
    """The pure noise stage of the audio attack. White and mixture noise
    are zeroed past each row's length (noise past the true end would leak
    into the last valid frames' analysis windows); SNR masks internally."""
    if kind == "white":
        noisy = white_noise(waves, sigma, draws[0])
    elif kind == "mixture":
        noisy = waves + mixture_noise(p, alpha, 10.0 * alpha, *draws)
    elif kind == "snr":
        return snr_noise(waves, snr_db, draws[0], lengths)
    else:
        return waves
    if lengths is not None:
        idx = torch.arange(waves.shape[-1], device=waves.device)
        noisy = torch.where(idx[None, :] < lengths[:, None], noisy, 0.0)
    return noisy


def noisy_waves(waves, generator, sigma=0.0, p=0.0, alpha=0.0, snr_db=None,
                lengths=None) -> torch.Tensor:
    """Noise stage of the audio attack on a (B, N) batch, on the
    generator's device: `noise_kind` picks the family, `unit_draws` draws
    its units, `apply_noise` applies them."""
    waves = _dataset(waves, generator)
    if lengths is not None:
        lengths = torch.as_tensor(np.asarray(lengths), dtype=torch.int64,
                                  device=waves.device)
    kind = noise_kind(sigma, p, alpha, snr_db)
    return apply_noise(kind, waves, unit_draws(kind, waves.shape, generator),
                       sigma=sigma, p=p, alpha=alpha, snr_db=snr_db,
                       lengths=lengths)


def audio_noise_features(waves, cfg: FrontendConfig, generator, sigma=0.0,
                         p=0.0, alpha=0.0, snr_db=None, lengths=None,
                         backend: str = "cuda", device=None) -> np.ndarray:
    """Audio-domain attack: noise the raw waveforms, rerun the MFCC
    frontend, return flat features (B, n_mfcc * T) as float32 numpy; the
    batched `black_box_attack_on_audio_dataset` (`attacks.py:124-142`) and
    its SNR variant (`:277-294`). Runs on `device` (None: the card), whose
    generator `generator` must be. For the fused noise -> MFCC ->
    standardize -> predict sweep see `sweeps.fused_audio_sweep`."""
    dev = resolve_device(device)
    noisy = noisy_waves(to_float_waves(waves, dev), generator, sigma=sigma,
                        p=p, alpha=alpha, snr_db=snr_db, lengths=lengths)
    fe = Frontend(cfg, backend=backend, device=dev)
    return fe.flat(noisy, lengths=lengths).cpu().numpy()


def audio_noise_features_sliced(waves_list, labels, cfg: FrontendConfig,
                                generator, sigma=0.0, p=0.0, alpha=0.0,
                                snr_db=None, backend: str = "cuda",
                                device=None):
    """Speaker-task audio attack: noise each FULL recording first (in list
    order, one draw each from `generator`), then slice it into 1-s windows
    (first and last second dropped, `data/pipeline.py::slice_seconds`) and
    MFCC all windows in one frontend call; the reference's order
    (`Speaker recognition/attacks.py:97-146`, `:254-295`). Labels are
    replicated per window. -> (features float32 numpy, labels int64)."""
    from ..data.pipeline import slice_seconds

    dev = resolve_device(device)
    windows, out_labels = [], []
    for w, lab in zip(waves_list, np.asarray(labels)):
        w = to_float_waves(np.asarray(w, np.float32), dev)
        if sigma != 0.0:
            w = add_white_noise(w, sigma, generator)
        elif p != 0.0 and alpha != 0.0:
            w = add_noise(w, p, alpha, generator)
        elif snr_db is not None:
            w = add_white_noise_with_snr(w, snr_db, generator)
        s = slice_seconds(w.cpu().numpy(), cfg.sr)
        windows.append(s)
        out_labels.extend([lab] * len(s))
    if sum(len(s) for s in windows) == 0:
        return (np.zeros((0, cfg.feature_dim), np.float32),
                np.zeros((0,), dtype=np.int64))
    allw = np.concatenate([s for s in windows if len(s)], axis=0)
    feats = Frontend(cfg, backend=backend, device=dev).flat(allw)
    return feats.cpu().numpy(), np.asarray(out_labels, dtype=np.int64)
