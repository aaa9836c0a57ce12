"""Robustness sweep runner: accuracy-vs-strength curves for model pairs.

Counterpart of the JAX package's `attacks/sweeps.py`, the non-interactive
replacement for the reference's `input()`-driven attack script
(`Voice digit recogniton/attacks.py:297-693`). Each sweep evaluates the
constrained and the unconstrained model on the same perturbed test set per
strength point and returns the two accuracy curves, the thesis's comparison
artifact (`:359-366`).

Default grids are the reference's (SURVEY.md §2.2):
  audio sigmas   [0, 0.002, ..., 0.1]            (`:335`)
  mfcc sigmas    linspace(0, 100, 20)            (`:320`)
  mixture alphas linspace(0, 0.015, 15) audio / linspace(0, 100, 30) mfcc
  SNRs           [60, 30, 20, 15, 10, 5, 0] dB   (`:319`)
  fgsm eps       linspace(0.01, 0.3, 10) std, linspace(1, 30, 50) raw
  pgd eps        linspace(1, 30, 50)             (`:648`)

Randomness: sweep point i of a sweep with `seed` draws everything from its
own generator, `point_generator(seed, i, device)`, seeded with the first
64-bit word of numpy's SeedSequence((seed, i)), a hash of the pair (the
counterpart of JAX's fold_in(PRNGKey(seed), i); the CPU generator keeps
only a seed's low 32 bits, so they must differ too). The CUDA and CPU
generators are different streams, so the same seed gives other draws on
the card than on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..frontend.mfcc import Frontend, to_float_waves
from ..ops.mfcc_torch import FrontendConfig
from ..utils.device import resolve_device
from . import blackbox, whitebox

__all__ = ["SweepResult", "GRIDS", "blackbox_sweep", "whitebox_sweep",
           "fused_audio_sweep", "accuracy", "point_generator"]

GRIDS = {
    "audio_sigmas": [0, 0.002, 0.004, 0.01, 0.015, 0.02, 0.03, 0.04, 0.05, 0.075, 0.1],
    "mfcc_sigmas": np.linspace(0, 100, 20),
    "audio_alphas": np.linspace(0, 0.015, 15),
    "mfcc_alphas": np.linspace(0, 100, 30),
    "snrs_db": [60, 30, 20, 15, 10, 5, 0],
    # speaker-task variants (`Speaker recognition/attacks.py:319-322,336`)
    "snrs_db_speaker": [60, 50, 40, 30, 20, 15, 10, 5, 0],
    "audio_alphas_speaker": np.linspace(0, 0.2, 20),
    "audio_sigmas_speaker": np.linspace(0, 0.005, 10),
    # the FGSM grid depends on what the attack sees (`VD/attacks.py:497-499`):
    # standardized unit-variance features take eps 0.01-0.3, raw dB-scale
    # MFCCs (standardize-after mode) eps 1-30
    "fgsm_eps_std": np.linspace(0.01, 0.3, 10),
    "fgsm_eps_raw": np.linspace(1, 30, 50),
    "pgd_eps": np.linspace(1, 30, 50),
    "jsma_theta": [10.0],
    "cw_l2_confidence": np.linspace(1, 300, 3),
    "cw_linf_confidence": [10.0],
}

_AUDIO_GRIDS = {"white_audio": "audio_sigmas", "mixture_audio": "audio_alphas",
                "snr_audio": "snrs_db"}


def _audio_kw(attack: str, s: float, mixture_p: float) -> dict:
    """The noise strengths of an audio attack at strength s."""
    return {"white_audio": dict(sigma=s),
            "mixture_audio": dict(p=mixture_p, alpha=s),
            "snr_audio": dict(snr_db=s)}[attack]


def point_generator(seed: int, i: int, device) -> torch.Generator:
    """Sweep point i's generator on `device`, seeded with the first word of
    SeedSequence((seed, i)).generate_state(1, uint64)."""
    word = np.random.SeedSequence((int(seed), int(i))).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(word))


@dataclasses.dataclass
class SweepResult:
    attack: str
    strengths: np.ndarray
    accuracy_constrained: np.ndarray
    accuracy_unconstrained: np.ndarray

    def as_dict(self):
        return {
            "attack": self.attack,
            "strengths": np.asarray(self.strengths).tolist(),
            "accuracy_constrained": self.accuracy_constrained.tolist(),
            "accuracy_unconstrained": self.accuracy_unconstrained.tolist(),
        }

    def plot(self, ax=None, title=None):
        """The reference's comparison plot (`attacks.py:359-366`); needs
        matplotlib."""
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots()
        ax.plot(self.strengths, self.accuracy_constrained, color="r",
                label="Constrained Model")
        ax.plot(self.strengths, self.accuracy_unconstrained, color="b",
                label="Unconstrained model")
        ax.legend()
        ax.set_title(title or f"Accuracy vs {self.attack}")
        ax.set_xlabel("Strength")
        ax.set_ylabel("Accuracy")
        return ax


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def accuracy(probs, labels) -> float:
    """argmax-match accuracy (`attacks.py:347-357`); arrays or tensors."""
    return float(np.mean(np.argmax(_numpy(probs), axis=1) == _numpy(labels)))


def _result(attack, strengths, acc_c, acc_u) -> SweepResult:
    return SweepResult(attack, np.asarray(strengths), np.asarray(acc_c),
                       np.asarray(acc_u))


def blackbox_sweep(
    attack: str,
    predict_constrained: Callable,
    predict_unconstrained: Callable,
    labels,
    strengths=None,
    test_features=None,
    test_waves=None,
    test_waves_list=None,
    lengths=None,
    frontend_cfg: FrontendConfig | None = None,
    standardize: Callable | None = None,
    seed: int = 0,
    mixture_p: float = 0.01,
    backend: str = "cuda",
    device=None,
) -> SweepResult:
    """Run one black-box family sweep on `device` (None: the card).

    attack: 'white_mfcc' | 'mixture_mfcc' | 'white_audio' | 'mixture_audio'
            | 'snr_audio' (the reference's s/m/snr x mfcc/audio matrix).
    The predicts take float32 numpy features and return probabilities.
    `standardize` receives the perturbed features (numpy) and applies the
    reference's fit-on-all scaler when the pipeline standardizes after the
    attack (`attacks.py:342,437-438`). Audio variants need test_waves (or
    test_waves_list) and frontend_cfg; their frontend is `backend`.

    Speaker-task audio variants pass `test_waves_list` (variable-length
    recordings) instead of `test_waves`: each recording is noised whole,
    then sliced into 1-s windows and MFCC'd, labels replicated per window
    (`Speaker recognition/attacks.py:97-146`); `labels` are then per
    recording.
    """
    dev = resolve_device(device)
    if strengths is None:
        strengths = GRIDS[{"white_mfcc": "mfcc_sigmas",
                           "mixture_mfcc": "mfcc_alphas",
                           **_AUDIO_GRIDS}[attack]]
    acc_c, acc_u = [], []
    for i, s in enumerate(np.asarray(strengths)):
        g = point_generator(seed, i, dev)
        s = float(s)
        point_labels = labels
        if attack in _AUDIO_GRIDS and test_waves_list is not None:
            feats, point_labels = blackbox.audio_noise_features_sliced(
                test_waves_list, labels, frontend_cfg, g, backend=backend,
                device=dev, **_audio_kw(attack, s, mixture_p))
        elif attack in _AUDIO_GRIDS:
            feats = blackbox.audio_noise_features(
                test_waves, frontend_cfg, g, lengths=lengths,
                backend=backend, device=dev, **_audio_kw(attack, s, mixture_p))
        elif attack == "white_mfcc":
            feats = _numpy(blackbox.add_white_noise_on_dataset(
                test_features, s, g))
        elif attack == "mixture_mfcc":
            feats = _numpy(blackbox.add_noise_mixture_on_dataset(
                test_features, mixture_p, s, g))
        else:
            raise ValueError(f"unknown blackbox attack {attack!r}")
        if standardize is not None:
            feats = standardize(feats)
        acc_c.append(accuracy(predict_constrained(feats), point_labels))
        acc_u.append(accuracy(predict_unconstrained(feats), point_labels))
    return _result(attack, strengths, acc_c, acc_u)


def _moments(a: torch.Tensor):
    """(count, mean, sum of squared deviations) of the rows, float64."""
    mu = torch.mean(a, dim=0)
    return a.shape[0], mu, torch.sum(torch.square(a - mu), dim=0)


def refit_standardize(feats: torch.Tensor, n1: int, mu1: torch.Tensor,
                      m21: torch.Tensor) -> torch.Tensor:
    """`data/pipeline.py::standardize_fit_all` of `feats` on [train; dev;
    feats], from the train+dev rows' moments (n1, mu1, m21) and the
    feats' own, combined by Chan's parallel update, in float64: sklearn's
    StandardScaler (ddof 0; a constant feature keeps scale 1). Returns
    float32."""
    n2, mu2, m22 = _moments(feats.double())
    n = n1 + n2
    delta = mu2 - mu1
    mu = mu1 + delta * (n2 / n)
    sd = torch.sqrt((m21 + m22 + torch.square(delta) * (n1 * n2 / n)) / n)
    sd = torch.where(sd == 0.0, 1.0, sd)
    return ((feats.double() - mu) / sd).float()


def fused_audio_sweep(
    attack: str,
    logits_constrained: Callable,
    logits_unconstrained: Callable,
    labels,
    test_waves,
    frontend_cfg: FrontendConfig,
    lengths=None,
    strengths=None,
    refit_arrays=None,
    seed: int = 0,
    mixture_p: float = 0.01,
    backend: str = "cuda",
    device=None,
) -> SweepResult:
    """Audio-domain sweep kept on the device: per point noise -> MFCC
    (`Frontend(frontend_cfg, backend)`, K1 on the card) -> the per-point
    scaler refit -> both models' logits -> two accuracies; only those two
    scalars cross to the host. The reference re-runs librosa per file per
    point (`VD/attacks.py:124-142`).

    `refit_arrays` = (train, dev) feature arrays for the reference's
    per-point refit on [train; dev; perturbed test] (`attacks.py:341-343,
    437-438`): their moments are reduced once, and each point combines
    them with its own (`refit_standardize`). None skips standardizing.
    `logits_*` take float32 (B, n_mfcc * T) tensors on `device` (None: the
    card). At strength 0 the white and mixture sweeps run the clean path;
    SNR sweeps always add noise.
    """
    dev = resolve_device(device)
    if strengths is None:
        strengths = GRIDS[_AUDIO_GRIDS[attack]]
    fe = Frontend(frontend_cfg, backend=backend, device=dev)
    waves = to_float_waves(np.asarray(test_waves, np.float32), dev)
    labs = torch.as_tensor(np.asarray(labels), dtype=torch.int64,
                           device=dev)
    lens = (None if lengths is None else torch.as_tensor(
        np.asarray(lengths), dtype=torch.int64, device=dev))
    if refit_arrays is not None:
        td = np.concatenate([np.asarray(a, np.float64)
                             for a in refit_arrays], 0)
        n1, mu1, m21 = _moments(torch.from_numpy(td).to(dev))
    acc_c, acc_u = [], []
    for i, s in enumerate(np.asarray(strengths)):
        kw = _audio_kw(attack, float(s), mixture_p)
        kind = blackbox.noise_kind(**kw)
        g = point_generator(seed, i, dev)
        with torch.no_grad():
            noisy = blackbox.apply_noise(
                kind, waves, blackbox.unit_draws(kind, waves.shape, g),
                lengths=lens, **kw)
            feats = fe.flat(noisy, lengths=lens)
            if refit_arrays is not None:
                feats = refit_standardize(feats, n1, mu1, m21)
            pair = torch.stack([
                torch.mean((torch.argmax(lf(feats), -1) == labs).double())
                for lf in (logits_constrained, logits_unconstrained)])
        ac, au = pair.tolist()
        acc_c.append(ac)
        acc_u.append(au)
    return _result(attack, strengths, acc_c, acc_u)


def whitebox_sweep(
    attack: str,
    logits_constrained: Callable,
    logits_unconstrained: Callable,
    predict_constrained: Callable,
    predict_unconstrained: Callable,
    test_features,
    labels,
    strengths=None,
    standardize: Callable | None = None,
    max_samples: int | None = None,
    seed: int = 0,
    label_source: str = "predicted",
    device=None,
) -> SweepResult:
    """Run one white-box sweep on `device` (None: the card).
    attack: 'fgsm' | 'pgd' | 'jsma' | 'cw_l2' | 'cw_linf'.

    Adversarial examples are made against each model separately (the
    reference attacks each wrapped classifier with its own gradients,
    `attacks.py:506-510`). JSMA evaluates the first 100 samples like the
    reference (`:549-550`) unless max_samples says otherwise.
    `logits_*` take float32 tensors on `device`; the predicts take numpy
    (standardized when `standardize` is given) and return probabilities.

    label_source='predicted' (default) is ART's behavior when generate() is
    called without y, as the reference does (`:509-510`): each attack uses
    its model's own predictions as labels; 'true' uses the ground truth.
    Accuracy is always against the true labels. JSMA is targeted, with
    random targets drawn from the point's generator, so 'true' does not
    apply to it and raises.
    """
    dev = resolve_device(device)
    if attack == "jsma" and label_source == "true":
        raise ValueError(
            "label_source='true' does not apply to jsma (targeted attack "
            "with ART's random-target untargeted semantics)")
    if attack == "jsma" and max_samples is None:
        max_samples = 100
    x = to_float_waves(np.asarray(_numpy(test_features), np.float32), dev)
    y = torch.as_tensor(_numpy(labels), dtype=torch.int64, device=dev)
    if max_samples is not None:
        x, y = x[:max_samples], y[:max_samples]
    if strengths is None:
        strengths = GRIDS[{"fgsm": "fgsm_eps_std", "pgd": "pgd_eps",
                           "jsma": "jsma_theta", "cw_l2": "cw_l2_confidence",
                           "cw_linf": "cw_linf_confidence"}[attack]]
    gen = {
        "fgsm": lambda lf, ya, s, g: whitebox.fgsm(lf, x, ya, s),
        "pgd": lambda lf, ya, s, g: whitebox.pgd(lf, x, ya, s),
        "jsma": lambda lf, ya, s, g: whitebox.jsma(lf, x, theta=s,
                                                   generator=g),
        "cw_l2": lambda lf, ya, s, g: whitebox.carlini_l2(
            lf, x, ya, confidence=s),
        "cw_linf": lambda lf, ya, s, g: whitebox.carlini_linf(
            lf, x, ya, confidence=s),
    }[attack]

    def attack_labels(lf):
        if label_source == "true":
            return y
        with torch.no_grad():
            return torch.argmax(lf(x), -1)

    y_att = [attack_labels(logits_constrained),
             attack_labels(logits_unconstrained)]
    ynp = _numpy(y)
    acc_c, acc_u = [], []
    for i, s in enumerate(np.asarray(strengths)):
        advs = []
        for lf, ya in zip((logits_constrained, logits_unconstrained), y_att):
            # each model's attack starts from the point's own generator, as
            # both JAX calls take the point's key
            adv = _numpy(gen(lf, ya, float(s), point_generator(seed, i, dev)))
            advs.append(standardize(adv) if standardize is not None else adv)
        acc_c.append(accuracy(predict_constrained(advs[0]), ynp))
        acc_u.append(accuracy(predict_unconstrained(advs[1]), ynp))
    return _result(attack, strengths, acc_c, acc_u)
