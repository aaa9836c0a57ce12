"""Attacks: black-box noise families, white-box gradient attacks, the
robustness sweeps (`attacks.sweeps`) and the dolphin generator
(`attacks.dolphin`). The export list is the JAX package's."""

from .blackbox import (  # noqa: F401
    add_noise,
    add_noise_mixture_on_dataset,
    add_snr_noise_on_dataset,
    add_white_noise,
    add_white_noise_on_dataset,
    add_white_noise_with_snr,
    audio_noise_features,
    audio_noise_features_sliced,
    mixtgauss,
)
from .whitebox import (  # noqa: F401
    carlini_l2,
    carlini_linf,
    fgsm,
    jsma,
    pgd,
)
