"""Everything a run feeds the program, made from its seed: the utterances
of the two tasks, the models' initial weights, and the order and sizes of
the served requests. The same seed gives the same inputs on the same
device; every seed gives the same amount of work."""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["derive", "digit_waves", "voice_waves", "init_params",
           "request_sizes"]


def derive(seed: int, *words: int) -> int:
    """A 63-bit seed from `seed` and integer words (numpy's SeedSequence)."""
    state = np.random.SeedSequence([int(seed), *map(int, words)])
    return int(state.generate_state(2, np.uint32) @ [1 << 31, 1])


def _gen(device, seed: int, *words: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *words))


def digit_waves(labels, seed: int, device, width: int = 22050,
                sr: int = 22050) -> torch.Tensor:
    """Seeded 1-s utterances made on `device`: one 0.3-0.5 s voiced burst
    (sin^2 onset and offset, anywhere in the second) whose class sets both
    the pitch, a glide around 300 * 1.25**c Hz with a random slope of +-30 %
    over the second, and the timbre, the harmonic (1..5) that carries most
    energy; random loudness within 6 dB, in low noise of a random level."""
    g = _gen(device, seed)
    n = len(labels)
    lab = torch.as_tensor(labels, device=device).float()[:, None]

    def uni(lo, hi):
        return lo + (hi - lo) * torch.rand((n, 1), generator=g, device=device)

    t = torch.arange(width, device=device)[None, :] / float(sr)
    f0 = 300.0 * 1.25 ** lab * uni(0.97, 1.03)
    slope = uni(-0.3, 0.3)
    phase = 2 * np.pi * f0 * (t + 0.5 * slope * (t * t - t)) + uni(0, 6.3)
    k = torch.arange(1, 7, device=device).float()[None, :, None]
    weight = torch.exp(-((k - 1 - (lab[:, :, None] % 5)) ** 2) / 2.0)
    tone = (weight * torch.sin(k * phase[:, None, :])).sum(1)
    on, dur = uni(0.05, 0.45), uni(0.3, 0.5)
    env = torch.sin(np.pi * ((t - on) / dur).clamp(0.0, 1.0)) ** 2
    noise = uni(1e-3, 5e-3) * torch.randn((n, width), generator=g,
                                          device=device)
    return uni(0.2, 0.4) * env * tone + noise


def voice_waves(labels, seed: int, device, width: int = 22050,
                sr: int = 22050, n_speakers: int = 20) -> torch.Tensor:
    """Seeded one-second windows of synthetic voices made on `device`: a
    speaker is an f0 near 90 + 8 * speaker Hz and a vocal-tract envelope of
    three formant bands drawn once per speaker from the seed; a window is the
    harmonic series below 3.4 kHz under that envelope, with per-window pitch
    jitter and drift, formant jitter of 4 %, amplitude wobble and noise of a
    random level in [0.03, 0.12] (the voices of the repo's speaker corpus)."""
    g_spk = _gen(device, seed, 1)
    g = _gen(device, seed, 2)
    n = len(labels)
    lab = torch.as_tensor(labels, device=device).long()

    def uni(shape, lo, hi, gen=g):
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           device=device)

    lo = torch.tensor([350.0, 900.0, 2000.0], device=device)
    hi = torch.tensor([850.0, 1900.0, 3200.0], device=device)
    formants = lo + (hi - lo) * torch.rand((n_speakers, 3), generator=g_spk,
                                           device=device)
    bws = uni((n_speakers, 3), 80.0, 160.0, g_spk)
    f0 = 90.0 + 8.0 * lab.float()[:, None] + 3.0 * torch.randn(
        (n, 1), generator=g, device=device)
    fmt = formants[lab] * (1 + 0.04 * torch.randn((n, 3), generator=g,
                                                  device=device))
    t = torch.arange(width, device=device)[None, :] / float(sr)
    drift = 1.0 + 0.01 * torch.sin(2 * np.pi * uni((n, 1), 0.2, 0.5) * t
                                   + uni((n, 1), 0.0, 2 * np.pi))
    phase = 2 * np.pi * f0 * torch.cumsum(drift, 1) / sr
    y = torch.zeros((n, width), device=device)
    for h in range(1, int(3400 // 80) + 1):
        fh = h * f0
        gain = torch.exp(-0.5 * ((fh - fmt) / bws[lab]) ** 2).sum(
            1, keepdim=True) + 0.05
        gain = gain / math.sqrt(h) * (fh <= 3400.0)
        y += gain * torch.sin(h * phase + uni((n, 1), 0.0, 2 * np.pi))
    y = y / (y.abs().amax(1, keepdim=True) + 1e-9)
    wob = 1.0 + 0.25 * torch.sin(2 * np.pi * uni((n, 1), 1.5, 4.0) * t
                                 + uni((n, 1), 0.0, 2 * np.pi))
    noise = uni((n, 1), 0.03, 0.12) * torch.randn((n, width), generator=g,
                                                  device=device)
    return 0.5 * y * wob + noise


def init_params(dims, batch_norm: bool, seed: int, device):
    """Keras' initial state of the stack `dims`, drawn on `device` in one
    call a layer: glorot-uniform kernels, zero biases, BN gamma 1, beta 0,
    running mean 0 and variance 1. -> (params, state) as lists of dicts."""
    g = _gen(device, seed)
    params, state = [], []
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        limit = math.sqrt(6.0 / (a + b))
        p = {"w": (torch.rand((a, b), generator=g, device=device) * 2 - 1)
             * limit, "b": torch.zeros(b, device=device)}
        s = {}
        if batch_norm and i < len(dims) - 2:
            p["gamma"] = torch.ones(b, device=device)
            p["beta"] = torch.zeros(b, device=device)
            s = {"mean": torch.zeros(b, device=device),
                 "var": torch.ones(b, device=device)}
        params.append(p)
        state.append(s)
    return params, state


def request_sizes(lo: int, hi: int, block: int, seed: int):
    """An endless stream of request sizes, log-uniform in [lo, hi]: each
    block of `block` requests holds the same sizes (the block's quantiles),
    in an order drawn from the seed, so every seed sends the same work."""
    q = (np.arange(block) + 0.5) / block
    sizes = np.rint(lo * (hi / lo) ** q).astype(np.int64)
    rng = np.random.default_rng(derive(seed, 7))
    while True:
        yield from rng.permutation(sizes).tolist()
