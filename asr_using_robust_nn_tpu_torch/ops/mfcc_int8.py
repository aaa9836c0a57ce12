"""Int8 digit-decomposition MFCC frontend in plain PyTorch: the counterpart
of the JAX package's `ops/mfcc_int8.py`, and the arithmetic the K4 kernel
(`ops/cuda_mfcc_int8.py`, `csrc/int8_dft_power_mel.cu`) fuses.

Scheme: exact base-128 digit decomposition with power-of-two scales,

    x = d0*2^-6 + d1*2^-13 + d2*2^-20 + r,  |d_i| <= 64,  |r| <= 2^-21
    C = e0*s    + e1*s/128 + e2*s/128^2 + rc                (numpy, static)

    x @ C = sum_{(i,j)} (d_i @ e_j) * (s_i * t_j)     [int8 products, exact
                                                        int32 sums]

Every product d_i @ e_j is exact, so the only error is the dropped digit
tails. Six pairs are kept, those of weight >= 128^-2: (0,0), (0,1), (1,0),
(1,1), (0,2), (2,0). Pairs with the same digit sum i+j share one exact
power-of-two weight and so one integer sum; the three sums are converted to
fp32 and combined smallest weight first.

Each row is block-scaled by a power of two f (exact in fp32, undone exactly
on the power spectrum) so its peak lands in (0.5, 1] before digitizing:
quiet rows keep full relative accuracy and loud rows do not clip. For
int16-origin audio (PCM / 32768) the x digits are then exact. The scale's
exponent is read from the float's own exponent field (`torch.frexp`), never
from an fp32 `log2`, so a peak that is exactly a power of two (1.0, 0.5,
2^-15) always scales to 1.0.
"""

from __future__ import annotations

import numpy as np
import torch

from .mfcc_torch import (
    FrontendConfig,
    center_pad,
    device_constants,
    finish_mfcc_from_mel,
    frame_signal,
)

__all__ = ["mfcc_int8_batch", "int8_power", "KEEP_PAIRS", "digit_sum_groups"]

# digit-product pairs kept, in increasing weight order (summed small->large)
KEEP_PAIRS = ((0, 2), (2, 0), (1, 1), (0, 1), (1, 0), (0, 0))

_X_SCALES = (2.0 ** -6, 2.0 ** -13, 2.0 ** -20)


def _const_digits(c: np.ndarray) -> list[tuple[np.ndarray, float]]:
    """Base-128 int8 digits of a static f64 matrix, power-of-two scales."""
    m = float(np.max(np.abs(c)))
    e = int(np.ceil(np.log2(m))) - 6 if m > 0 else -6
    out = []
    res = c.astype(np.float64)
    for i in range(3):
        s = 2.0 ** (e - 7 * i)
        d = np.round(res / s)
        assert np.max(np.abs(d)) <= 64, "digit overflow"
        out.append((d.astype(np.int8), s))
        res = res - d * s
    return out


def _block_scale(mx: torch.Tensor) -> torch.Tensor:
    """f = 2^floor(log2(1 / mx)) per row, exactly; 1 for a silent row.

    1 / mx is the fp32 quotient the JAX package takes the log2 of; its
    exponent comes from `frexp` (r = m * 2^e, m in [0.5, 1), so
    floor(log2 r) = e - 1), and f is assembled from that exponent's bits."""
    r = 1.0 / torch.clamp(mx, min=1e-30)
    ex = torch.frexp(r)[1].to(torch.int32) - 1
    bits = (torch.clamp(ex + 127, 1, 254) << 23).to(torch.int32)
    return torch.where(mx > 0, bits.view(torch.float32),
                       torch.ones_like(mx))


def _wave_digits(y: torch.Tensor, out: torch.Tensor | None = None
                 ) -> tuple[list[torch.Tensor], torch.Tensor]:
    """Base-128 int8 digits of per-row block-scaled audio.

    Each row is multiplied by a power-of-two factor f (exact in fp32) so
    its peak lands in (0.5, 1] before digitizing. Returns (digits, f); the
    caller undoes the scaling on the power spectrum (power * f^-2), also
    exact. The DFT is linear and power_to_db's ref=max is per-utterance, so
    semantics are unchanged. `torch.round` rounds half to even, as
    `jnp.round` does. With `out` ((3, B, >= L) int8) the digits are written
    into out[:, :, :L] and the list holds those views.

    The digit scales are powers of two, so res * (1 / s) is res / s and
    res - d * s is one exact-product subtraction: the passes run in place
    and give the JAX package's digits bit for bit."""
    y = y.float()
    b, n = y.shape
    mx = torch.linalg.vector_norm(y, ord=float("inf"), dim=1, keepdim=True)
    f = _block_scale(mx)
    res = y * f
    if out is None:
        out = torch.empty((3, b, n), dtype=torch.int8, device=y.device)
    digits = []
    for i, s in enumerate(_X_SCALES):
        d = torch.mul(res, 1.0 / s).round_()
        digits.append(out[i, :, :n])
        digits[-1].copy_(d)
        if i < len(_X_SCALES) - 1:
            res.add_(d, alpha=-s)
    return digits, f[:, 0]


def digit_sum_groups(lhs_digits, c_digits):
    """Yield (int32 partials, exact weight) per digit-sum group, smallest
    weight first.

    The digit-pair weight 2^(-6-7i) * s_e*2^(-7j) depends only on i+j, so
    KEEP_PAIRS group by digit sum k into one exact integer sum each:
    sum_{i+j=k} d_i @ e_j, at most 3 * 64*64*K_contraction < 2^25 per
    entry. The products run as float64 GEMMs on the integer digits, which
    are exact below 2^53 (and run on every device; integer GEMMs do not).
    `lhs_digits` are (..., K) int8 tensors, `c_digits` the
    `_const_digits` list of (K, N) numpy digits."""
    groups: dict[int, list[tuple[int, int]]] = {}
    for i, j in KEEP_PAIRS:
        groups.setdefault(i + j, []).append((i, j))
    dev = lhs_digits[0].device
    lhs64 = [d.double() for d in lhs_digits]
    rhs64 = [torch.from_numpy(d.astype(np.float64)).to(dev)
             for d, _ in c_digits]
    for k in sorted(groups, reverse=True):
        pairs = groups[k]
        p = sum(lhs64[i] @ rhs64[j] for i, j in pairs)
        w = _X_SCALES[pairs[0][0]] * c_digits[pairs[0][1]][1]
        assert all(
            _X_SCALES[i] * c_digits[j][1] == w for i, j in pairs
        ), "digit-sum groups must share one exact power-of-two weight"
        yield p.to(torch.int32), w


def int8_power(waves: torch.Tensor,
               cfg: FrontendConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, L) waves -> ((B, T, n_freq) fp32 power spectrum of the
    block-scaled waves, (B,) block scales f): pad, digitize, frame the
    digits, the three exact digit-sum products for re|im together, the fp32
    combine smallest weight first, |.|^2."""
    n_frames = cfg.num_frames(waves.shape[1])
    cr, ci = cfg.constants(np.float64)[:2]
    c_digits = _const_digits(np.concatenate([cr, ci], axis=1))
    y_digits, f = _wave_digits(center_pad(waves.float(), cfg))
    if y_digits[0].numel() and int(y_digits[0].to(torch.int16).abs().max()) > 64:
        raise AssertionError("wave digit overflow: |d0| > 64")
    frames_d = [frame_signal(d, n_frames, cfg.n_fft, cfg.hop_length)
                for d in y_digits]
    acc = None
    for p, w in digit_sum_groups(frames_d, c_digits):
        term = p.float() * w
        acc = term if acc is None else acc + term
    re, im = acc[..., :cfg.n_freq], acc[..., cfg.n_freq:]
    return re * re + im * im, f


def mfcc_int8_batch(waves: torch.Tensor, cfg: FrontendConfig,
                    lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Batched MFCC, same contract as `mfcc_torch_batch`: (B, L) ->
    (B, n_mfcc, utterance_length); the rDFT runs as exact int8 digit
    products (module docstring), the block scale is undone on the power
    spectrum, and the fp32 mel GEMM and the dB/DCT finish are the shared
    ones."""
    if waves.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False  # fp32 GEMMs, never TF32
    b, n_samples = waves.shape
    power, f = int8_power(waves, cfg)
    inv = 1.0 / f
    power = power * (inv * inv)[:, None, None]  # undo block scale, exact
    _, _, mel_t, dct_t = device_constants(cfg, waves.device)
    return finish_mfcc_from_mel(power @ mel_t, cfg, lengths, b,
                                cfg.num_frames(n_samples), dct_t)
