"""Hop-block rDFT MFCC in plain PyTorch: the counterpart of the JAX
package's `ops/mfcc_hopdft.py`.

The digit preset reads every sample into r = n_fft / hop = 4 overlapping
frames. This path removes that redundancy exactly:

1. Hop-block DFT. The padded waveform splits into non-overlapping hop-sized
   blocks (a reshape); a frame is q = n_fft // hop consecutive blocks, and
   its unwindowed DFT is

       X_f[k] = sum_{d<q} (W_N^{hop k})^d G_{f+d}[k],
       G_b[k] = sum_{m<hop} block_b[m] e^(-2 pi i k m / N),

   one (hop x n_freq) GEMM per block shared by every frame that holds it.
   For q in {1, 2, 4} the combine coefficients are exact {0, +-1}.
2. Hann in the frequency domain. The periodic Hann window is three DFT
   bins, so windowing is the circular 3-tap convolution
   Xw[k] = 0.5 X[k] - 0.25 X[k-1] - 0.25 X[k+1], with Hermitian edges.

A hop that does not divide n_fft (n_fft = q hop + s) adds one thin GEMM of
the s tail samples with their phase folded into the constant, which covers
the speaker preset (441 = 2 * 220 + 1).

`mfcc_hopdft_batch` runs the block GEMM in fp32 (three bf16 passes under
`cfg.dft_algorithm="bf16_x3"`). `mfcc_hopdft_int8_batch` runs it as the
base-128 int8 digit products of `ops/mfcc_int8.py` (`_const_digits`,
`_wave_digits`, `digit_sum_groups`): the digit products are float64 GEMMs
on integer digits, exact while a sum stays under 2^53 (here at most
3 * 64 * 64 * hop < 2^24), cast to int32; the phase combine then runs in
exact int32 (at most q times that, < 2^27), and only the three digit-sum
groups are rounded to fp32, as in the JAX path.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .mfcc_int8 import _const_digits, _wave_digits, digit_sum_groups
from .mfcc_torch import (
    FrontendConfig,
    _dft_product,
    center_pad,
    device_constants,
    finish_mfcc_from_mel,
)

__all__ = [
    "mfcc_hopdft_batch",
    "mfcc_hopdft_int8_batch",
    "hopdft_supported",
    "hopdft_int8_supported",
    "validate_hopdft",
    "block_dft_constants",
    "tail_dft_constants",
    "combine_coeffs",
]


def hopdft_supported(cfg: FrontendConfig) -> bool:
    """The fp32 decomposition needs a full-frame window (the frequency-domain
    Hann is periodic over n_fft) and hop <= n_fft."""
    return cfg.win_length == cfg.n_fft and cfg.hop_length <= cfg.n_fft


def hopdft_int8_supported(cfg: FrontendConfig) -> bool:
    """The int8 variant also needs hop | n_fft with n_fft / hop in {1, 2, 4}:
    its combine runs in exact int32, which takes only {0, +-1}
    coefficients, and it has no tail GEMM."""
    return (hopdft_supported(cfg) and cfg.n_fft % cfg.hop_length == 0
            and cfg.n_fft // cfg.hop_length in (1, 2, 4))


def validate_hopdft(cfg: FrontendConfig, int8: bool) -> None:
    """ValueError with the reason when `cfg` is outside the domain of the
    decomposition (`int8`: of its int8 variant)."""
    if not hopdft_supported(cfg):
        raise ValueError(
            f"hop-block DFT needs win == n_fft and hop <= n_fft,"
            f" got n_fft={cfg.n_fft} hop={cfg.hop_length}"
            f" win={cfg.win_length}; use the 'plain'/'int8' backends")
    if int8 and not hopdft_int8_supported(cfg):
        raise ValueError(
            f"int8 hop-block combine needs hop | n_fft with n_fft/hop in "
            f"{{1,2,4}} (exact integer roots), got n_fft={cfg.n_fft} "
            f"hop={cfg.hop_length}; use mfcc_hopdft_batch (backend='hopdft')")


def block_dft_constants(cfg: FrontendConfig) -> tuple[np.ndarray, np.ndarray]:
    """Unwindowed (hop, n_freq) partial-DFT matrices (cos, -sin), float64."""
    m = np.arange(cfg.hop_length, dtype=np.float64)
    k = np.arange(cfg.n_freq, dtype=np.float64)
    ang = 2.0 * np.pi * m[:, None] * k[None, :] / cfg.n_fft
    return np.cos(ang), -np.sin(ang)


def tail_dft_constants(cfg: FrontendConfig) -> np.ndarray:
    """(s, 2 n_freq) [cos | -sin] DFT rows of the s tail samples a frame
    reads from block f + q, the phase e^(-2 pi i k (q hop + m) / n_fft)
    folded in (s = n_fft mod hop; empty where hop | n_fft); float32."""
    q, s = divmod(cfg.n_fft, cfg.hop_length)
    m = q * cfg.hop_length + np.arange(s, dtype=np.float64)
    k = np.arange(cfg.n_freq, dtype=np.float64)
    ang = 2.0 * np.pi * m[:, None] * k[None, :] / cfg.n_fft
    return np.concatenate([np.cos(ang), -np.sin(ang)], axis=1).astype(
        np.float32)


def combine_coeffs(cfg: FrontendConfig) -> tuple[np.ndarray, np.ndarray]:
    """(q, n_freq) re and im of e^(-2 pi i hop k d / n_fft), d < q, float32;
    the unit-root lattice snapped to exact integers."""
    r = cfg.n_fft // cfg.hop_length
    d = np.arange(r, dtype=np.float64)
    k = np.arange(cfg.n_freq, dtype=np.float64)
    ang = 2.0 * np.pi * cfg.hop_length * d[:, None] * k[None, :] / cfg.n_fft
    wr, wi = np.cos(ang), -np.sin(ang)
    wr = np.where(np.abs(wr - np.round(wr)) < 1e-9, np.round(wr), wr)
    wi = np.where(np.abs(wi - np.round(wi)) < 1e-9, np.round(wi), wi)
    return wr.astype(np.float32), wi.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _device_tables(cfg: FrontendConfig, device: torch.device):
    """[cos | -sin] block constants and the tail rows (fp32), and the
    combine coefficients, on `device`."""
    cr, ci = block_dft_constants(cfg)
    put = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a)).to(device)
    wr, wi = combine_coeffs(cfg)
    return (put(np.concatenate([cr, ci], axis=1).astype(np.float32)),
            put(tail_dft_constants(cfg)), put(wr), put(wi))


def _blocks(ypad: torch.Tensor, cfg: FrontendConfig,
            n_frames: int) -> torch.Tensor:
    """(B, L) padded audio -> (B, n_blocks, hop) non-overlapping blocks that
    cover every frame (zero-extended where the last frame's tail block runs
    past the pad; frames read only its first s samples, which exist)."""
    q, s = divmod(cfg.n_fft, cfg.hop_length)
    n_blocks = n_frames + q - 1 + (1 if s else 0)
    need = n_blocks * cfg.hop_length
    if ypad.shape[-1] < need:
        ypad = F.pad(ypad, (0, need - ypad.shape[-1]))
    return ypad[:, :need].reshape(ypad.shape[0], n_blocks, cfg.hop_length)


def _combine_phase(gr, gi, wr, wi, cfg: FrontendConfig, n_frames: int):
    """The q shifted block partials -> whole-frame unwindowed DFTs,
    (B, n_blocks, n_freq) -> (B, n_frames, n_freq) re and im, in the dtype
    of the partials (exact int32 on the int8 path)."""
    xre = xim = 0
    for d in range(cfg.n_fft // cfg.hop_length):
        a, b = wr[d].to(gr.dtype), wi[d].to(gr.dtype)
        sr, si = gr[:, d:d + n_frames], gi[:, d:d + n_frames]
        xre = xre + (a * sr - b * si)
        xim = xim + (a * si + b * sr)
    return xre, xim


def _window_and_power(xre, xim, n_fft: int):
    """The frequency-domain periodic Hann (3 taps, Hermitian edges: X[-1] =
    conj X[1], X[n_freq] = conj X[n_fft - n_freq]) and |.|^2, fp32."""
    e = -1 if n_fft % 2 else -2
    re_m1 = torch.cat([xre[..., 1:2], xre[..., :-1]], -1)
    im_m1 = torch.cat([-xim[..., 1:2], xim[..., :-1]], -1)
    re_p1 = torch.cat([xre[..., 1:], xre[..., e:][..., :1]], -1)
    im_p1 = torch.cat([xim[..., 1:], -xim[..., e:][..., :1]], -1)
    wre = 0.5 * xre - 0.25 * (re_m1 + re_p1)
    wim = 0.5 * xim - 0.25 * (im_m1 + im_p1)
    return wre * wre + wim * wim


def mfcc_hopdft_batch(waves: torch.Tensor, cfg: FrontendConfig,
                      lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Batched MFCC by the hop-block rDFT (module docstring), the contract of
    `mfcc_torch_batch`: fp32 block and tail GEMMs, fp32 combine, window and
    mel GEMM, the f64 finish."""
    validate_hopdft(cfg, int8=False)
    if waves.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False  # fp32 GEMMs, never TF32
    b, n_samples = waves.shape
    n_frames = cfg.num_frames(n_samples)
    c_all, c_tail, wr, wi = _device_tables(cfg, waves.device)
    _, _, mel_t, dct_t = device_constants(cfg, waves.device)
    blocks = _blocks(center_pad(waves.float(), cfg), cfg, n_frames)
    g = _dft_product(blocks, c_all, cfg)
    nf = cfg.n_freq
    xre, xim = _combine_phase(g[..., :nf], g[..., nf:], wr, wi, cfg,
                              n_frames)
    q, s = divmod(cfg.n_fft, cfg.hop_length)
    if s:  # frame f also reads the first s samples of block f + q
        t = _dft_product(blocks[:, q:q + n_frames, :s], c_tail, cfg)
        xre = xre + t[..., :nf]
        xim = xim + t[..., nf:]
    power = _window_and_power(xre, xim, cfg.n_fft)
    return finish_mfcc_from_mel(power @ mel_t, cfg, lengths, b, n_frames,
                                dct_t)


def mfcc_hopdft_int8_batch(waves: torch.Tensor, cfg: FrontendConfig,
                           lengths: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """The hop-block rDFT with the base-128 int8 digit products: per
    digit-sum group, exact integer block partials (float64 GEMMs on the
    digits, cast to int32), the phase combine in exact int32, then the group
    scaled and summed in fp32; the block scale is undone on the power, the
    fp32 mel GEMM and the f64 finish are shared."""
    validate_hopdft(cfg, int8=True)
    if waves.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False  # fp32 GEMMs, never TF32
    b, n_samples = waves.shape
    n_frames = cfg.num_frames(n_samples)
    _, _, wr, wi = _device_tables(cfg, waves.device)
    _, _, mel_t, dct_t = device_constants(cfg, waves.device)
    cr, ci = block_dft_constants(cfg)
    c_digits = _const_digits(np.concatenate([cr, ci], axis=1))
    y_digits, f = _wave_digits(center_pad(waves.float(), cfg))
    blocks_d = [_blocks(d, cfg, n_frames) for d in y_digits]
    nf = cfg.n_freq
    xre = xim = None
    for p, w in digit_sum_groups(blocks_d, c_digits):
        gre, gim = _combine_phase(p[..., :nf], p[..., nf:], wr, wi, cfg,
                                  n_frames)
        tre, tim = gre.float() * w, gim.float() * w
        xre = tre if xre is None else xre + tre
        xim = tim if xim is None else xim + tim
    power = _window_and_power(xre, xim, cfg.n_fft)
    inv = 1.0 / f
    power = power * (inv * inv)[:, None, None]  # undo the block scale, exact
    return finish_mfcc_from_mel(power @ mel_t, cfg, lengths, b, n_frames,
                                dct_t)
