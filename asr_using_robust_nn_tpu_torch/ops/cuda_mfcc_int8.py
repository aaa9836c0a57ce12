"""K4 on Hopper: the fused int8-digit rDFT -> |.|^2 -> mel kernel, its
wrapper and its plain twin. Counterpart of the JAX package's
`ops/pallas_mfcc.py` (`mel_power_int8_pallas`, `mfcc_pallas_int8_batch`).

  mel_power_int8_cuda(waves, cfg)   CUDA tensor: center pad and digitize
                                    (`ops/mfcc_int8.py::_wave_digits`, plain
                                    tensor ops, as in the JAX package), then
                                    one launch of csrc/int8_dft_power_mel.cu,
                                    which frames the three digit signals by
                                    address arithmetic, runs the twelve int8
                                    products per tile as wgmma with exact
                                    int32 sums, combines them in fp32,
                                    squares, folds the power into the mel
                                    bands through the band tables and undoes
                                    the block scale. CPU tensor: the plain
                                    twin.
  mel_power_int8_plain(waves, cfg)  the same arithmetic in PyTorch: exact
                                    float64 GEMMs on the integer digits, the
                                    same int32 -> fp32 conversion and combine
                                    order, fp32 mel GEMM, scale undone on
                                    the mel output.
  mfcc_cuda_int8_batch(...)         mel_power_int8_cuda + the shared dB/DCT
                                    finish.

A CUDA tensor never falls back to the plain twin: the kernel launches or the
wrapper raises. `mel_power_int8_cuda.launches` counts launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ._build import load_library
from .cuda_mfcc import _round_up, mel_bands
from .mfcc_int8 import _X_SCALES, _const_digits, _wave_digits, int8_power
from .mfcc_torch import (
    FrontendConfig,
    center_pad,
    device_constants,
    finish_mfcc_from_mel,
)

__all__ = ["mel_power_int8_cuda", "mel_power_int8_plain",
           "mfcc_cuda_int8_batch", "launch_plan", "chunk_bands",
           "KERNEL_SOURCE", "REPLACES"]

KERNEL_SOURCE = "asr_using_robust_nn_tpu_torch/csrc/int8_dft_power_mel.cu"
REPLACES = "asr_using_robust_nn_tpu/ops/pallas_mfcc.py:304"
# tile sizes the kernel's operands are padded to (csrc/int8_dft_power_mel.cu)
_K_TILE = 128     # depth a step: one 128-byte row of int8
_CHUNK = 64       # bins a chunk, 32 a warpgroup
_GROUP = 32       # bins of one [Cr | Ci] operand tile
_ROWS = 64        # frame rows a block
_ALIGN = 16
_N_MELS = 128


class Int8Plan(NamedTuple):
    """One K4 launch, as csrc/int8_dft_power_mel.cu takes it."""
    n_fft_pad: int   # depth, whole 128-deep steps (the JAX wrapper's pad)
    n_freq_pad: int  # bins, whole 64-bin chunks
    n_frames: int
    lalloc: int      # digit-signal row length: every frame's n_fft_pad
    #                  samples, a multiple of 16
    grid: int        # blocks of 64 frame rows
    steps: int       # ring steps a block: chunks x depth slices
    copy_bytes: int  # 16, 4 or 1: how the frames are copied (hop % 16,
    #                  hop % 4, else)


def launch_plan(cfg: FrontendConfig, batch: int, n_samples: int) -> Int8Plan:
    """K4's padding, grid and copy width for `batch` waves of `n_samples`,
    from the config alone."""
    n_frames = cfg.num_frames(n_samples)
    n_fft_pad = _round_up(cfg.n_fft, _K_TILE)
    n_freq_pad = _round_up(cfg.n_freq, _CHUNK)
    lpad = n_samples + 2 * (cfg.n_fft // 2)
    lalloc = _round_up(
        max(lpad, (n_frames - 1) * cfg.hop_length + n_fft_pad), _ALIGN)
    hop = cfg.hop_length
    return Int8Plan(n_fft_pad, n_freq_pad, n_frames, lalloc,
                    -(-batch * n_frames // _ROWS),
                    (n_freq_pad // _CHUNK) * (n_fft_pad // _K_TILE),
                    16 if hop % 16 == 0 else 4 if hop % 4 == 0 else 1)


def chunk_bands(band_start: np.ndarray, band_off: np.ndarray,
                n_freq_pad: int) -> np.ndarray:
    """(n_freq_pad / 64, 2) i32: for each 64-bin chunk the bands [lo, hi)
    whose runs of bins touch it ([0, 0) where none does). Bands are ordered
    by their bins, so the touching ones are consecutive."""
    n = np.diff(band_off)
    out = np.zeros((n_freq_pad // _CHUNK, 2), np.int32)
    for c in range(out.shape[0]):
        f0 = c * _CHUNK
        hit = np.flatnonzero((n > 0) & (band_start < f0 + _CHUNK)
                             & (band_start + n > f0))
        if hit.size:
            out[c] = hit[0], hit[-1] + 1
    return out


@functools.cache
def _kernel():
    lib = load_library("int8_dft_power_mel")
    fn = lib.asr_int8_dft_power_mel
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=16)
def _digit_constants(cfg: FrontendConfig, device: torch.device):
    """-> (ct (3, n_freq_pad / 32, 64, n_fft_pad) int8: for digit e and each
    group of 32 bins, the rows of Cr_e^T then those of Ci_e^T (K4's [Cr |
    Ci] operand tiles); the weights of the digit sums 0, 1, 2), zero padded
    to whole kernel tiles, on `device` once per (cfg, device). Padded depth
    columns and padded bins are zeros, and no mel band reaches a padded bin,
    so the padding adds exact zeros. Cr and Ci are digitized apart, as
    `mel_power_int8_pallas` does, and must share their scales."""
    cr64, ci64 = cfg.constants(np.float64)[:2]
    cr_d, ci_d = _const_digits(cr64), _const_digits(ci64)
    if [s for _, s in cr_d] != [s for _, s in ci_d]:
        raise ValueError("Cr and Ci digit scales diverge")
    plan = launch_plan(cfg, 0, 0)
    n_fft_pad, n_freq_pad = plan.n_fft_pad, plan.n_freq_pad
    ct = np.zeros((3, n_freq_pad // _GROUP, 2, _GROUP, n_fft_pad), np.int8)
    for side, digits in enumerate((cr_d, ci_d)):
        for e, (d, _) in enumerate(digits):
            t = np.zeros((n_freq_pad, n_fft_pad), np.int8)
            t[: cfg.n_freq, : cfg.n_fft] = d.T
            ct[e, :, side] = t.reshape(n_freq_pad // _GROUP, _GROUP, n_fft_pad)
    weights = tuple(_X_SCALES[0] * cr_d[k][1] for k in range(3))
    return (torch.from_numpy(ct.reshape(3, n_freq_pad // _GROUP, 2 * _GROUP,
                                        n_fft_pad)).to(device), weights)


@functools.lru_cache(maxsize=16)
def _band_tables(cfg: FrontendConfig, device: torch.device):
    """(band_start, band_off, band_w, chunk_bands) on `device`: the banded
    mel weights the FFT bodies fold with, and the bands each chunk
    touches."""
    start, off, w = mel_bands(cfg.sr, cfg.n_fft, cfg.n_mels)
    chunks = chunk_bands(start, off, launch_plan(cfg, 0, 0).n_freq_pad)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (start, off, w, chunks))


def mel_power_int8_plain(waves: torch.Tensor,
                         cfg: FrontendConfig) -> torch.Tensor:
    """(B, L) waves -> (B, T, n_mels) mel power through the int8 digit
    decomposition, in plain PyTorch: K4's twin. The integer products are
    exact (float64 GEMMs on the digits), the int32 -> fp32 conversion and
    the combine order are the kernel's, so the power spectra are bit-equal
    and only the order of the fp32 mel sums differs."""
    if waves.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False  # fp32 GEMMs, never TF32
    power, f = int8_power(waves, cfg)
    mel_t = device_constants(cfg, waves.device)[2]
    inv = 1.0 / f
    return (power @ mel_t) * (inv * inv)[:, None, None]  # undo block scale


def mel_power_int8_cuda(waves: torch.Tensor,
                        cfg: FrontendConfig) -> torch.Tensor:
    """Fused int8-digit rDFT + power + mel: (B, L) float32 waves ->
    (B, T, n_mels), the block scale already undone.

    Pads and digitizes with tensor ops, then launches the kernel on the
    current stream. A CPU tensor goes to `mel_power_int8_plain`; any other
    device raises.
    """
    if waves.device.type == "cpu":
        return mel_power_int8_plain(waves, cfg)
    if not waves.is_cuda:
        raise ValueError(
            f"mel_power_int8_cuda: unsupported device {waves.device}")
    if waves.dtype != torch.float32 or waves.dim() != 2:
        raise ValueError(f"mel_power_int8_cuda: need a (B, L) float32 tensor, "
                         f"got {tuple(waves.shape)} {waves.dtype}")
    if not waves.is_contiguous():
        raise ValueError("mel_power_int8_cuda: waves must be contiguous")
    if cfg.n_mels != _N_MELS:
        raise ValueError(f"mel_power_int8_cuda: the kernel computes {_N_MELS} "
                         f"mel bands, cfg.n_mels={cfg.n_mels}")
    b, n_samples = waves.shape
    n_frames = cfg.num_frames(n_samples)
    if b * n_frames == 0:  # nothing to launch
        return torch.empty((b, n_frames, _N_MELS), device=waves.device)
    plan = launch_plan(cfg, b, n_samples)
    ct, weights = _digit_constants(cfg, waves.device)
    bands = _band_tables(cfg, waves.device)
    ypad = center_pad(waves, cfg)
    lpad = ypad.shape[1]
    dig = torch.empty((3, b, plan.lalloc), dtype=torch.int8,
                      device=waves.device)
    dig[:, :, lpad:] = 0  # frames read past the signal into zeros
    _, f = _wave_digits(ypad, out=dig)
    inv = 1.0 / f
    finv2 = (inv * inv).contiguous()
    out = torch.empty((b * n_frames, _N_MELS), dtype=torch.float32,
                      device=waves.device)
    # the CUDA runtime launches on its current device: make it the tensor's
    with torch.cuda.device(waves.device):
        rc = _kernel()(
            dig.data_ptr(), ct.data_ptr(), *[t.data_ptr() for t in bands],
            finv2.data_ptr(), out.data_ptr(), b, plan.lalloc, n_frames,
            cfg.hop_length, plan.n_fft_pad, plan.n_freq_pad, *weights,
            torch.cuda.current_stream(waves.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"int8_dft_power_mel launch failed: CUDA error {rc}")
    mel_power_int8_cuda.launches += 1
    return out.view(b, n_frames, _N_MELS)


mel_power_int8_cuda.launches = 0


def mfcc_cuda_int8_batch(waves: torch.Tensor, cfg: FrontendConfig,
                         lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Full MFCC via the K4 wrapper + the shared dB/DCT finish. Same
    contract as `mfcc_torch_batch`: (B, L) -> (B, n_mfcc, utterance_length)
    with per-utterance length masking."""
    b, n_samples = waves.shape
    mel = mel_power_int8_cuda(waves, cfg)
    dct_t = device_constants(cfg, waves.device)[3]
    return finish_mfcc_from_mel(mel, cfg, lengths, b,
                                cfg.num_frames(n_samples), dct_t)
