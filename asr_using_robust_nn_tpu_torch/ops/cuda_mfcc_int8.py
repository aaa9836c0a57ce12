"""K4 on Hopper: the fused int8-digit rDFT -> |.|^2 -> mel kernel, its
wrapper and its plain twin. Counterpart of the JAX package's
`ops/pallas_mfcc.py` (`mel_power_int8_pallas`, `mfcc_pallas_int8_batch`).

  mel_power_int8_cuda(waves, cfg)   CUDA tensor: center pad and digitize
                                    (`ops/mfcc_int8.py::_wave_digits`, plain
                                    tensor ops, as in the JAX package), then
                                    one launch of csrc/int8_dft_power_mel.cu,
                                    which frames the three digit signals by
                                    address arithmetic, runs the twelve int8
                                    products per tile on the tensor cores
                                    with exact int32 sums, combines them in
                                    fp32, squares, projects onto the mel
                                    bands and undoes the block scale.
                                    CPU tensor: the plain twin.
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

import numpy as np
import torch

from ._build import load_library
from .cuda_mfcc import _round_up
from .mfcc_int8 import _X_SCALES, _const_digits, _wave_digits, int8_power
from .mfcc_torch import (
    FrontendConfig,
    center_pad,
    device_constants,
    finish_mfcc_from_mel,
)

__all__ = ["mel_power_int8_cuda", "mel_power_int8_plain",
           "mfcc_cuda_int8_batch", "KERNEL_SOURCE", "REPLACES"]

KERNEL_SOURCE = "asr_using_robust_nn_tpu_torch/csrc/int8_dft_power_mel.cu"
REPLACES = "asr_using_robust_nn_tpu/ops/pallas_mfcc.py:304"
# tile sizes the kernel's operands are padded to (csrc/int8_dft_power_mel.cu)
_K_TILE = 64
_FREQ_TILE = 64
_ALIGN = 16
_N_MELS = 128


@functools.cache
def _kernel():
    lib = load_library("int8_dft_power_mel")
    fn = lib.asr_int8_dft_power_mel
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=16)
def _digit_constants(cfg: FrontendConfig, device: torch.device):
    """-> (ct (6, n_freq_pad, n_fft_pad) int8: the transposed digit matrices
    Cr0, Cr1, Cr2, Ci0, Ci1, Ci2; Mel^T (n_freq_pad, 128) fp32; the weights
    of the digit sums 0, 1, 2), zero padded to whole kernel tiles, on
    `device` once per (cfg, device). Padded depth columns and padded bins
    are zeros, and padded bins meet zero mel rows, so the padding adds exact
    zeros. Cr and Ci are digitized apart, as `mel_power_int8_pallas` does,
    and must share their scales."""
    cr64, ci64 = cfg.constants(np.float64)[:2]
    mel_t = cfg.constants(np.float32)[2]
    cr_d, ci_d = _const_digits(cr64), _const_digits(ci64)
    if [s for _, s in cr_d] != [s for _, s in ci_d]:
        raise ValueError("Cr and Ci digit scales diverge")
    n_fft_pad = _round_up(cfg.n_fft, _K_TILE)
    n_freq_pad = _round_up(cfg.n_freq, _FREQ_TILE)
    ct = np.zeros((6, n_freq_pad, n_fft_pad), np.int8)
    for m, (d, _) in enumerate(cr_d + ci_d):
        ct[m, : cfg.n_freq, : cfg.n_fft] = d.T
    mel_p = np.zeros((n_freq_pad, cfg.n_mels), np.float32)
    mel_p[: cfg.n_freq] = mel_t
    weights = tuple(_X_SCALES[0] * cr_d[k][1] for k in range(3))
    return (torch.from_numpy(ct).to(device),
            torch.from_numpy(mel_p).to(device), weights)


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
    ct, mel_p, weights = _digit_constants(cfg, waves.device)
    n_freq_pad, n_fft_pad = ct.shape[1:]
    digits, f = _wave_digits(center_pad(waves, cfg))
    lpad = digits[0].shape[1]
    # every frame reads n_fft_pad samples: zeros past the padded signal
    lalloc = _round_up(
        max(lpad, (n_frames - 1) * cfg.hop_length + n_fft_pad), _ALIGN)
    dig = torch.zeros((3, b, lalloc), dtype=torch.int8, device=waves.device)
    for i, d in enumerate(digits):
        dig[i, :, :lpad] = d
    inv = 1.0 / f
    finv2 = (inv * inv).contiguous()
    out = torch.empty((b * n_frames, _N_MELS), dtype=torch.float32,
                      device=waves.device)
    # the CUDA runtime launches on its current device: make it the tensor's
    with torch.cuda.device(waves.device):
        rc = _kernel()(
            dig.data_ptr(), ct.data_ptr(), mel_p.data_ptr(),
            finv2.data_ptr(), out.data_ptr(), b, lalloc, n_frames,
            cfg.hop_length, n_fft_pad, n_freq_pad, *weights,
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
