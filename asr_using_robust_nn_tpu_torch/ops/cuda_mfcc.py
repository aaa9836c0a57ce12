"""K1 on Hopper: the fused rDFT -> |.|^2 -> mel kernel, its wrapper and its
plain twin. Counterpart of the JAX package's `ops/pallas_mfcc.py`
(`mel_power_pallas`, `mfcc_pallas_batch`).

  mel_power_cuda(waves, cfg)   CUDA tensor: center pad, then one launch of
                               csrc/dft_power_mel.cu, which frames, applies
                               the windowed rDFT (fp32 products summed in
                               fp64), squares and projects onto the mel bands
                               without writing the frames or the power
                               spectrogram to device memory.
                               CPU tensor: the plain twin.
  mel_power_plain(waves, cfg)  pad -> frame -> @Cr, @Ci -> power -> @Mel^T
                               in fp32 PyTorch (ops/mfcc_torch.py).
  mfcc_cuda_batch(...)         mel_power_cuda + the shared dB/DCT finish.

A CUDA tensor never falls back to the plain twin: the kernel launches or the
wrapper raises. `mel_power_cuda.launches` counts launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ._build import load_library
from .mfcc_torch import (
    FrontendConfig,
    center_pad,
    device_constants,
    finish_mfcc_from_mel,
    mel_power_plain,
)

__all__ = ["mel_power_cuda", "mel_power_plain", "mfcc_cuda_batch",
           "KERNEL_SOURCE"]

KERNEL_SOURCE = "asr_using_robust_nn_tpu_torch/csrc/dft_power_mel.cu"
# tile sizes the kernel's constants are padded to (csrc/dft_power_mel.cu)
_K_TILE = 16
_FREQ_TILE = 64
_N_MELS = 128


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.cache
def _kernel():
    lib = load_library("dft_power_mel")
    fn = lib.asr_dft_power_mel
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=16)
def _padded_constants(cfg: FrontendConfig, device: torch.device):
    """Cr, Ci (n_fft_pad, n_freq_pad) and Mel^T (n_freq_pad, 128), zero
    padded to whole kernel tiles, on `device` once per (cfg, device). Padded
    DFT rows meet zeros and padded bins meet zero mel rows, so the padding
    adds exact zeros."""
    cr, ci, mel_t, _ = cfg.constants(np.float32)
    n_fft_pad = _round_up(cfg.n_fft, _K_TILE)
    n_freq_pad = _round_up(cfg.n_freq, _FREQ_TILE)
    cr_p = np.zeros((n_fft_pad, n_freq_pad), np.float32)
    ci_p = np.zeros((n_fft_pad, n_freq_pad), np.float32)
    mel_p = np.zeros((n_freq_pad, cfg.n_mels), np.float32)
    cr_p[: cfg.n_fft, : cfg.n_freq] = cr
    ci_p[: cfg.n_fft, : cfg.n_freq] = ci
    mel_p[: cfg.n_freq] = mel_t
    return tuple(torch.from_numpy(c).to(device) for c in (cr_p, ci_p, mel_p))


def mel_power_cuda(waves: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """Fused rDFT + power + mel: (B, L) float32 waves -> (B, T, n_mels).

    Applies the librosa center pad, then launches the kernel on the current
    stream. A CPU tensor goes to `mel_power_plain`; any other device raises.
    """
    if waves.device.type == "cpu":
        return mel_power_plain(waves, cfg)
    if not waves.is_cuda:
        raise ValueError(f"mel_power_cuda: unsupported device {waves.device}")
    if waves.dtype != torch.float32 or waves.dim() != 2:
        raise ValueError(f"mel_power_cuda: need a (B, L) float32 tensor, got "
                         f"{tuple(waves.shape)} {waves.dtype}")
    if not waves.is_contiguous():
        raise ValueError("mel_power_cuda: waves must be contiguous")
    if cfg.n_mels != _N_MELS:
        raise ValueError(f"mel_power_cuda: the kernel computes {_N_MELS} mel "
                         f"bands, cfg.n_mels={cfg.n_mels}")
    b, n_samples = waves.shape
    n_frames = cfg.num_frames(n_samples)
    if b * n_frames == 0:  # nothing to launch
        return torch.empty((b, n_frames, _N_MELS), device=waves.device)
    cr_p, ci_p, mel_p = _padded_constants(cfg, waves.device)
    ypad = center_pad(waves, cfg).contiguous()
    out = torch.empty((b * n_frames, _N_MELS), dtype=torch.float32,
                      device=waves.device)
    # the CUDA runtime launches on its current device: make it the tensor's
    with torch.cuda.device(waves.device):
        rc = _kernel()(
            ypad.data_ptr(), cr_p.data_ptr(), ci_p.data_ptr(),
            mel_p.data_ptr(), out.data_ptr(), b, ypad.shape[1], n_frames,
            cfg.hop_length, cfg.n_fft, cr_p.shape[0], cr_p.shape[1],
            torch.cuda.current_stream(waves.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"dft_power_mel launch failed: CUDA error {rc}")
    mel_power_cuda.launches += 1
    return out.view(b, n_frames, _N_MELS)


mel_power_cuda.launches = 0


def mfcc_cuda_batch(waves: torch.Tensor, cfg: FrontendConfig,
                    lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Full MFCC via the K1 wrapper + the shared dB/DCT finish. Same
    contract as `mfcc_torch_batch`: (B, L) -> (B, n_mfcc, utterance_length)
    with per-utterance length masking."""
    b, n_samples = waves.shape
    mel = mel_power_cuda(waves, cfg)
    dct_t = device_constants(cfg, waves.device)[3]
    return finish_mfcc_from_mel(mel, cfg, lengths, b,
                                cfg.num_frames(n_samples), dct_t)
