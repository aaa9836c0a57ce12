"""K5 on Hopper: the fused three-pass bf16 rDFT -> |.|^2 -> mel kernel, its
wrapper, its launch plan and its plain twin. Counterpart of the JAX package's
`ops/pallas_mfcc.py` (`_bf16x3_split`, `mel_power_bf16x3_pallas`,
`mfcc_pallas_bf16x3_batch`), built for the speaker preset's odd n_fft = 441.

  mel_power_bf16x3_cuda(waves, cfg)   CUDA tensor: one call of
                                      csrc/dft_power_mel_x3.cu, which splits
                                      the center-padded waves into bf16 hi +
                                      lo planes in one pass, frames them by
                                      address arithmetic, runs every product
                                      as hi@hi + hi@lo + lo@hi on wgmma with
                                      fp32 sums, squares, splits the power
                                      again and projects onto the mel bands.
                                      CPU tensor: the plain twin.
  launch_plan(cfg, batch, n_samples)  the padding, grid, copy width and
                                      shared memory of that call.
  mel_power_bf16x3_plain(waves, cfg)  the same arithmetic in PyTorch (fp32
                                      GEMMs on the bf16 values, whose
                                      products are exact in fp32).
  mfcc_cuda_bf16x3_batch(...)         mel_power_bf16x3_cuda + the shared
                                      dB/DCT finish.

Parity class: the dropped lo@lo terms leave ~2^-16 relative on each product;
the JAX package holds its kernel's MFCC to atol 8e-3, rtol 1e-3 against the
f64 oracle, and so does the port. A CUDA tensor never falls back to the
plain twin: the kernel launches or the wrapper raises.
`mel_power_bf16x3_cuda.launches` counts launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ._build import load_library
from .cuda_mfcc import _round_up
from .mfcc_torch import (
    FrontendConfig,
    bf16x3_split as _bf16x3_split,
    center_pad,
    device_constants,
    finish_mfcc_from_mel,
    frame_signal,
    matmul_bf16x3,
)

__all__ = ["mel_power_bf16x3_cuda", "mel_power_bf16x3_plain",
           "mfcc_cuda_bf16x3_batch", "launch_plan", "KERNEL_SOURCE",
           "REPLACES"]

KERNEL_SOURCE = "asr_using_robust_nn_tpu_torch/csrc/dft_power_mel_x3.cu"
REPLACES = "asr_using_robust_nn_tpu/ops/pallas_mfcc.py:168"
# the kernel's tiles (csrc/dft_power_mel_x3.cu)
_K_TILE = 64          # depth a step
_CHUNK = 64           # bins a chunk: two [Cr | Ci] groups
_GROUP = 32           # bins of one [Cr | Ci] group
_ROWS = 64            # frame rows a block
_ALIGN = 8            # split-signal rows: 16-byte aligned
_MAX_RESIDENT_K = 512  # deeper frames do not stay in shared memory
_N_MELS = 128


class X3Plan(NamedTuple):
    """One K5 launch, as csrc/dft_power_mel_x3.cu takes it."""
    n_fft_pad: int    # depth, whole 64-deep steps
    n_freq_pad: int   # bins, whole 64-bin chunks
    n_frames: int
    lalloc: int       # split-signal row length: every frame's n_fft_pad
    #                   samples, a multiple of 8
    grid: int         # blocks of 64 frame rows
    copy_bytes: int   # 16, 8 or 2: how the frames are copied (hop % 8,
    #                   hop % 4, else)
    resident: bool    # the block's split frames stay in shared memory


def launch_plan(cfg: FrontendConfig, batch: int, n_samples: int) -> X3Plan:
    """K5's padding, grid, copy width and frame residency for `batch` waves
    of `n_samples`, from the config alone."""
    n_frames = cfg.num_frames(n_samples)
    n_fft_pad = _round_up(cfg.n_fft, _K_TILE)
    n_freq_pad = _round_up(cfg.n_freq, _CHUNK)
    lpad = n_samples + 2 * (cfg.n_fft // 2)
    lalloc = _round_up(
        max(lpad, (n_frames - 1) * cfg.hop_length + n_fft_pad), _ALIGN)
    hop = cfg.hop_length
    return X3Plan(n_fft_pad, n_freq_pad, n_frames, lalloc,
                  -(-batch * n_frames // _ROWS),
                  16 if hop % 8 == 0 else 8 if hop % 4 == 0 else 2,
                  n_fft_pad <= _MAX_RESIDENT_K)


@functools.cache
def _kernel():
    lib = load_library("dft_power_mel_x3")
    fn = lib.asr_dft_power_mel_x3
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=16)
def _split_constants(cfg: FrontendConfig, device: torch.device):
    """-> (Cr_hi, Cr_lo, Ci_hi, Ci_lo (n_fft, n_freq) and Mel^T hi, lo
    (n_freq, n_mels)), bf16 on `device`, once per (cfg, device)."""
    cr, ci, mel_t, _ = device_constants(cfg, device)
    return (*_bf16x3_split(cr), *_bf16x3_split(ci), *_bf16x3_split(mel_t))


@functools.lru_cache(maxsize=16)
def _padded_constants(cfg: FrontendConfig, device: torch.device):
    """-> (ct (2, n_freq_pad / 32, 64, n_fft_pad) bf16: for hi and lo and
    each group of 32 bins, the 32 rows of Cr^T, then the same 32 rows of
    Ci^T (K5's [Cr | Ci] operand tiles); melt (2, 128, n_freq_pad) bf16: Mel
    hi and lo, bands by bins), zero padded to whole kernel tiles. Padded
    depth columns and bins are zeros and padded bins meet zero mel columns,
    so the padding adds exact zeros."""
    cr_hi, cr_lo, ci_hi, ci_lo, mel_hi, mel_lo = _split_constants(cfg, device)
    plan = launch_plan(cfg, 0, 0)
    n_fft_pad, n_freq_pad = plan.n_fft_pad, plan.n_freq_pad
    ct = torch.zeros((2, n_freq_pad // _GROUP, 2, _GROUP, n_fft_pad),
                     dtype=torch.bfloat16, device=device)
    for h, (cr, ci) in enumerate(((cr_hi, ci_hi), (cr_lo, ci_lo))):
        for side, c in enumerate((cr, ci)):
            t = torch.zeros((n_freq_pad, n_fft_pad), dtype=torch.bfloat16,
                            device=device)
            t[: cfg.n_freq, : cfg.n_fft] = c.T
            ct[h, :, side] = t.view(n_freq_pad // _GROUP, _GROUP, n_fft_pad)
    melt = torch.zeros((2, cfg.n_mels, n_freq_pad), dtype=torch.bfloat16,
                       device=device)
    melt[0, :, : cfg.n_freq] = mel_hi.T
    melt[1, :, : cfg.n_freq] = mel_lo.T
    return (ct.view(2, n_freq_pad // _GROUP, 2 * _GROUP, n_fft_pad),
            melt)


def mel_power_bf16x3_plain(waves: torch.Tensor,
                           cfg: FrontendConfig) -> torch.Tensor:
    """(B, L) waves -> (B, T, n_mels) mel power with every product as three
    bf16 passes, in plain PyTorch: K5's twin. Six products for re and im,
    |.|^2 in fp32, the power split again, three products for the mel
    projection; only the order of the fp32 sums differs from the kernel."""
    if waves.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False  # fp32 GEMMs, never TF32
    n_frames = cfg.num_frames(waves.shape[-1])
    cr_hi, cr_lo, ci_hi, ci_lo, mel_hi, mel_lo = _split_constants(
        cfg, waves.device)
    frames = frame_signal(center_pad(waves.float(), cfg), n_frames,
                          cfg.n_fft, cfg.hop_length)
    f_hi, f_lo = _bf16x3_split(frames)
    re = matmul_bf16x3(f_hi, f_lo, cr_hi, cr_lo)
    im = matmul_bf16x3(f_hi, f_lo, ci_hi, ci_lo)
    p_hi, p_lo = _bf16x3_split(re * re + im * im)
    return matmul_bf16x3(p_hi, p_lo, mel_hi, mel_lo)


def mel_power_bf16x3_cuda(waves: torch.Tensor,
                          cfg: FrontendConfig) -> torch.Tensor:
    """Fused three-pass bf16 rDFT + power + mel: (B, L) float32 waves ->
    (B, T, n_mels).

    One call of the kernel's C entry on the current stream: the split pass
    (center pad included), then the fused kernel. A CPU tensor goes to
    `mel_power_bf16x3_plain`; any other device raises.
    """
    if waves.device.type == "cpu":
        return mel_power_bf16x3_plain(waves, cfg)
    if not waves.is_cuda:
        raise ValueError(
            f"mel_power_bf16x3_cuda: unsupported device {waves.device}")
    if waves.dtype != torch.float32 or waves.dim() != 2:
        raise ValueError(f"mel_power_bf16x3_cuda: need a (B, L) float32 "
                         f"tensor, got {tuple(waves.shape)} {waves.dtype}")
    if not waves.is_contiguous():
        raise ValueError("mel_power_bf16x3_cuda: waves must be contiguous")
    if cfg.n_mels != _N_MELS:
        raise ValueError(f"mel_power_bf16x3_cuda: the kernel computes "
                         f"{_N_MELS} mel bands, cfg.n_mels={cfg.n_mels}")
    b, n_samples = waves.shape
    plan = launch_plan(cfg, b, n_samples)
    rows = b * plan.n_frames
    if rows == 0:  # nothing to launch
        return torch.empty((b, plan.n_frames, _N_MELS), device=waves.device)
    ct, melt = _padded_constants(cfg, waves.device)
    # the kernel's split pass writes the zero center pad itself; another
    # pad mode is applied here first
    if cfg.pad_mode == "constant":
        src, offset = waves, cfg.n_fft // 2
    else:
        src, offset = center_pad(waves, cfg).contiguous(), 0
    sig = torch.empty((2, b, plan.lalloc), dtype=torch.bfloat16,
                      device=waves.device)
    # whole blocks: the kernel stores its registers straight to `out`
    out = torch.empty((plan.grid * _ROWS, _N_MELS), dtype=torch.float32,
                      device=waves.device)
    # the CUDA runtime launches on its current device: make it the tensor's
    with torch.cuda.device(waves.device):
        rc = _kernel()(
            src.data_ptr(), ct.data_ptr(), melt.data_ptr(), sig.data_ptr(),
            out.data_ptr(), b, src.shape[1], offset, plan.lalloc,
            plan.n_frames, cfg.hop_length, plan.n_fft_pad, plan.n_freq_pad,
            plan.copy_bytes, int(plan.resident),
            torch.cuda.current_stream(waves.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"dft_power_mel_x3 launch failed: CUDA error {rc}")
    mel_power_bf16x3_cuda.launches += 1
    return out[:rows].view(b, plan.n_frames, _N_MELS)


mel_power_bf16x3_cuda.launches = 0


def mfcc_cuda_bf16x3_batch(waves: torch.Tensor, cfg: FrontendConfig,
                           lengths: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Full MFCC via the K5 wrapper + the shared dB/DCT finish. Same
    contract as `mfcc_torch_batch`: (B, L) -> (B, n_mfcc, utterance_length)
    with per-utterance length masking."""
    b, n_samples = waves.shape
    mel = mel_power_bf16x3_cuda(waves, cfg)
    dct_t = device_constants(cfg, waves.device)[3]
    return finish_mfcc_from_mel(mel, cfg, lengths, b,
                                cfg.num_frames(n_samples), dct_t)
