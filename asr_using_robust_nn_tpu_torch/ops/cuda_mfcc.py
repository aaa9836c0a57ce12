"""K1 on Hopper: the fused rDFT -> |.|^2 -> mel kernels, their wrapper and
their plain twins. Counterpart of the JAX package's `ops/pallas_mfcc.py`
(`mel_power_pallas`, `mfcc_pallas_batch`), whose Pallas kernel
`_dft_power_mel_kernel` they replace.

  mel_power_cuda(waves, cfg)   CUDA tensor: center pad, then one launch of
                               the body `kernel_body(cfg)` names:
                                 "fft"    csrc/fft_power_mel.cu when n_fft is
                                          a power of two in [32, 4096] (the
                                          digit preset): a float64 FFT of
                                          each frame in shared memory;
                                 "mixed"  csrc/mixed_fft_power_mel.cu when
                                          n_fft in [32, 4096] is no power of
                                          two and has no prime factor above 7
                                          (the speaker preset, 441 = 3^2 7^2):
                                          a float64 mixed-radix FFT of two
                                          frames packed into one complex
                                          transform;
                                 "dense"  csrc/dft_power_mel.cu for every
                                          other n_fft (a prime such as 401):
                                          the rDFT as a dense product summed
                                          in float64.
                               None writes the frames or the power
                               spectrogram to device memory. The body is a
                               function of the config alone; a body that
                               fails to build or launch raises.
                               CPU tensor: the plain twin.
  mel_power_plain(waves, cfg)  pad -> frame -> @Cr, @Ci -> power -> @Mel^T
                               in fp32 PyTorch (ops/mfcc_torch.py).
  fft_tables(cfg)              the host-side float64 tables the FFT body
                               loads (window, twiddles, stage plan and its
                               output permutation, split-pass factors, the
                               banded mel weights), one pure function.
  mixed_tables(cfg)            the same for the mixed body (window,
                               twiddles, which also give the radix
                               coefficients, stage plan, permutation, bands).
  mel_bands(sr, n_fft, n_mels) the banded mel weights both FFT bodies and
                               K4 (ops/cuda_mfcc_int8.py) fold with.
  mel_power_fft_plain(waves, cfg), mel_power_mixed_plain(waves, cfg)
                               each FFT body's own decomposition walked stage
                               by stage in float64 PyTorch with its tables:
                               what the CPU tests hold against a dense DFT.
  mfcc_cuda_batch(...)         mel_power_cuda + the shared dB/DCT finish.

What bounds K1 on an H100 now: the FFT body does ~66 kFLOP of float64 per
digit frame (the dense product: 8.4 MFLOP), so a 1024-row bucket is ~3 GFLOP
against ~120 MB of waveform and mel traffic: neither the float64 units nor
the memory is the limit, the passes over shared memory are (see the kernel's
header). The mixed body does ~21 kFLOP a speaker frame where the dense body
did 390 kFLOP. A CUDA tensor never falls back to a twin or to another body.
`mel_power_cuda.launches` counts launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import filters
from ._build import load_library
from .mfcc_torch import (
    FrontendConfig,
    center_pad,
    device_constants,
    finish_mfcc_from_mel,
    frame_signal,
    mel_power_plain,
)

__all__ = ["mel_power_cuda", "mel_power_plain", "mel_power_fft_plain",
           "mel_power_mixed_plain", "mfcc_cuda_batch", "kernel_body",
           "fft_tables", "fft_spectrum_plain", "mixed_tables",
           "mixed_spectrum_plain", "mixed_plan", "mel_bands",
           "frames_per_block", "pairs_per_block", "KERNEL_SOURCES"]

KERNEL_SOURCES = {
    "fft": "asr_using_robust_nn_tpu_torch/csrc/fft_power_mel.cu",
    "mixed": "asr_using_robust_nn_tpu_torch/csrc/mixed_fft_power_mel.cu",
    "dense": "asr_using_robust_nn_tpu_torch/csrc/dft_power_mel.cu",
}
# tile sizes the dense body's constants are padded to (csrc/dft_power_mel.cu)
_K_TILE = 16
_FREQ_TILE = 64
_N_MELS = 128
# the FFT body's limits (csrc/fft_power_mel.cu)
_FFT_MIN, _FFT_MAX = 32, 4096
_FFT_FRAMES = (4, 2, 1)  # frames a block may take
# the mixed body's radices and frame pairs a block (csrc/mixed_fft_power_mel.cu)
_MIXED_RADICES = (7, 5, 4, 3, 2)
_MIXED_PAIRS = (8, 4, 2, 1)
_SMEM_MAX = 232448       # shared memory one block may use on an H100


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def mixed_plan(n: int) -> tuple | None:
    """The mixed body's stages for a transform of length n: its factors of
    four as radix-4 stages, the rest as radix 7, 5, 3 and at most one 2,
    largest first (441 -> 7, 7, 3, 3); None when n has a prime factor
    above 7."""
    plan = []
    for r in (4, 7, 5, 3, 2):
        while n > 1 and n % r == 0:
            plan.append(r)
            n //= r
    return tuple(sorted(plan, reverse=True)) if n == 1 else None


def kernel_body(cfg: FrontendConfig) -> str:
    """Which kernel body `mel_power_cuda` launches for `cfg`, from n_fft
    alone: "fft" for a power of two in [32, 4096]; "mixed" for any other
    n_fft in [32, 4096] whose prime factors are 2, 3, 5 and 7 (441 = 3^2
    7^2, 400, 1000); "dense" for every other n_fft, a prime such as 401 or
    443 among them."""
    n = cfg.n_fft
    if not _FFT_MIN <= n <= _FFT_MAX:
        return "dense"
    if n & (n - 1) == 0:
        return "fft"
    return "mixed" if mixed_plan(n) is not None else "dense"


@functools.lru_cache(maxsize=16)
def mel_bands(sr: int, n_fft: int, n_mels: int):
    """(band_start (n_mels,) i32, band_off (n_mels + 1,) i32, band_w (nnz,)
    f32): the fp32 mel filterbank's triangles as runs of consecutive bins.
    A band's run reaches from its first to its last non-zero bin (an empty
    band has none), so the banded form holds ~2 weights per bin where the
    dense matrix holds n_mels, and rebuilds the dense matrix exactly."""
    mel = filters.mel_filterbank(sr, n_fft, n_mels).astype(np.float32)
    start = np.zeros(n_mels, np.int32)
    off = np.zeros(n_mels + 1, np.int32)
    weights = []
    for b in range(n_mels):
        nz = np.flatnonzero(mel[b])
        if nz.size:
            start[b] = nz[0]
            weights.append(mel[b, nz[0]: nz[-1] + 1])
        off[b + 1] = off[b] + (nz[-1] + 1 - nz[0] if nz.size else 0)
    band_w = np.concatenate(weights) if weights else np.zeros(0, np.float32)
    return start, off, np.ascontiguousarray(band_w, np.float32)


# -- the FFT body's host-side tables and its plain twin ----------------------

class FftTables(NamedTuple):
    """Everything the FFT body reads besides the waveform. `m` = n_fft / 2 is
    the length of the complex transform of the even/odd-packed frame."""
    m: int
    radices: tuple          # in-place decimation-in-frequency stages
    window: np.ndarray      # (n_fft,) f64: Hann, zero padded to the centre
    twiddle: np.ndarray     # (m, 2) f64: cos, -sin of 2 pi k / m
    pos: np.ndarray         # (m,) i32: where the stages leave Z[k]
    split: np.ndarray       # (m + 1, 2) f64: cos, -sin of 2 pi k / n_fft
    band_start: np.ndarray  # (n_mels,) i32: first bin of each mel band
    band_off: np.ndarray    # (n_mels + 1,) i32: offsets into band_w
    band_w: np.ndarray      # (nnz,) f32: each band's weights, bin by bin


def stage_plan(m: int) -> tuple:
    """Radix-4 stages, then one radix-2 stage when log2(m) is odd."""
    if m < 2 or m & (m - 1):
        raise ValueError(f"stage_plan: m must be a power of two >= 2, got {m}")
    log2 = m.bit_length() - 1
    return (4,) * (log2 // 2) + (2,) * (log2 % 2)


def stage_permutation(m: int, radices: tuple) -> np.ndarray:
    """pos[k]: the index at which in-place decimation-in-frequency stages of
    the given radices leave output k. With k = p0 + r0 (p1 + r1 (p2 + ...))
    the digit p_s selects sub-block p_s of length L_s / r_s in stage s, so
    pos = sum p_s * m / (r0 ... r_s): the mixed-radix digit reversal."""
    k = np.arange(m)
    pos = np.zeros(m, np.int64)
    length = m
    for r in radices:
        length //= r
        pos += (k % r) * length
        k = k // r
    if length != 1:
        raise ValueError(f"radices {radices} do not multiply to {m}")
    return pos.astype(np.int32)


@functools.lru_cache(maxsize=16)
def _fft_tables(n_fft, win_length, sr, n_mels) -> FftTables:
    m = n_fft // 2
    radices = stage_plan(m)
    window = filters.pad_center(filters.hann_window(win_length), n_fft)
    ang = 2.0 * np.pi * np.arange(m, dtype=np.float64) / m
    twiddle = np.stack([np.cos(ang), -np.sin(ang)], axis=1)
    ang = 2.0 * np.pi * np.arange(m + 1, dtype=np.float64) / n_fft
    split = np.stack([np.cos(ang), -np.sin(ang)], axis=1)
    return FftTables(m, radices, window, twiddle,
                     stage_permutation(m, radices), split,
                     *mel_bands(sr, n_fft, n_mels))


def fft_tables(cfg: FrontendConfig) -> FftTables:
    """The FFT body's tables for `cfg`, all built in float64 on the host
    (the banded mel weights are the fp32 filterbank's values). Raises for a
    config the FFT body does not take."""
    if kernel_body(cfg) != "fft":
        raise ValueError(f"fft_tables: n_fft={cfg.n_fft} is not a power of "
                         f"two in [{_FFT_MIN}, {_FFT_MAX}]")
    if cfg.hop_length < 1:
        raise ValueError(f"fft_tables: hop_length={cfg.hop_length}")
    return _fft_tables(cfg.n_fft, cfg.win_length, cfg.sr, cfg.n_mels)


def _butterflies(z: torch.Tensor, tab) -> torch.Tensor:
    """A kernel's in-place stages on (..., m) complex128, m the length of
    `tab.twiddle`; output k ends at index tab.pos[k]. Radix 4 and 2 as the
    FFT body writes them; any other radix r as the mixed body does, the
    dense r-point DFT y[q] = sum_p a[p] c[p q mod r] with c[t] the table's
    twiddle t m / r."""
    m = tab.twiddle.shape[0]
    tw = torch.from_numpy(tab.twiddle).to(z.device)
    tw = torch.complex(tw[:, 0], tw[:, 1])
    lead = z.shape[:-1]
    length = m
    for r in tab.radices:
        sub = length // r
        x = z.reshape(*lead, m // length, r, sub)
        a = [x[..., q, :] for q in range(r)]
        if r == 4:
            t0, t1, t2, t3 = a[0] + a[2], a[0] - a[2], a[1] + a[3], a[1] - a[3]
            y = [t0 + t2, t1 - 1j * t3, t0 - t2, t1 + 1j * t3]
        elif r == 2:
            y = [a[0] + a[1], a[0] - a[1]]
        else:
            c = [tw[t * (m // r)] for t in range(r)]
            y = [sum(a[p] * c[(p * q) % r] for p in range(r))
                 for q in range(r)]
        j = torch.arange(sub, device=z.device)
        y = [y[0]] + [y[p] * tw[(p * j * (m // length)) % m]
                      for p in range(1, r)]
        z = torch.stack(y, dim=-2).reshape(*lead, m)
        length = sub
    return z


def fft_spectrum_plain(frames: torch.Tensor, tab: FftTables) -> torch.Tensor:
    """(..., n_fft) float64 unwindowed frames -> (..., m + 1) complex128
    windowed rDFT, by the FFT body's decomposition: window, pack even/odd
    samples into m complex points, the in-place stages, the read through
    `pos`, and the split pass X[k] = E[k] + w^k O[k] with E = (Z[k] +
    conj Z[m-k]) / 2 and O = -i (Z[k] - conj Z[m-k]) / 2."""
    m = tab.m
    x = frames * torch.from_numpy(tab.window).to(frames.device)
    z = _butterflies(torch.complex(x[..., 0::2], x[..., 1::2]), tab)
    pos = torch.from_numpy(tab.pos.astype(np.int64)).to(frames.device)
    k = torch.arange(m + 1, device=frames.device)
    za = z[..., pos[k % m]]
    zb = torch.conj(z[..., pos[(m - k) % m]])
    split = torch.from_numpy(tab.split).to(frames.device)
    wk = torch.complex(split[:, 0], split[:, 1])
    return 0.5 * (za + zb) + wk * (-0.5j) * (za - zb)


def mel_power_fft_plain(waves: torch.Tensor,
                        cfg: FrontendConfig) -> torch.Tensor:
    """(B, L) waves -> (B, T, n_mels) float32 mel power through the FFT
    body's decomposition in float64; like the kernel, the power is rounded
    to fp32 once and the fp32 mel weights are used."""
    tab = fft_tables(cfg)
    n_frames = cfg.num_frames(waves.shape[-1])
    frames = frame_signal(center_pad(waves.double(), cfg), n_frames,
                          cfg.n_fft, cfg.hop_length)
    spec = fft_spectrum_plain(frames, tab)
    power = (spec.real ** 2 + spec.imag ** 2).float()
    mel_t = device_constants(cfg, waves.device)[2]
    return (power.double() @ mel_t.double()).float()


class MixedTables(NamedTuple):
    """Everything the mixed body reads besides the waveform. The complex
    transform has length n = n_fft and carries two frames."""
    n: int
    radices: tuple          # in-place decimation-in-frequency stages
    window: np.ndarray      # (n,) f64: Hann, zero padded to the centre
    twiddle: np.ndarray     # (n, 2) f64: cos, -sin of 2 pi k / n; exact at
    #                         the quarter turns. Radix r's coefficients are
    #                         entries t n / r.
    pos: np.ndarray         # (n,) i32: where the stages leave Z[k]
    band_start: np.ndarray  # (n_mels,) i32
    band_off: np.ndarray    # (n_mels + 1,) i32
    band_w: np.ndarray      # (nnz,) f32


def _unit_roots(n: int) -> np.ndarray:
    """(n, 2) f64: cos, -sin of 2 pi k / n, with the quarter turns exact (so
    a radix-4 or radix-2 stage multiplies by exact 0 and +-1)."""
    k = np.arange(n)
    ang = 2.0 * np.pi * k / n
    roots = np.stack([np.cos(ang), -np.sin(ang)], axis=1)
    quarter = (4 * k) % n == 0
    exact = np.array([[1.0, 0.0], [0.0, -1.0], [-1.0, 0.0], [0.0, 1.0]])
    roots[quarter] = exact[(4 * k[quarter]) // n]
    return roots


@functools.lru_cache(maxsize=16)
def _mixed_tables(n_fft, win_length, sr, n_mels) -> MixedTables:
    radices = mixed_plan(n_fft)
    window = filters.pad_center(filters.hann_window(win_length), n_fft)
    return MixedTables(n_fft, radices, window, _unit_roots(n_fft),
                       stage_permutation(n_fft, radices),
                       *mel_bands(sr, n_fft, n_mels))


def mixed_tables(cfg: FrontendConfig) -> MixedTables:
    """The mixed body's tables for `cfg`, all built in float64 on the host
    (the banded mel weights are the fp32 filterbank's values). Raises for a
    config the mixed body does not take."""
    if kernel_body(cfg) != "mixed":
        raise ValueError(f"mixed_tables: n_fft={cfg.n_fft} is not a "
                         f"product of 2, 3, 5 and 7 in [{_FFT_MIN}, "
                         f"{_FFT_MAX}] other than a power of two")
    if cfg.hop_length < 1:
        raise ValueError(f"mixed_tables: hop_length={cfg.hop_length}")
    return _mixed_tables(cfg.n_fft, cfg.win_length, cfg.sr, cfg.n_mels)


def mixed_spectrum_plain(frames: torch.Tensor,
                         tab: MixedTables) -> torch.Tensor:
    """(rows, n) float64 unwindowed frames -> (rows, n // 2 + 1) complex128
    windowed rDFT, by the mixed body's decomposition: window, pack rows 2q
    and 2q + 1 into one complex transform z = x_2q + i x_2q+1 (a zero row
    completes an odd count), the in-place stages, the read through `pos`,
    and the separation X_2q[k] = (Z[k] + conj Z[n-k]) / 2, X_2q+1[k] =
    -i (Z[k] - conj Z[n-k]) / 2."""
    n, rows = tab.n, frames.shape[0]
    x = frames * torch.from_numpy(tab.window).to(frames.device)
    if rows % 2:
        x = torch.cat([x, x.new_zeros(1, n)])
    z = _butterflies(torch.complex(x[0::2], x[1::2]), tab)
    pos = torch.from_numpy(tab.pos.astype(np.int64)).to(frames.device)
    k = torch.arange(n // 2 + 1, device=frames.device)
    za = z[:, pos[k]]
    zb = torch.conj(z[:, pos[(n - k) % n]])
    spec = torch.stack([0.5 * (za + zb), -0.5j * (za - zb)], dim=1)
    return spec.reshape(-1, n // 2 + 1)[:rows]


def mel_power_mixed_plain(waves: torch.Tensor,
                          cfg: FrontendConfig) -> torch.Tensor:
    """(B, L) waves -> (B, T, n_mels) float32 mel power through the mixed
    body's decomposition in float64 (frames paired across the flattened
    (B * T) rows, as the kernel pairs them); the power is rounded to fp32
    once and the fp32 mel weights are used."""
    tab = mixed_tables(cfg)
    b = waves.shape[0]
    n_frames = cfg.num_frames(waves.shape[-1])
    frames = frame_signal(center_pad(waves.double(), cfg), n_frames,
                          cfg.n_fft, cfg.hop_length)
    spec = mixed_spectrum_plain(frames.reshape(b * n_frames, cfg.n_fft), tab)
    power = (spec.real ** 2 + spec.imag ** 2).float()
    mel_t = device_constants(cfg, waves.device)[2]
    mel = (power.double() @ mel_t.double()).float()
    return mel.reshape(b, n_frames, cfg.n_mels)


def pairs_per_block(rows: int, n: int, sm_count: int) -> int:
    """Frame pairs one block of the mixed body takes: the most of 8, 4, 2, 1
    whose shared memory lets two blocks share an SM and that still gives
    every SM two blocks; 1 when the batch is too small for that."""
    for p in _MIXED_PAIRS:
        if 2 * _mixed_smem(p, n) <= _SMEM_MAX and \
                -(-rows // (2 * p)) >= 2 * sm_count:
            return p
    return 1


def _mixed_smem(pairs: int, n: int) -> int:
    """Shared memory of a mixed-body block (csrc/mixed_fft_power_mel.cu):
    the complex points (an even n spreads index i to i + i / 8) and two
    fp32 power rows a pair."""
    zlen = n + (n - 1) // 8 if n % 2 == 0 else n
    return pairs * (zlen * 16 + 2 * (n // 2 + 1 + 3) * 4)


def frames_per_block(rows: int, m: int, sm_count: int) -> int:
    """Frames one block of the FFT body takes: the most of 4, 2, 1 whose
    shared memory lets two blocks share an SM and that still gives every SM
    two blocks; 1 when the batch is too small for that."""
    for f in _FFT_FRAMES:
        smem = f * ((m + m // 8) * 16 + (m + 4) * 4)
        if 2 * smem <= _SMEM_MAX and -(-rows // f) >= 2 * sm_count:
            return f
    return 1


@functools.lru_cache(maxsize=16)
def _device_fft_tables(cfg: FrontendConfig, device: torch.device):
    tab = fft_tables(cfg)
    arrays = (tab.window, tab.twiddle, tab.split, tab.pos, tab.band_start,
              tab.band_off, tab.band_w)
    return tab, tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                      for a in arrays)


@functools.lru_cache(maxsize=16)
def _device_mixed_tables(cfg: FrontendConfig, device: torch.device):
    tab = mixed_tables(cfg)
    arrays = (tab.window, tab.twiddle, tab.pos, tab.band_start, tab.band_off,
              tab.band_w)
    return tab, tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                      for a in arrays)


# -- the kernels --------------------------------------------------------------

@functools.cache
def _dense_kernel():
    lib = load_library("dft_power_mel")
    fn = lib.asr_dft_power_mel
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _fft_kernel():
    lib = load_library("fft_power_mel")
    fn = lib.asr_fft_power_mel
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _mixed_kernel():
    lib = load_library("mixed_fft_power_mel")
    fn = lib.asr_mixed_fft_power_mel
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=16)
def _padded_constants(cfg: FrontendConfig, device: torch.device):
    """The dense body's Cr, Ci (n_fft_pad, n_freq_pad) and Mel^T (n_freq_pad,
    128), zero padded to whole kernel tiles, on `device` once per (cfg,
    device). Padded DFT rows meet zeros and padded bins meet zero mel rows,
    so the padding adds exact zeros."""
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


def _launch_dense(ypad, out, b, n_frames, cfg):
    cr_p, ci_p, mel_p = _padded_constants(cfg, ypad.device)
    return _dense_kernel()(
        ypad.data_ptr(), cr_p.data_ptr(), ci_p.data_ptr(), mel_p.data_ptr(),
        out.data_ptr(), b, ypad.shape[1], n_frames, cfg.hop_length, cfg.n_fft,
        cr_p.shape[0], cr_p.shape[1],
        torch.cuda.current_stream(ypad.device).cuda_stream)


def _launch_fft(ypad, out, b, n_frames, cfg):
    tab, dev_tabs = _device_fft_tables(cfg, ypad.device)
    sms = torch.cuda.get_device_properties(ypad.device).multi_processor_count
    radices = (ctypes.c_int * len(tab.radices))(*tab.radices)
    return _fft_kernel()(
        ypad.data_ptr(), *[t.data_ptr() for t in dev_tabs], out.data_ptr(),
        b, ypad.shape[1], n_frames, cfg.hop_length, cfg.n_fft, radices,
        len(tab.radices), frames_per_block(b * n_frames, tab.m, sms),
        torch.cuda.current_stream(ypad.device).cuda_stream)


def _launch_mixed(ypad, out, b, n_frames, cfg):
    tab, dev_tabs = _device_mixed_tables(cfg, ypad.device)
    sms = torch.cuda.get_device_properties(ypad.device).multi_processor_count
    radices = (ctypes.c_int * len(tab.radices))(*tab.radices)
    return _mixed_kernel()(
        ypad.data_ptr(), *[t.data_ptr() for t in dev_tabs], out.data_ptr(),
        b, ypad.shape[1], n_frames, cfg.hop_length, cfg.n_fft, radices,
        len(tab.radices), pairs_per_block(b * n_frames, tab.n, sms),
        torch.cuda.current_stream(ypad.device).cuda_stream)


_LAUNCH = {"fft": _launch_fft, "mixed": _launch_mixed, "dense": _launch_dense}


def mel_power_cuda(waves: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """Fused rDFT + power + mel: (B, L) float32 waves -> (B, T, n_mels).

    Applies the librosa center pad, then launches `kernel_body(cfg)` on the
    current stream: the FFT body for a power-of-two n_fft in [32, 4096], the
    mixed body for any other n_fft there whose prime factors are 2, 3, 5 and
    7, the dense body otherwise; each takes any hop >= 1 and any win_length
    <= n_fft.
    A CPU tensor goes to `mel_power_plain`; any other device raises.
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
    if cfg.hop_length < 1 or cfg.win_length > cfg.n_fft:
        raise ValueError(f"mel_power_cuda: need hop_length >= 1 and "
                         f"win_length <= n_fft, got hop {cfg.hop_length}, "
                         f"win {cfg.win_length}, n_fft {cfg.n_fft}")
    b, n_samples = waves.shape
    n_frames = cfg.num_frames(n_samples)
    if b * n_frames == 0:  # nothing to launch
        return torch.empty((b, n_frames, _N_MELS), device=waves.device)
    launch = _LAUNCH[kernel_body(cfg)]
    ypad = center_pad(waves, cfg).contiguous()
    out = torch.empty((b * n_frames, _N_MELS), dtype=torch.float32,
                      device=waves.device)
    # the CUDA runtime launches on its current device: make it the tensor's
    with torch.cuda.device(waves.device):
        rc = launch(ypad, out, b, n_frames, cfg)
    if rc != 0:
        raise RuntimeError(f"{kernel_body(cfg)}_power_mel launch failed: "
                           f"CUDA error {rc}")
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
