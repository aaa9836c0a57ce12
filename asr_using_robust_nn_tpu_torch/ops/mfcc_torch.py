"""Batched MFCC frontend in plain PyTorch: the counterpart of the JAX
package's `ops/mfcc_xla.py`.

    frames F (B, T, n_fft)                        # strided view, no gather
    P  = (F @ Cr)^2 + (F @ Ci)^2                  # windowed rDFT as 2 GEMMs
    M  = P @ MelW^T                               # mel projection
    D  = power_to_db(M)  (per-utterance max)      # elementwise + reduce
    C  = D @ Dct^T                                # cepstral projection

`mfcc_torch_batch` is the plain pipeline: the rDFT -> power -> mel chain
in fp32 GEMMs (`mel_power_plain`), then the dB/DCT finish. With
`cfg.dft_split_levels = L > 0` the rDFT runs as L radix-2 decimation-in-time
stages over 2^L leaf GEMMs of n_fft / 2^L points (`rdft_power_split`, the
JAX package's `_rdft_power_split`). `mfcc_fft_batch` is the same pipeline
with the spectrum from `torch.fft.rfft` of the windowed frames (the JAX
package's `mfcc_fft_batch`). The chain has
hand-written CUDA kernels beside their plain twins in `ops/cuda_mfcc.py`
(fp32 products, fp64 sums), `ops/cuda_mfcc_int8.py` (int8 digits) and
`ops/cuda_mfcc_x3.py` (three-pass bf16); all share `finish_mfcc_from_mel`,
which runs in float64 (see its docstring).

`cfg.dft_algorithm="bf16_x3"` (`FrontendConfig.speaker_fast()`) runs the two
DFT products of `mel_power_plain` as three bf16 passes (`matmul_bf16x3`);
the mel and DCT products stay fp32, as in the JAX package, where the
algorithm applies to the DFT einsums alone.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import filters
from .frontend_ref import num_frames as _num_frames

__all__ = [
    "FrontendConfig",
    "bf16x3_split",
    "matmul_bf16x3",
    "center_pad",
    "frame_signal",
    "finish_mfcc_from_mel",
    "device_constants",
    "mel_power_plain",
    "rdft_power_split",
    "mfcc_torch_batch",
    "mfcc_fft_batch",
]

_DFT_ALGORITHMS = ("bf16_x6", "bf16_x3")


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Static parameters of one MFCC parameterization.

    Presets: `digit()` reproduces `librosa.feature.mfcc(y, sr)` defaults;
    `speaker()` the overrides win_length=441, n_fft=441, hop_length=220.

    The fields equal the JAX package's `FrontendConfig` one for one, so two
    configs compare equal field by field. `precision` and
    `dft_algorithm="bf16_x6"` steer only the JAX package's XLA einsums; the
    port ignores them (its precision is set per path: ops/cuda_mfcc.py).
    The plain path (`mel_power_plain`) honours the other two:
    `dft_algorithm="bf16_x3"` runs its DFT products as three bf16 passes,
    and `dft_split_levels = L > 0` computes the rDFT by L radix-2 stages
    (`rdft_power_split`; needs 2^(L+1) | n_fft and 2^L | hop). The kernels
    compute the same function and ignore the split.
    """

    sr: int = 22050
    n_mfcc: int = 20
    n_mels: int = 128
    n_fft: int = 2048
    hop_length: int = 512
    win_length: int = 2048
    utterance_length: int = 44  # output frames after truncate/pad
    amin: float = 1e-10
    top_db: float = 80.0
    precision: str = "highest"
    dft_algorithm: str | None = None
    pad_mode: str = "constant"  # STFT center padding: librosa >= 0.10
    dft_split_levels: int = 0

    def __post_init__(self):
        if self.dft_algorithm is not None and (
                self.dft_algorithm not in _DFT_ALGORITHMS):
            raise ValueError(
                f"dft_algorithm={self.dft_algorithm!r}: expected one of "
                f"{sorted(_DFT_ALGORITHMS)} or None"
            )

    @staticmethod
    def digit() -> "FrontendConfig":
        return FrontendConfig()

    @staticmethod
    def speaker() -> "FrontendConfig":
        return FrontendConfig(
            n_fft=441, hop_length=220, win_length=441, utterance_length=101,
            dft_algorithm="bf16_x6",
        )

    @staticmethod
    def speaker_fast() -> "FrontendConfig":
        """The speaker preset with the three-pass bf16 DFT: looser parity
        against the f64 oracle (the JAX package states ~2.4e-3 abs on the
        MFCC; its tests hold the class to atol 8e-3, rtol 1e-3). Opt-in."""
        return FrontendConfig(
            n_fft=441, hop_length=220, win_length=441, utterance_length=101,
            dft_algorithm="bf16_x3",
        )

    @property
    def n_freq(self) -> int:
        return filters.n_fft_bins(self.n_fft)

    @property
    def feature_dim(self) -> int:
        return self.n_mfcc * self.utterance_length

    def num_frames(self, n_samples: int) -> int:
        """librosa-exact centered frame count (odd-n_fft aware)."""
        return _num_frames(n_samples, self.hop_length, self.n_fft)

    def constants(self, dtype=np.float32):
        """(Cr, Ci, MelW^T, Dct^T) as numpy arrays."""
        cr, ci = filters.rdft_matrices(self.n_fft, self.win_length)
        mel_t = filters.mel_filterbank(self.sr, self.n_fft, self.n_mels).T
        dct_t = filters.dct_matrix(self.n_mfcc, self.n_mels).T
        return (
            cr.astype(dtype),
            ci.astype(dtype),
            mel_t.astype(dtype),
            dct_t.astype(dtype),
        )


@functools.lru_cache(maxsize=16)
def device_constants(cfg: FrontendConfig, device: torch.device):
    """(Cr, Ci, MelW^T) as float32 and Dct^T as float64 tensors on `device`,
    copied once per (cfg, device)."""
    cr, ci, mel_t, _ = cfg.constants(np.float32)
    dct_t = cfg.constants(np.float64)[3]
    return tuple(torch.from_numpy(np.ascontiguousarray(c)).to(device)
                 for c in (cr, ci, mel_t, dct_t))


def center_pad(waves: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """librosa's center pad: n_fft//2 samples each side, `cfg.pad_mode`."""
    pad = cfg.n_fft // 2
    return F.pad(waves, (pad, pad), mode=cfg.pad_mode)


def frame_signal(ypad: torch.Tensor, n_frames: int, n_fft: int,
                 hop: int) -> torch.Tensor:
    """Frame a (B, Lpad) center-padded batch into (B, n_frames, n_fft).

    Frame t is ypad[:, t*hop : t*hop + n_fft]; a signal too short for
    `n_frames` frames is zero-extended first, as the JAX `frame_signal` does.
    """
    need = (n_frames - 1) * hop + n_fft
    if ypad.shape[-1] < need:
        ypad = F.pad(ypad, (0, need - ypad.shape[-1]))
    return ypad.unfold(-1, n_fft, hop)[:, :n_frames]


def _valid_frames_mask(cfg, lengths, b, n_frames, device):
    """Per-utterance valid-frame mask from true sample lengths, using the
    librosa-exact frame-count formula (odd-n_fft aware)."""
    if lengths is None:
        return torch.ones((b, n_frames), dtype=torch.bool, device=device)
    frame_ids = torch.arange(n_frames, device=device)[None, :]
    true_frames = _num_frames(lengths.to(device)[:, None], cfg.hop_length,
                              cfg.n_fft)
    return frame_ids < true_frames


def finish_mfcc_from_mel(mel, cfg, lengths, b, n_frames, dct_t):
    """dB -> DCT finish with per-utterance masking, shared by the plain and
    kernel paths: (B, T, n_mels) mel power -> (B, n_mfcc, utterance_length)
    float32, given the float64 (n_mels, n_mfcc) `dct_t`.

    Runs in float64 and rounds once at the end. Near-silent frames carry
    |MFCC| ~ 1e3 (c0 of a flat -100 dB floor), where the rounding of an fp32
    log10 and 128-term DCT alone reaches ~1e-3 abs, twice the 5e-4 parity
    bar; the finish is ~1/1000 of the frontend's FLOPs, so f64 costs little.

    Invalid frames are -inf in the per-utterance max and zero in the output,
    so a row with no valid frame comes out as zeros, not NaN."""
    log_spec = 10.0 * torch.log10(torch.clamp(mel.double(), min=cfg.amin))
    valid = _valid_frames_mask(cfg, lengths, b, n_frames, mel.device)
    masked = torch.where(valid[..., None], log_spec, -torch.inf)
    utt_max = torch.amax(masked, dim=(1, 2), keepdim=True)
    db = torch.maximum(log_spec, utt_max - cfg.top_db)
    mfcc = db @ dct_t
    mfcc = torch.where(valid[..., None], mfcc, 0.0)
    t_out = cfg.utterance_length
    if n_frames >= t_out:
        mfcc = mfcc[:, :t_out, :]
    else:
        mfcc = F.pad(mfcc, (0, 0, 0, t_out - n_frames))
    return mfcc.transpose(1, 2).float()  # (B, n_mfcc, T) — reference layout


def bf16x3_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 -> (hi, lo) bf16 with x ~= hi + lo: hi = bf16(x), lo =
    bf16(x - hi), both rounded to nearest even as JAX's astype does."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.float()).to(torch.bfloat16)
    return hi, lo


def matmul_bf16x3(a_hi, a_lo, b_hi, b_lo) -> torch.Tensor:
    """a @ b from split operands as hi@hi + hi@lo + lo@hi, the lo@lo term
    dropped (~2^-16 relative). A product of two bf16 values is exact in
    fp32, so fp32 GEMMs on the bf16 values are bf16 GEMMs with fp32 sums."""
    a_hi, a_lo, b_hi, b_lo = (t.float() for t in (a_hi, a_lo, b_hi, b_lo))
    return a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi


def _dft_product(x, c, cfg):
    """x @ c for the rDFT products: fp32, or three bf16 passes under
    `cfg.dft_algorithm="bf16_x3"`."""
    if cfg.dft_algorithm == "bf16_x3":
        return matmul_bf16x3(*bf16x3_split(x), *bf16x3_split(c))
    return x @ c


@functools.lru_cache(maxsize=16)
def _split_constants(n_fft: int, win_length: int, levels: int,
                     device: torch.device):
    """The radix-2 split's fp32 tensors on `device`: each leaf's windowed
    (n, n/2 + 1) [cos | -sin] DFT, keyed by (offset, step), and each level's
    twiddles e^(-2 pi i k / n), k <= n/2, keyed by n."""
    window = filters.pad_center(filters.hann_window(win_length), n_fft)
    p_count = 1 << levels
    n_leaf = n_fft // p_count
    k = np.arange(n_leaf // 2 + 1, dtype=np.float64)
    nn = np.arange(n_leaf, dtype=np.float64)
    ang = 2.0 * np.pi * nn[:, None] * k[None, :] / n_leaf
    put = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a.astype(np.float32))).to(device)
    leaves = {}
    for offset in range(p_count):
        w_sub = window[offset::p_count][:, None]
        leaves[offset] = (put(np.cos(ang) * w_sub), put(-np.sin(ang) * w_sub))
    twiddles = {}
    n = n_leaf * 2
    while n <= n_fft:
        kk = np.arange(n // 2 + 1, dtype=np.float64)
        twiddles[n] = (put(np.cos(2.0 * np.pi * kk / n)),
                       put(-np.sin(2.0 * np.pi * kk / n)))
        n *= 2
    return leaves, twiddles


def rdft_power_split(ypad: torch.Tensor, n_frames: int, cfg: FrontendConfig
                     ) -> torch.Tensor:
    """|rDFT|^2 of the windowed frames of a center-padded (B, Lpad) batch
    by `cfg.dft_split_levels` radix-2 decimation-in-time stages ->
    (B, T, n_freq): the JAX package's `_rdft_power_split`.

    The stream is de-interleaved once into 2^L phase streams, each framed
    at n_fft / 2^L points and hop / 2^L; each leaf is one windowed DFT GEMM
    over bins 0..n/2; each stage extends its halves to bins 0..m by
    conjugate symmetry and period m and joins them with exact fp32
    butterflies. Needs 2^(L+1) | n_fft (every half length even) and 2^L |
    hop, else ValueError."""
    levels, n_fft, hop = cfg.dft_split_levels, cfg.n_fft, cfg.hop_length
    p_count = 1 << levels
    if n_fft % (p_count * 2) or hop % p_count:
        raise ValueError(
            f"dft_split_levels={levels} needs 2^(levels+1) | n_fft and "
            f"2^levels | hop (got n_fft={n_fft}, hop={hop})")
    leaves, twiddles = _split_constants(n_fft, cfg.win_length, levels,
                                        ypad.device)
    n_sub = n_fft // p_count
    frames = [frame_signal(ypad[:, p::p_count], n_frames, n_sub,
                           hop // p_count) for p in range(p_count)]

    def extend(re, im, m):
        """bins 0..m/2 -> 0..m by conjugate symmetry and period m"""
        half = m // 2
        mirror = torch.arange(half - 1, 0, -1, device=re.device)
        return (torch.cat([re, re[..., mirror], re[..., :1]], -1),
                torch.cat([im, -im[..., mirror], im[..., :1]], -1))

    def rec(offset, step, n, lvl):
        """(re, im), bins 0..n/2 of the windowed x[offset::step], length n"""
        if lvl == 0:
            cr, ci = leaves[offset]
            x = frames[offset]
            return _dft_product(x, cr, cfg), _dft_product(x, ci, cfg)
        m = n // 2
        e_re, e_im = extend(*rec(offset, 2 * step, m, lvl - 1), m)
        o_re, o_im = extend(*rec(offset + step, 2 * step, m, lvl - 1), m)
        tw_re, tw_im = twiddles[n]
        return (e_re + (tw_re * o_re - tw_im * o_im),
                e_im + (tw_re * o_im + tw_im * o_re))

    re, im = rec(0, 1, n_fft, levels)
    return re * re + im * im


def mel_power_plain(waves: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """(B, L) waves -> (B, T, n_mels) mel power: pad, frame, two fp32 GEMMs
    for the windowed rDFT (three bf16 passes each under
    `cfg.dft_algorithm="bf16_x3"`; `cfg.dft_split_levels` radix-2 stages
    over smaller GEMMs where it is > 0), |.|^2, fp32 mel GEMM. The plain
    twin of the CUDA kernel in ops/cuda_mfcc.py."""
    if waves.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False  # fp32 GEMMs, never TF32
    n_frames = cfg.num_frames(waves.shape[-1])
    cr, ci, mel_t, _ = device_constants(cfg, waves.device)
    ypad = center_pad(waves.float(), cfg)
    if cfg.dft_split_levels > 0:
        return rdft_power_split(ypad, n_frames, cfg) @ mel_t
    frames = frame_signal(ypad, n_frames, cfg.n_fft, cfg.hop_length)
    re = _dft_product(frames, cr, cfg)
    im = _dft_product(frames, ci, cfg)
    return (re * re + im * im) @ mel_t


@functools.lru_cache(maxsize=16)
def _window(cfg: FrontendConfig, device: torch.device) -> torch.Tensor:
    """The Hann window centred in n_fft, fp32 on `device`."""
    w = filters.pad_center(filters.hann_window(cfg.win_length), cfg.n_fft)
    return torch.from_numpy(w.astype(np.float32)).to(device)


def mfcc_fft_batch(waves: torch.Tensor, cfg: FrontendConfig,
                   lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Batched MFCC with the spectrum from `torch.fft.rfft`: pad, frame,
    window, rfft, |.|^2, fp32 mel GEMM, then the f64 finish; the contract of
    `mfcc_torch_batch`. Plain PyTorch (cuFFT on the card): the JAX package's
    `mfcc_fft_batch`."""
    if waves.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False  # fp32 GEMMs, never TF32
    b, n_samples = waves.shape
    n_frames = cfg.num_frames(n_samples)
    _, _, mel_t, dct_t = device_constants(cfg, waves.device)
    frames = frame_signal(center_pad(waves.float(), cfg), n_frames,
                          cfg.n_fft, cfg.hop_length)
    spec = torch.fft.rfft(frames * _window(cfg, waves.device), dim=-1)
    power = spec.real * spec.real + spec.imag * spec.imag
    return finish_mfcc_from_mel(power @ mel_t, cfg, lengths, b, n_frames,
                                dct_t)


def mfcc_torch_batch(waves: torch.Tensor, cfg: FrontendConfig,
                     lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Batched MFCC: (B, L) float32 waveforms -> (B, n_mfcc, utterance_length).

    `lengths` (B,) marks the true sample count of each zero-padded waveform;
    frames past the librosa frame count of that length are excluded from the
    top_db max and zeroed in the output.
    """
    b, n_samples = waves.shape
    mel = mel_power_plain(waves, cfg)
    dct_t = device_constants(cfg, waves.device)[3]
    return finish_mfcc_from_mel(mel, cfg, lengths, b,
                                cfg.num_frames(n_samples), dct_t)
