"""Frontend dispatcher: one API over the port's MFCC paths.

Usage:
    fe = Frontend(FrontendConfig.digit())    # backend='auto', on the GPU
    feats = fe(waves)                        # (B, 20, 44)
    flat = fe.flat(waves)                    # (B, 880)

`device=None` is the CUDA device and raises where there is none; pass
`device="cpu"` to run on the CPU, where every kernel wrapper runs its plain
twin.

Backends (all share the float64 dB/DCT finish):
    'cuda'         the K1 kernel (ops/cuda_mfcc.py): fp32 rDFT products
                   summed in fp64 -> power -> mel; 'auto' on the card.
    'plain'        the same pipeline in plain fp32 PyTorch
                   (ops/mfcc_torch.py); honours dft_algorithm="bf16_x3" and
                   dft_split_levels (the radix-2 split).
    'fft'          the spectrum from torch.fft.rfft (ops/mfcc_torch.py
                   `mfcc_fft_batch`), plain PyTorch.
    'int8'         the int8 digit decomposition in plain PyTorch
                   (ops/mfcc_int8.py): exact integer rDFT products.
    'hopdft'       the hop-block rDFT (ops/mfcc_hopdft.py): one fp32 GEMM a
                   hop-sized block, exact phase combine, Hann as 3 taps.
    'hopdft_int8'  the same with the int8 digit products and an exact int32
                   combine (needs hop | n_fft, n_fft / hop in {1, 2, 4}).
    'cuda_int8'    the K4 kernel (ops/cuda_mfcc_int8.py): the int8
                   decomposition fused on the int8 tensor cores.
    'cuda_bf16x3'  the K5 kernel (ops/cuda_mfcc_x3.py): every product as
                   three bf16 passes; looser parity (atol 8e-3, rtol 1e-3
                   against the f64 oracle), built for the speaker preset.
    'auto'         a table lookup from the device and the config alone,
                   never a fallback on a failure: on a CUDA device, for the
                   digit and speaker presets, the fastest backend of the
                   table below whose MFCC holds 5e-4 abs on
                   tests/golden_mfcc.npz; any other config on the card, and
                   every config on the CPU, 'cuda' (on a CPU tensor its
                   wrapper runs the plain fp32 twin).

The table: each backend's whole call (waves on the card -> MFCC) at 1024
one-second rows and its largest |error| on tests/golden_mfcc.npz, on an
NVIDIA H100 80GB HBM3 at 700.00 W (`chip_smoke.py`'s frontend-alternates
phase; the JAX package's table was measured on a TPU and is not inherited):

    preset   backend        ms     golden |err|   holds 5e-4
    digit    cuda           1.413  1.50e-05       yes   <- auto
             fft            1.782  2.08e-04       yes
             cuda_bf16x3    3.383  3.19e-03       no
             cuda_int8      4.154  1.32e-03       no
             hopdft        11.766  9.15e-05       yes
             plain         14.024  4.08e-04       yes
             hopdft_int8   60.754  5.50e-04       no
             int8         397.668  1.32e-03       no
    speaker  cuda_bf16x3    1.007  1.09e-02       no
             cuda           1.240  3.42e-05       yes   <- auto
             fft            1.452  4.67e-04       yes
             cuda_int8      2.342  4.64e-03       no
             plain          2.640  5.99e-04       no
             hopdft         4.539  2.92e-04       yes
             int8          15.433  4.64e-03       no
             (hopdft_int8 refuses the speaker preset: 441 / 220)

The fp32 dense chain ('plain') holds the bar at the digit preset on the card
(cuBLAS sums) but reads 6.2e-4 on the CPU; the rfft chain holds it at both
presets, 1.26x and 1.17x slower than K1.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cuda_mfcc import mfcc_cuda_batch
from ..ops.cuda_mfcc_int8 import mfcc_cuda_int8_batch
from ..ops.cuda_mfcc_x3 import mfcc_cuda_bf16x3_batch
from ..ops.mfcc_hopdft import (mfcc_hopdft_batch, mfcc_hopdft_int8_batch,
                                validate_hopdft)
from ..ops.mfcc_int8 import mfcc_int8_batch
from ..ops.mfcc_torch import FrontendConfig, mfcc_fft_batch, mfcc_torch_batch
from ..utils.device import resolve_device

__all__ = ["Frontend", "to_float_waves", "auto_backend", "H100_TABLE",
           "GOLDEN_BAR"]

GOLDEN_BAR = 5e-4  # the MFCC bar `auto` holds a backend to, on the goldens

# (ms a call at 1024 rows, max |err| on tests/golden_mfcc.npz) per preset
# and backend; the module docstring gives the card and the source
H100_TABLE = {
    "digit": {"cuda": (1.413, 1.50e-05), "fft": (1.782, 2.08e-04),
              "cuda_bf16x3": (3.383, 3.19e-03),
              "cuda_int8": (4.154, 1.32e-03), "hopdft": (11.766, 9.15e-05),
              "plain": (14.024, 4.08e-04), "hopdft_int8": (60.754, 5.50e-04),
              "int8": (397.668, 1.32e-03)},
    "speaker": {"cuda_bf16x3": (1.007, 1.09e-02), "cuda": (1.240, 3.42e-05),
                "fft": (1.452, 4.67e-04), "cuda_int8": (2.342, 4.64e-03),
                "plain": (2.640, 5.99e-04), "hopdft": (4.539, 2.92e-04),
                "int8": (15.433, 4.64e-03)},
}


def auto_backend(cfg: FrontendConfig, device: torch.device) -> str:
    """`backend="auto"` resolved from the device and the config alone: on a
    CUDA device and a preset of `H100_TABLE`, the fastest backend whose
    golden error holds `GOLDEN_BAR`; else 'cuda'."""
    if device.type != "cuda":
        return "cuda"
    preset = next((name for name in H100_TABLE
                   if getattr(FrontendConfig, name)() == cfg), None)
    if preset is None:
        return "cuda"
    held = [(ms, name) for name, (ms, err) in H100_TABLE[preset].items()
            if err <= GOLDEN_BAR]
    return min(held)[1]

_PCM_SCALE = np.float32(1 / 32768)


def to_float_waves(waves, device) -> torch.Tensor:
    """(B, L) numpy array or tensor -> float32 tensor on `device`.

    int16 input is PCM: it crosses to the device as int16 (half the bytes)
    and is dequantized there as int16 -> float32 times the power-of-two
    constant 1/32768, which is exact, so the result is bit-identical to
    float32 ingress of waves/32768.
    """
    if isinstance(waves, np.ndarray):
        waves = torch.from_numpy(np.ascontiguousarray(waves))
    waves = waves.to(device)
    if waves.dtype == torch.int16:
        return waves.to(torch.float32) * float(_PCM_SCALE)
    return waves.to(torch.float32).contiguous()


class Frontend:
    """Batched waveform -> MFCC features, reference layout (B, n_mfcc, T)."""

    _BACKENDS = {
        "cuda": mfcc_cuda_batch,
        "plain": mfcc_torch_batch,
        "fft": mfcc_fft_batch,
        "int8": mfcc_int8_batch,
        "hopdft": mfcc_hopdft_batch,
        "hopdft_int8": mfcc_hopdft_int8_batch,
        "cuda_int8": mfcc_cuda_int8_batch,
        "cuda_bf16x3": mfcc_cuda_bf16x3_batch,
    }

    def __init__(self, cfg: FrontendConfig, backend: str = "auto",
                 device=None):
        if backend != "auto" and backend not in self._BACKENDS:
            raise ValueError(f"unknown frontend backend {backend!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        if backend == "auto":
            backend = auto_backend(cfg, self.device)
        if backend.startswith("hopdft"):
            # the domain check at construction, not at the first call
            validate_hopdft(cfg, int8=backend == "hopdft_int8")
        self.backend = backend

    def __call__(self, waves, lengths=None) -> torch.Tensor:
        waves = to_float_waves(waves, self.device)
        if lengths is not None:
            lengths = torch.as_tensor(lengths, dtype=torch.int64,
                                      device=self.device)
        return self._BACKENDS[self.backend](waves, self.cfg, lengths=lengths)

    def flat(self, waves, lengths=None) -> torch.Tensor:
        """Features flattened to (B, n_mfcc * T) — the .npy artifact layout."""
        out = self(waves, lengths=lengths)
        return out.reshape(out.shape[0], -1)
