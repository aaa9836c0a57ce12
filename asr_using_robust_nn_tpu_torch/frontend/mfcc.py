"""Frontend dispatcher: one API over the port's MFCC paths.

Usage:
    fe = Frontend(FrontendConfig.digit(), device="cuda")   # backend='cuda'
    feats = fe(waves)                                      # (B, 20, 44)
    flat = fe.flat(waves)                                  # (B, 880)

Backends:
    'cuda'   the K1 kernel (ops/cuda_mfcc.py) for the rDFT -> power -> mel
             chain, then the dB/DCT finish. The default. On a CPU device its
             wrapper runs the plain twin.
    'plain'  the same pipeline in plain fp32 PyTorch (ops/mfcc_torch.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cuda_mfcc import mfcc_cuda_batch
from ..ops.mfcc_torch import FrontendConfig, mfcc_torch_batch

__all__ = ["Frontend", "to_float_waves"]

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
    }

    def __init__(self, cfg: FrontendConfig, backend: str = "cuda",
                 device="cpu"):
        if backend not in self._BACKENDS:
            raise ValueError(f"unknown frontend backend {backend!r}")
        self.cfg = cfg
        self.backend = backend
        self.device = torch.device(device)

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
