"""Frontend dispatcher: one API over the port's MFCC paths.

Usage:
    fe = Frontend(FrontendConfig.digit())    # backend='cuda', on the GPU
    feats = fe(waves)                        # (B, 20, 44)
    flat = fe.flat(waves)                    # (B, 880)

`device=None` is the CUDA device and raises where there is none; pass
`device="cpu"` to run on the CPU, where every kernel wrapper runs its plain
twin.

Backends (all share the float64 dB/DCT finish):
    'cuda'         the K1 kernel (ops/cuda_mfcc.py): fp32 rDFT products
                   summed in fp64 -> power -> mel. The default, and the one
                   backend held to 5e-4 abs on the golden vectors.
    'plain'        the same pipeline in plain fp32 PyTorch
                   (ops/mfcc_torch.py); honours dft_algorithm="bf16_x3".
    'int8'         the int8 digit decomposition in plain PyTorch
                   (ops/mfcc_int8.py): exact integer rDFT products.
    'cuda_int8'    the K4 kernel (ops/cuda_mfcc_int8.py): the same
                   decomposition fused on the int8 tensor cores.
    'cuda_bf16x3'  the K5 kernel (ops/cuda_mfcc_x3.py): every product as
                   three bf16 passes; looser parity (atol 8e-3, rtol 1e-3
                   against the f64 oracle), built for the speaker preset.

There is no 'auto': the JAX package's table was measured on a TPU and is not
inherited. PERF.md holds the H100 times of K1, K4 and K5 side by side.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.cuda_mfcc import mfcc_cuda_batch
from ..ops.cuda_mfcc_int8 import mfcc_cuda_int8_batch
from ..ops.cuda_mfcc_x3 import mfcc_cuda_bf16x3_batch
from ..ops.mfcc_int8 import mfcc_int8_batch
from ..ops.mfcc_torch import FrontendConfig, mfcc_torch_batch
from ..utils.device import resolve_device

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
        "int8": mfcc_int8_batch,
        "cuda_int8": mfcc_cuda_int8_batch,
        "cuda_bf16x3": mfcc_cuda_bf16x3_batch,
    }

    def __init__(self, cfg: FrontendConfig, backend: str = "cuda",
                 device=None):
        if backend not in self._BACKENDS:
            raise ValueError(f"unknown frontend backend {backend!r}")
        self.cfg = cfg
        self.backend = backend
        self.device = resolve_device(device)

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
