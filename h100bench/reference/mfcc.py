"""The reference MFCC in batches: `frontend_ref.mfcc_fixed_length_ref`'s
arithmetic as plain PyTorch on whole one-second rows, so that it runs on the
card over a corpus. float64 throughout; `dtype=torch.float32` is its control
(every step one precision lower)."""

from __future__ import annotations

import torch

from .frontend_ref import dct_matrix, hann_window, mel_filterbank, pad_center

__all__ = ["mfcc_flat"]


def mfcc_flat(waves: torch.Tensor, fe: dict,
              dtype: torch.dtype = torch.float64,
              block: int = 512) -> torch.Tensor:
    """(B, width) waves -> (B, n_mfcc * utterance_length) float32 MFCCs in
    the artifact layout (coefficient-major), computed in `dtype` over blocks
    of `block` rows."""
    n_fft, hop = fe["n_fft"], fe["hop_length"]
    dev = waves.device
    win = torch.as_tensor(pad_center(hann_window(fe["win_length"]), n_fft),
                          dtype=dtype, device=dev)
    mel = torch.as_tensor(mel_filterbank(fe["sr"], n_fft, fe["n_mels"]).T,
                          dtype=dtype, device=dev)
    dct = torch.as_tensor(dct_matrix(fe["n_mfcc"], fe["n_mels"]).T,
                          dtype=dtype, device=dev)
    t_out = fe["utterance_length"]
    out = []
    for i in range(0, waves.shape[0], block):
        y = waves[i:i + block].to(dtype)
        y = torch.nn.functional.pad(y, (n_fft // 2, n_fft // 2))
        frames = y.unfold(-1, n_fft, hop) * win
        power = torch.fft.rfft(frames, dim=-1).abs() ** 2
        log_spec = 10.0 * torch.log10(torch.clamp(power @ mel, min=1e-10))
        top = log_spec.amax(dim=(1, 2), keepdim=True)
        m = torch.maximum(log_spec, top - 80.0) @ dct  # (b, T, n_mfcc)
        t = m.shape[1]
        m = m[:, :t_out] if t >= t_out else torch.nn.functional.pad(
            m, (0, 0, 0, t_out - t))
        out.append(m.transpose(1, 2).reshape(m.shape[0], -1).float())
    return torch.cat(out)
