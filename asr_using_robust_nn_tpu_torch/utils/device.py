"""The port's device rule: entry points run on the GPU unless the caller asks
for another device."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """`device=None` means the CUDA device and raises where there is none;
    there is no quiet step down to the CPU. Anything else is taken as given
    (`"cpu"`, `"cuda:1"`, a `torch.device`)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the default device is 'cuda' and no CUDA device is available "
            "(torch.cuda.is_available() is False); pass device='cpu' to run "
            "on the CPU")
    return torch.device("cuda")
