"""The port's device rule: entry points run on the GPU unless the caller asks
for another device."""

from __future__ import annotations

import os

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None, local_rank: int | None = None) -> torch.device:
    """`device=None` means the CUDA device and raises where there is none;
    there is no quiet step down to the CPU. Under a process group (or with
    `local_rank` given) it is the rank's card, `cuda:{LOCAL_RANK %
    device_count}`. Anything else is taken as given (`"cpu"`, `"cuda:1"`, a
    `torch.device`)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the default device is 'cuda' and no CUDA device is available "
            "(torch.cuda.is_available() is False); pass device='cpu' to run "
            "on the CPU")
    if local_rank is None and torch.distributed.is_available() \
            and torch.distributed.is_initialized():
        local_rank = int(os.environ.get("LOCAL_RANK",
                                        torch.distributed.get_rank()))
    if local_rank is None:
        return torch.device("cuda")
    return torch.device("cuda", local_rank % torch.cuda.device_count())
