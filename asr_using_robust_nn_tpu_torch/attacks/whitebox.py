"""White-box attacks on tensors. Counterpart of the JAX package's
`attacks/whitebox.py`; only FGSM is ported so far.

An attack takes `logits_fn(x) -> logits` (a batched closure over trained
params, e.g. `lambda x: apply_mlp(cfg, params, state, x)[0]`), the clean
inputs and the integer labels, and returns adversarial inputs of the same
shape and dtype.
"""

from __future__ import annotations

import torch

__all__ = ["fgsm"]


def _ce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Summed cross-entropy of integer labels."""
    logp = torch.log_softmax(logits, -1)
    return -torch.gather(logp, -1, y[:, None].long()).sum()


def fgsm(logits_fn, x: torch.Tensor, y: torch.Tensor,
         eps: float) -> torch.Tensor:
    """x + eps * sign(grad_x CE): ART's FastGradientMethod, untargeted, no
    clip. sign(0) = 0, as in JAX."""
    xx = x.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(_ce(logits_fn(xx), y), xx)
    return (x + eps * torch.sign(g)).detach()
