"""K1's wrapper (asr_using_robust_nn_tpu_torch/ops/cuda_mfcc.py) on the card:
what it refuses, and the empty batch it answers without a launch.

K1's numerics on the card (against its plain twin, an f64 chain, the f64
oracle and the golden vectors, at every serving bucket) are checked by
`python3 chip_smoke.py`, the one copy of that check.

Needs an NVIDIA Hopper GPU and nvcc; every test skips without a CUDA device.
On such a machine (no JAX needed, hence no suite conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import pytest
import torch

from asr_using_robust_nn_tpu_torch.ops.cuda_mfcc import mel_power_cuda
from asr_using_robust_nn_tpu_torch.ops.mfcc_torch import FrontendConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def test_k1_rejects_what_it_does_not_take(dev):
    cfg = FrontendConfig.digit()
    w = torch.zeros((2, 22050), device=dev)
    with pytest.raises(ValueError, match="float32"):
        mel_power_cuda(w.double(), cfg)
    with pytest.raises(ValueError, match="contiguous"):
        mel_power_cuda(torch.zeros((22050, 2), device=dev).t(), cfg)
    before = mel_power_cuda.launches
    empty = mel_power_cuda(w[:0], cfg)
    assert empty.shape == (0, cfg.num_frames(22050), 128)
    assert mel_power_cuda.launches == before
