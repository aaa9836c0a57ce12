"""The frontend kernels' wrappers on the card (K1 ops/cuda_mfcc.py, K4
ops/cuda_mfcc_int8.py, K5 ops/cuda_mfcc_x3.py of
asr_using_robust_nn_tpu_torch): what they refuse, and the empty batch they
answer without a launch.

The kernels' numerics on the card (against their plain twins, an f64 chain,
the f64 oracle and the golden vectors, at every batch size) are checked by
`python3 chip_smoke.py`, the one copy of that check.

Needs an NVIDIA Hopper GPU and nvcc; every test skips without a CUDA device.
On such a machine (no JAX needed, hence no suite conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import dataclasses

import pytest
import torch

from asr_using_robust_nn_tpu_torch.ops.cuda_mfcc import mel_power_cuda
from asr_using_robust_nn_tpu_torch.ops.cuda_mfcc_int8 import (
    mel_power_int8_cuda,
)
from asr_using_robust_nn_tpu_torch.ops.cuda_mfcc_x3 import (
    mel_power_bf16x3_cuda,
)
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


@pytest.mark.parametrize("wrapper", [mel_power_int8_cuda,
                                     mel_power_bf16x3_cuda],
                         ids=["K4", "K5"])
def test_k4_k5_reject_what_they_do_not_take(dev, wrapper):
    cfg = FrontendConfig.speaker()
    w = torch.zeros((2, 22050), device=dev)
    with pytest.raises(ValueError, match="float32"):
        wrapper(w.double(), cfg)
    with pytest.raises(ValueError, match="float32"):
        wrapper(w[0], cfg)  # rank 1
    with pytest.raises(ValueError, match="contiguous"):
        wrapper(torch.zeros((22050, 2), device=dev).t(), cfg)
    with pytest.raises(ValueError, match="mel"):
        wrapper(w, dataclasses.replace(cfg, n_mels=64))
    before = wrapper.launches
    empty = wrapper(w[:0], cfg)
    assert empty.shape == (0, cfg.num_frames(22050), 128)
    assert wrapper.launches == before
    out = wrapper(w, cfg)  # a silent batch launches and gives zeros
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert out.shape == (2, cfg.num_frames(22050), 128) and not out.any()


def test_k1_bodies_and_what_the_config_refuses(dev):
    """The FFT body answers the digit preset, the mixed body the speaker
    preset, the dense body a prime n_fft, each with one launch; a hop below
    1 or a window longer than n_fft is refused before any launch."""
    from asr_using_robust_nn_tpu_torch.ops.cuda_mfcc import kernel_body

    w = torch.zeros((2, 22050), device=dev)
    prime = dataclasses.replace(FrontendConfig.speaker(), n_fft=401,
                                win_length=401, hop_length=161)
    for cfg, body in ((FrontendConfig.digit(), "fft"),
                      (FrontendConfig.speaker(), "mixed"), (prime, "dense")):
        assert kernel_body(cfg) == body
        before = mel_power_cuda.launches
        out = mel_power_cuda(w, cfg)  # a silent batch gives zeros
        torch.cuda.synchronize()
        assert mel_power_cuda.launches == before + 1
        assert out.shape == (2, cfg.num_frames(22050), 128) and not out.any()
    before = mel_power_cuda.launches
    with pytest.raises(ValueError, match="hop_length"):
        mel_power_cuda(w, dataclasses.replace(FrontendConfig.digit(),
                                              hop_length=0))
    with pytest.raises(ValueError, match="win_length"):
        mel_power_cuda(w, dataclasses.replace(FrontendConfig.digit(),
                                              win_length=4096))
    with pytest.raises(ValueError, match="mel"):
        mel_power_cuda(w, dataclasses.replace(FrontendConfig.digit(),
                                              n_mels=64))
    assert mel_power_cuda.launches == before


def test_k2_rejects_what_it_does_not_take(dev):
    from asr_using_robust_nn_tpu_torch.ops.cuda_spectral import (
        pi_launch, preload, product_spectral_norm_cuda)

    assert preload() >= 1  # a 16-block cluster can be scheduled here
    ws = [torch.rand((12, 8), device=dev), torch.rand((8, 4), device=dev)]
    u = torch.rand(4, device=dev)
    before = product_spectral_norm_cuda.launches
    with pytest.raises(ValueError, match="float32"):
        product_spectral_norm_cuda(ws, u.double())
    with pytest.raises(ValueError, match="chain"):
        product_spectral_norm_cuda(ws[::-1], u)
    with pytest.raises(ValueError, match="last kernel"):
        product_spectral_norm_cuda(ws, torch.rand(5, device=dev))
    with pytest.raises(ValueError, match="one CUDA device"):
        product_spectral_norm_cuda([w.cpu() for w in ws], u)
    with pytest.raises(ValueError, match="8192"):
        product_spectral_norm_cuda(
            [torch.rand((4, 8200), device=dev),
             torch.rand((8200, 4), device=dev)], u)
    with pytest.raises(ValueError, match="layers"):
        product_spectral_norm_cuda(
            [torch.rand((4, 4), device=dev) for _ in range(17)], u)
    assert product_spectral_norm_cuda.launches == before
    # the rescale needs bf16 kernels: the C entry refuses fp32 ones
    sigma = torch.empty(1, device=dev)
    with pytest.raises(RuntimeError, match="launch failed"):
        pi_launch(ws, u, u.clone(), sigma, 4, rho=0.1)
    sig, u2 = product_spectral_norm_cuda(ws, u, n_iter=0)
    torch.cuda.synchronize()
    assert product_spectral_norm_cuda.launches == before + 1
    assert torch.isfinite(sig) and abs(float(u2.norm()) - 1.0) < 1e-5
