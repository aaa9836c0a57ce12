"""The frontend kernels' wrappers on the card (K1 ops/cuda_mfcc.py, K4
ops/cuda_mfcc_int8.py, K5 ops/cuda_mfcc_x3.py of
asr_using_robust_nn_tpu_torch): what they refuse, and the empty batch they
answer without a launch. K2 (ops/cuda_spectral.py): what it refuses, each
form against its twin, captured replays, the true widths inside K3's padded
buffers, the parity gate's lockstep on its factors, and one product-form
launch a step in a fit (and K3's one grouped dW + Adam launch a step).

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


# -- K2: each form against its twin, captured, inside padded buffers, in a fit --

K2_CHAINS = {  # widths, and whether pi_plan picks the product (Gram) form
    "digit": ((880, 1024, 512, 256, 128, 64, 10), True),
    "speaker": ((2020, 1024, 512, 256, 128, 64, 20), True),
    "width_10": ((300, 10), True),
    "odd": ((33, 7, 129, 5), True),
    "width_8192": ((64, 8192, 32), False),
    "square_8192": ((8192, 8192, 10), False),
}
EPS = 2.220446049250313e-16  # np.spacing(1.0)


def _k2_stack(dev, dims, seed, scale=0.05):
    g = torch.Generator().manual_seed(seed)
    ws = [(torch.rand((a, b), generator=g) * scale).to(dev)
          for a, b in zip(dims[:-1], dims[1:])]
    return ws, torch.randn(dims[-1], generator=g).to(dev)


@pytest.mark.parametrize("chain", K2_CHAINS)
def test_k2_forms_against_their_twins(dev, chain):
    """Each form against its twin bit for bit (sigma and u), bf16 and fp32
    kernels, n_iter 0, 4 and 16: the product form against
    `product_spectral_norm_gram`, the chain form against
    `product_spectral_norm_partitioned` (run on the card)."""
    from asr_using_robust_nn_tpu_torch.ops.cuda_spectral import (
        pi_plan, product_spectral_norm_cuda, product_spectral_norm_gram,
        product_spectral_norm_partitioned)

    dims, gram = K2_CHAINS[chain]
    assert pi_plan(dims).gram == gram
    ws, u0 = _k2_stack(dev, dims, len(dims))
    for bf16 in (True, False):
        for n_iter in (0, 4, 16):
            sig, u = product_spectral_norm_cuda(ws, u0, n_iter,
                                                matvec_bf16=bf16)
            torch.cuda.synchronize()
            if gram:
                s2, u2 = product_spectral_norm_gram(
                    [w.cpu() for w in ws], u0.cpu(), n_iter, EPS, bf16)
            else:
                s2, u2 = product_spectral_norm_partitioned(ws, u0, n_iter,
                                                           EPS, bf16)
            assert torch.equal(sig.cpu(), s2.cpu()), (bf16, n_iter)
            assert torch.equal(u.cpu(), u2.cpu()), (bf16, n_iter)


@pytest.mark.parametrize("chain", ["digit", "speaker", "width_8192"])
def test_k2_captured_replays_are_bit_equal(dev, chain):
    """One projection (bf16, n_iter 16) captured into a CUDA graph and
    replayed twice on the same inputs gives the same bits, in either form."""
    from asr_using_robust_nn_tpu_torch.ops.cuda_spectral import (
        pi_launch, preload)

    ws, u0 = _k2_stack(dev, K2_CHAINS[chain][0], 7)
    w16 = [w.to(torch.bfloat16).contiguous() for w in ws]
    u_out, sg = torch.empty_like(u0), torch.empty(1, device=dev)
    preload()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        pi_launch(w16, u0, u_out, sg, 16)
    outs = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        outs.append((sg.clone(), u_out.clone()))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("preset", ["digit_constrained",
                                    "speaker_constrained"])
def test_k2_true_widths_inside_padded_buffers(dev, preset):
    """K3's and K6's buffers (every width padded to 128, zeros beyond the
    kernels; u padded too): K2 at the true widths runs the product form, bit
    for bit its twin on the true kernels, within 1e-3 of the chain form at
    the padded widths in sigma, and writes zeros into u past d_m. With rho
    the rescale covers the whole buffers: their padding stays zero and the
    kernels and masters follow the factor recurrence on the launch's
    sigma."""
    import numpy as np

    from asr_using_robust_nn_tpu_torch.models.mlp import MLPConfig
    from asr_using_robust_nn_tpu_torch.ops.cuda_spectral import (
        pi_launch, pi_plan, product_spectral_norm_gram)
    from asr_using_robust_nn_tpu_torch.ops.cuda_train import FusedStepSpec

    spec = FusedStepSpec(cfg=getattr(MLPConfig, preset)(), batch=64,
                         rho=0.1, pi_iters=16)
    dims, pd, m = spec.dims, spec.pdims, spec.n_layers
    assert pi_plan(dims).gram and not pi_plan(pd).gram
    ws, _ = _k2_stack(dev, dims, 11)
    w16 = []
    for i, w in enumerate(ws):
        buf = torch.zeros((pd[i], pd[i + 1]), dtype=torch.bfloat16,
                          device=dev)
        buf[:dims[i], :dims[i + 1]] = w
        w16.append(buf)
    u = torch.randn(pd[-1], generator=torch.Generator().manual_seed(3))
    u = u.to(dev)  # nonzero past d_m, as pack_state draws it
    u_true, u_pad = u.clone(), u.clone()
    sg_true, sg_pad = torch.empty(1, device=dev), torch.empty(1, device=dev)
    pi_launch(w16, u_true, u_true, sg_true, 16, dims=dims)
    pi_launch(w16, u_pad, u_pad, sg_pad, 16)
    torch.cuda.synchronize()
    s2, u2 = product_spectral_norm_gram(
        [b.float()[:dims[i], :dims[i + 1]].cpu() for i, b in enumerate(w16)],
        u[:dims[-1]].cpu(), 16, EPS, True)
    assert torch.equal(sg_true.cpu()[0], s2)
    assert torch.equal(u_true[:dims[-1]].cpu(), u2)
    assert not u_true[dims[-1]:].any() and not u_pad[dims[-1]:].any()
    assert abs(float(sg_true) / float(sg_pad) - 1.0) <= 1e-3

    before = [b.float() for b in w16]
    masters = [b.clone() for b in before]
    pi_launch(w16, u, u, sg_true, 16, rho=0.1, masters=masters, dims=dims)
    torch.cuda.synchronize()
    s = float(sg_true)
    for i in range(m):
        f = float(np.exp(np.log(0.1 / (s + EPS)) * np.float32(1.0 / m)))
        s *= f
        top = float(before[i].abs().max()) * f
        assert not masters[i][dims[i]:].any()
        assert not masters[i][:, dims[i + 1]:].any()
        assert not w16[i][dims[i]:].any() and not w16[i][:, dims[i + 1]:].any()
        assert float((masters[i] - before[i] * f).abs().max()) <= 1e-5 * top
        assert float((w16[i].float() - before[i] * f).abs().max()) <= \
            8e-3 * top


@pytest.mark.parametrize("preset,batch", [("digit_constrained", 512),
                                          ("speaker_constrained", 64)])
def test_k2_rescale_f_within_one_bf16_ulp_in_lockstep(dev, preset, batch):
    """A parity gate's epoch (8 steps, the last ragged) of K3 and its twin
    in lockstep: the projection's factors, which K3 forms from the product
    form's sigma while the twin runs the chain, stay within one bf16 ulp of
    their scale at every step."""
    from asr_using_robust_nn_tpu_torch.models.mlp import MLPConfig
    from asr_using_robust_nn_tpu_torch.ops.k3_lockstep import lockstep_on

    cfg = getattr(MLPConfig, preset)()
    g = torch.Generator().manual_seed(5)
    data = torch.randn((8 * batch, cfg.in_dim), generator=g).to(dev)
    labels = torch.randint(0, cfg.n_classes, (8 * batch,), generator=g)
    rows, _ = lockstep_on(dev, cfg, batch, data, labels.to(dev),
                          8 * batch - batch // 3, (1, 2))
    f_rows = [r for r in rows if r["q"] == "rescale f"]
    assert len(f_rows) == 8
    assert max(r["ulps"] for r in f_rows) <= 1.0


@pytest.mark.parametrize("preset,batch,rows,steps", [
    ("digit_constrained", 512, 16566, 33),
    ("speaker_constrained", 64, 8248, 129)])
def test_k2_counts_one_product_form_launch_a_step_in_a_fit(
        dev, tmp_path, preset, batch, rows, steps):
    """A device-resident fit on K3 captures one K2 launch a step, in the
    product form: while a profiler records, the fit's counters read
    `k2.gram` 33 (digit) or 129 (speaker) and no `k2.chain`; and one
    grouped dW + Adam launch a step, `k3.dw_group`, with no per-layer
    `k3.dw_layer`. A first fit runs the parity gate, outside the traced
    one."""
    from asr_using_robust_nn_tpu_torch.constraints import (
        make_simple_norm_constraint)
    from asr_using_robust_nn_tpu_torch.models.mlp import MLPConfig, init_mlp
    from asr_using_robust_nn_tpu_torch.train import TrainConfig, Trainer
    from asr_using_robust_nn_tpu_torch.utils import profiling

    cfg = getattr(MLPConfig, preset)()
    g = torch.Generator().manual_seed(9)
    x = torch.randn((rows + batch, cfg.in_dim), generator=g).numpy()
    y = torch.randint(0, cfg.n_classes, (rows + batch,), generator=g).numpy()
    con = make_simple_norm_constraint(0.1, n_iter=16)
    params, _ = init_mlp(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    trainer = Trainer(cfg, TrainConfig(batch_size=batch, epochs=1,
                                       patience=1, device_resident=True,
                                       epoch_backend="fused"),
                      constraint=con.apply, constraint_state=con.init(params),
                      device=dev)
    split = (x[:rows], y[:rows], x[rows:], y[rows:])
    assert trainer.fit(*split)["epoch_backend"] == "fused"
    with profiling.trace(str(tmp_path)):
        trainer.fit(*split)
    counters = profiling.recorded()["counters"]
    fits = [c for fit, c in counters.items() if fit is not None]
    assert len(fits) == 1
    assert fits[0].get("k2.gram") == steps and "k2.chain" not in fits[0]
    assert fits[0].get("k3.dw_group") == steps
    assert "k3.dw_layer" not in fits[0]
