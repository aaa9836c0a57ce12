"""The plain reference against the program's plain CPU path at tiny sizes,
and its batched MFCC against its own frozen numpy oracle."""

import numpy as np
import pytest
import torch

from asr_using_robust_nn_tpu_torch.constraints import \
    make_simple_norm_constraint
from asr_using_robust_nn_tpu_torch.models.mlp import MLPConfig, apply_mlp
from asr_using_robust_nn_tpu_torch.ops.cuda_train import dropout_keep
from asr_using_robust_nn_tpu_torch.train import TrainConfig, Trainer
from h100bench import gen
from h100bench.reference import frontend_ref, mfcc
from h100bench.reference import mlp as ref

FE = {"digit": {"sr": 22050, "n_fft": 2048, "hop_length": 512,
                "win_length": 2048, "n_mels": 128, "n_mfcc": 20,
                "utterance_length": 44},
      "speaker": {"sr": 22050, "n_fft": 441, "hop_length": 220,
                  "win_length": 441, "n_mels": 128, "n_mfcc": 20,
                  "utterance_length": 101}}
SMALL = dict(dims=[40, 32, 16, 8], nonneg=True, batch_norm=True,
             dropout=[0.0, 0.0], bn_eps=1e-3, bn_momentum=0.99)


@pytest.mark.parametrize("task", ["digit", "speaker"])
def test_h100bench_mfcc_matches_the_numpy_oracle(task):
    fe = FE[task]
    waves = gen.digit_waves(np.arange(3), 5, "cpu")
    got = mfcc.mfcc_flat(waves, fe).numpy()
    for i in range(3):
        want = frontend_ref.mfcc_fixed_length_ref(
            waves[i].numpy(), fe["utterance_length"], sr=fe["sr"],
            n_fft=fe["n_fft"], hop_length=fe["hop_length"],
            win_length=fe["win_length"], n_mels=fe["n_mels"])
        np.testing.assert_allclose(got[i], want.reshape(-1).astype(
            np.float32), rtol=0, atol=2e-4)


def test_h100bench_keep_mask_is_the_trainers_draw():
    for seed in (0, 12345, 2 ** 31 - 2):
        for layer in range(3):
            got = ref.keep_mask(seed, layer, 64, 256, 0.9, "cpu")
            want = dropout_keep(torch.tensor(seed, dtype=torch.int32), layer,
                                64, 256, 0.9)
            assert torch.equal(got, want)


def _port_cfg():
    return MLPConfig(in_dim=40, n_classes=8, hidden=(32, 16), nonneg=True,
                     dropout=(0.0, 0.0))


def test_h100bench_forward_matches_the_port():
    model = ref.Model(SMALL)
    params, state = gen.init_params(SMALL["dims"], True, 3, "cpu")
    for s in state[:-1]:
        s["mean"] = torch.rand(s["mean"].shape)
        s["var"] = torch.rand(s["var"].shape) + 0.5
    x = torch.randn(20, 40)
    got, _ = apply_mlp(_port_cfg(), {"layers": params}, {"layers": state}, x)
    want = ref.forward(model, params, state, x)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_h100bench_training_matches_the_ports_plain_epoch():
    """Three epochs of the constrained recipe (dropout 0, a ragged last
    batch) on the port's plain fp32 epoch against the reference."""
    model = ref.Model(SMALL)
    params, state = gen.init_params(SMALL["dims"], True, 4, "cpu")
    x = torch.randn(150, 40)
    y = torch.randint(0, 8, (150,))
    vx, vy = torch.randn(30, 40), torch.randint(0, 8, (30,))
    con = make_simple_norm_constraint(0.5, n_iter=16)
    u0 = torch.randn((1, 128), generator=torch.Generator().manual_seed(23))
    tcfg = TrainConfig(batch_size=32, epochs=3, patience=3, seed=99,
                       device_resident=True, epoch_backend="plain")
    trainer = Trainer(_port_cfg(), tcfg, constraint=con.apply,
                      constraint_state={"u": u0[0, :8].clone()},
                      device="cpu")
    res = trainer.fit(x.numpy(), y.numpy(), vx.numpy(), vy.numpy(),
                      params={"layers": [dict(p) for p in params]},
                      state={"layers": [dict(s) for s in state]})
    want = ref.train_epochs(model, params, state, x, y, vx, vy, batch=32,
                            epochs=3, lr=1e-3, rho=0.5, n_iter=16, seed=99)
    np.testing.assert_allclose(res["history"]["loss"], want["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(res["history"]["val_loss"], want["val_loss"],
                               rtol=1e-5)
    for got, exp in zip(res["params"]["layers"], want["params"]):
        for k in exp:
            torch.testing.assert_close(got[k], exp[k], rtol=1e-4, atol=1e-5)
    for got, exp in zip(res["opt_state"]["mu"]["layers"], want["mu"]):
        torch.testing.assert_close(got["w"], exp["w"], rtol=1e-3, atol=1e-6)


def test_h100bench_fp8_control_rounds_its_products():
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    gap = (ref.mm(a, b, "fp8") - a @ b).abs().max() / (a @ b).abs().max()
    assert 1e-3 < gap < 0.2
    assert torch.equal(ref.mm(a, b, "fp32"), a @ b)
