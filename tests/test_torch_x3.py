"""The port's three-pass bf16 frontend: K5's plain twin
(ops/cuda_mfcc_x3.py) against the Pallas bf16x3 kernel in interpret mode,
the hi/lo split, `FrontendConfig.speaker_fast()` and the plain path's
`dft_algorithm="bf16_x3"`. Inputs are made with numpy from a seed and handed
to both packages; everything runs on the CPU, where K5's wrapper is its
twin.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_using_robust_nn_tpu.ops.mfcc_xla import FrontendConfig as JConfig
from asr_using_robust_nn_tpu.ops.pallas_mfcc import _bf16x3_split as jsplit
from asr_using_robust_nn_tpu.ops.pallas_mfcc import (
    mel_power_bf16x3_pallas,
    mfcc_pallas_bf16x3_batch,
)
from asr_using_robust_nn_tpu_torch.frontend.mfcc import Frontend
from asr_using_robust_nn_tpu_torch.ops import frontend_ref
from asr_using_robust_nn_tpu_torch.ops.cuda_mfcc_x3 import (
    _bf16x3_split,
    _padded_constants,
    mel_power_bf16x3_cuda,
    mel_power_bf16x3_plain,
    mfcc_cuda_bf16x3_batch,
)
from asr_using_robust_nn_tpu_torch.ops.mfcc_torch import (
    FrontendConfig,
    matmul_bf16x3,
    mel_power_plain,
    mfcc_torch_batch,
)

PRESETS = ["digit", "speaker"]


def _configs(preset):
    return getattr(FrontendConfig, preset)(), getattr(JConfig, preset)()


def _batch():
    """Gaussian rows of amplitudes 0.05, 0.3, 1.0 and a silent row, zero
    past per-row lengths."""
    rng = np.random.default_rng(0)
    amps = np.array([0.05, 0.3, 1.0, 0.0])[:, None]
    w = (rng.standard_normal((4, 22050)) * amps).astype(np.float32)
    lens = np.array([22050, 9000, 22050, 22050])
    for i, n in enumerate(lens):
        w[i, n:] = 0.0
    return w, lens


def _oracle(cfg, y):
    return frontend_ref.mfcc_fixed_length_ref(
        y, cfg.utterance_length, n_fft=cfg.n_fft, hop_length=cfg.hop_length,
        win_length=cfg.win_length)


class TestSplit:
    def test_split_equals_jax_and_reconstructs(self):
        """hi and lo equal the JAX split bit for bit (both round to nearest
        even) and hi + lo reconstructs fp32 to 2^-16 relative."""
        rng = np.random.default_rng(1)
        x = (rng.standard_normal(4096) * 10).astype(np.float32)
        hi, lo = _bf16x3_split(torch.from_numpy(x))
        jhi, jlo = jsplit(jnp.asarray(x))
        assert hi.dtype == lo.dtype == torch.bfloat16
        np.testing.assert_array_equal(hi.float().numpy(),
                                      np.asarray(jhi.astype(jnp.float32)))
        np.testing.assert_array_equal(lo.float().numpy(),
                                      np.asarray(jlo.astype(jnp.float32)))
        rec = hi.float().numpy().astype(np.float64) + lo.float().numpy()
        assert (np.abs(rec - x) <= 2.0 ** -16 * np.abs(x)).all()

    def test_three_pass_product_is_fp32_class(self):
        """hi@hi + hi@lo + lo@hi against the float64 product: the dropped
        lo@lo term leaves <= 2^-14 of the row-by-column magnitude; one bf16
        pass alone is 100x worse."""
        rng = np.random.default_rng(2)
        a = rng.standard_normal((32, 441)).astype(np.float32)
        b = rng.standard_normal((441, 64)).astype(np.float32)
        want = a.astype(np.float64) @ b.astype(np.float64)
        scale = np.abs(a).astype(np.float64) @ np.abs(b)
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        got = matmul_bf16x3(*_bf16x3_split(ta), *_bf16x3_split(tb)).numpy()
        one = (_bf16x3_split(ta)[0].float() @ _bf16x3_split(tb)[0].float())
        assert (np.abs(got - want) <= 2.0 ** -14 * scale).all()
        assert np.abs(one.numpy() - want).max() > 100 * np.abs(got - want).max()

    @pytest.mark.parametrize("preset", PRESETS)
    def test_kernel_constants_are_the_padded_transposed_splits(self, preset):
        """K5's operands: the transposed hi/lo constants, zero padded to
        whole 64 x 64 tiles (441 -> 448, not the TPU's 512)."""
        cfg, _ = _configs(preset)
        ct, melt = _padded_constants(cfg, torch.device("cpu"))
        cr, ci, mel_t, _ = (torch.from_numpy(c) for c in cfg.constants())
        assert ct.dtype == melt.dtype == torch.bfloat16
        assert ct.shape == (4, 1088 if preset == "digit" else 256,
                            2048 if preset == "digit" else 448)
        for m, want in enumerate((*_bf16x3_split(cr), *_bf16x3_split(ci))):
            assert torch.equal(ct[m, :cfg.n_freq, :cfg.n_fft], want.T)
        assert not ct[:, cfg.n_freq:].any() and not ct[:, :, cfg.n_fft:].any()
        for h, want in enumerate(_bf16x3_split(mel_t)):
            assert torch.equal(melt[h, :cfg.n_freq], want)
        assert not melt[:, cfg.n_freq:].any()


class TestMelPowerTwin:
    @pytest.mark.parametrize("preset", PRESETS)
    def test_plain_matches_pallas_interpret(self, preset):
        """K5's twin against the Pallas kernel in interpret mode: the same
        nine bf16 products with fp32 sums in different orders (the Pallas
        kernel adds three whole products and accumulates per 256-bin tile):
        rtol 1e-4 plus 1e-8 of the batch's peak, the bar the K1 twin is
        held to."""
        cfg, jcfg = _configs(preset)
        w, _ = _batch()
        got = mel_power_bf16x3_plain(torch.from_numpy(w), cfg).numpy()
        want = np.asarray(mel_power_bf16x3_pallas(w, jcfg, interpret=True))
        assert got.shape == want.shape == (4, cfg.num_frames(22050), 128)
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-8 * want.max())
        assert not got[3].any()  # the silent row
        # on a CPU tensor the kernel wrapper is the twin, and launches nothing
        before = mel_power_bf16x3_cuda.launches
        np.testing.assert_array_equal(
            mel_power_bf16x3_cuda(torch.from_numpy(w), cfg).numpy(), got)
        assert mel_power_bf16x3_cuda.launches == before == 0


class TestMFCC:
    @pytest.mark.parametrize("preset", PRESETS)
    def test_matches_pallas_and_oracle_with_lengths(self, preset):
        """The whole MFCC through K5's twin: against the Pallas bf16x3 path
        (interpret) 1e-3 abs (the finishes differ, f64 here and fp32 there,
        on top of the summation orders); against the f64 oracle atol 8e-3,
        rtol 1e-3, the bar the JAX suite holds its kernel to."""
        cfg, jcfg = _configs(preset)
        w, lens = _batch()
        got = mfcc_cuda_bf16x3_batch(torch.from_numpy(w), cfg,
                                     torch.from_numpy(lens)).numpy()
        want = np.asarray(mfcc_pallas_bf16x3_batch(w, jcfg, lengths=lens,
                                                   interpret=True))
        assert got.shape == (4, cfg.n_mfcc, cfg.utterance_length)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
        for i, n in enumerate(lens):
            np.testing.assert_allclose(got[i], _oracle(cfg, w[i, :n]),
                                       atol=8e-3, rtol=1e-3)

    def test_speaker_fast_config_and_plain_path(self):
        """`speaker_fast()` equals the JAX preset field by field; under it
        the plain path splits the two DFT products only (mel and DCT stay
        fp32), which lands inside K5's class against the oracle and apart
        from the fp32 path."""
        cfg, jcfg = FrontendConfig.speaker_fast(), JConfig.speaker_fast()
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        w, lens = _batch()
        tw = torch.from_numpy(w)
        got = mfcc_torch_batch(tw, cfg, torch.from_numpy(lens)).numpy()
        for i, n in enumerate(lens):
            np.testing.assert_allclose(got[i], _oracle(cfg, w[i, :n]),
                                       atol=8e-3, rtol=1e-3)
        fast = mel_power_plain(tw, cfg)
        full = mel_power_plain(tw, FrontendConfig.speaker())
        assert not torch.equal(fast, full)
        np.testing.assert_allclose(fast.numpy(), full.numpy(), rtol=1e-3,
                                   atol=1e-7 * float(full.max()))

    def test_frontend_backend(self):
        cfg = FrontendConfig.speaker()
        w, lens = _batch()
        a = Frontend(cfg, backend="cuda_bf16x3", device="cpu")(w,
                                                              lengths=lens)
        b = mfcc_cuda_bf16x3_batch(torch.from_numpy(w), cfg,
                                   torch.from_numpy(lens))
        assert torch.equal(a, b)
        flat = Frontend(cfg, backend="cuda_bf16x3", device="cpu").flat(w)
        assert flat.shape == (4, cfg.feature_dim)
