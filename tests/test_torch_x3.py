"""The port's three-pass bf16 frontend: K5's plain twin
(ops/cuda_mfcc_x3.py) against the Pallas bf16x3 kernel in interpret mode,
the hi/lo split, K5's operand layout and launch plan, the twin summed in the
kernel's order, `FrontendConfig.speaker_fast()` and the plain path's
`dft_algorithm="bf16_x3"`. Inputs are made with numpy from a seed and handed
to both packages; everything runs on the CPU, where K5's wrapper is its
twin.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

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
    _split_constants,
    launch_plan,
    mel_power_bf16x3_cuda,
    mel_power_bf16x3_plain,
    mfcc_cuda_bf16x3_batch,
)
from asr_using_robust_nn_tpu_torch.ops.mfcc_torch import (
    FrontendConfig,
    center_pad,
    frame_signal,
    matmul_bf16x3,
    mel_power_plain,
    mfcc_torch_batch,
)
from chip_smoke import K45_BARS, spread_waves, within

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
        """K5's operands: for hi and lo, groups of 32 bins as [Cr^T | Ci^T]
        row blocks that reassemble into the transposed splits, zero padded
        to whole 64-deep steps and 64-bin chunks (441 -> 448, not the TPU's
        512); Mel hi and lo, bands by bins, zero past the last bin."""
        cfg, _ = _configs(preset)
        ct, melt = _padded_constants(cfg, torch.device("cpu"))
        cr, ci, mel_t, _ = (torch.from_numpy(c) for c in cfg.constants())
        n_freq_pad, n_fft_pad = (1088, 2048) if preset == "digit" else (256,
                                                                        448)
        assert ct.dtype == melt.dtype == torch.bfloat16
        assert ct.shape == (2, n_freq_pad // 32, 64, n_fft_pad)
        assert melt.shape == (2, 128, n_freq_pad)
        splits = (_bf16x3_split(cr), _bf16x3_split(ci))
        for h in range(2):
            for side in range(2):
                got = ct[h, :, 32 * side:32 * side + 32].reshape(n_freq_pad,
                                                                 n_fft_pad)
                assert torch.equal(got[:cfg.n_freq, :cfg.n_fft],
                                   splits[side][h].T)
                assert not got[cfg.n_freq:].any()
                assert not got[:, cfg.n_fft:].any()
        for h, want in enumerate(_bf16x3_split(mel_t)):
            assert torch.equal(melt[h, :, :cfg.n_freq], want.T)
        assert not melt[:, :, cfg.n_freq:].any()


# (config, n_fft_pad, n_freq_pad, copy bytes, frames resident)
PLAN_CONFIGS = {
    "speaker": (FrontendConfig.speaker(), 448, 256, 8, True),
    "digit": (FrontendConfig.digit(), 2048, 1088, 16, False),
    "n400": (dataclasses.replace(FrontendConfig.speaker(), n_fft=400,
                                 win_length=400, hop_length=160),
             448, 256, 16, True),
    "n512": (dataclasses.replace(FrontendConfig.digit(), n_fft=512,
                                 win_length=512, hop_length=128),
             512, 320, 16, True),
    "odd_hop": (dataclasses.replace(FrontendConfig.speaker(),
                                    hop_length=221), 448, 256, 2, True),
}


class TestLaunchPlan:
    @pytest.mark.parametrize("name", list(PLAN_CONFIGS))
    @pytest.mark.parametrize("batch,width", [(1, 22050), (3, 9000),
                                             (1024, 22050), (2, 300)])
    def test_launch_plan(self, name, batch, width):
        """K5's padding, grid, copy width and frame residency: whole 64-deep
        steps and 64-bin chunks; split-signal rows a multiple of 8 (16
        bytes) long that hold the padded signal and every frame's n_fft_pad
        samples; 16-byte copies when every frame starts 16-byte aligned,
        8-byte when it starts 8-byte aligned, else 2-byte loads; the frames
        resident in shared memory up to n_fft_pad 512 (the kernel's 227 KB
        hold 3 ring stages and 8 resident depth slices)."""
        cfg, n_fft_pad, n_freq_pad, copy, resident = PLAN_CONFIGS[name]
        plan = launch_plan(cfg, batch, width)
        assert (plan.n_fft_pad, plan.n_freq_pad) == (n_fft_pad, n_freq_pad)
        assert plan.n_frames == cfg.num_frames(width)
        assert plan.lalloc % 8 == 0
        assert plan.lalloc >= width + 2 * (cfg.n_fft // 2)
        assert plan.lalloc >= (plan.n_frames - 1) * cfg.hop_length + n_fft_pad
        assert plan.grid * 64 >= batch * plan.n_frames > (plan.grid - 1) * 64
        assert (plan.copy_bytes, plan.resident) == (copy, resident)
        starts = 2 * (np.arange(batch)[:, None] * plan.lalloc
                      + np.arange(plan.n_frames)[None] * cfg.hop_length)
        assert (starts % plan.copy_bytes == 0).all()


def _twin_in_kernel_order(waves, cfg):
    """K5's twin with the kernel's order of the fp32 sums: chunk by chunk
    of 64 bins; in a chunk the depth in 64-deep steps of four k16 slices,
    each adding hi.hi, hi.lo and lo.hi in turn into one sum for re and one
    for im; then the chunk's power, split, added into the mel sums in k16
    slices of its bins, three passes each."""
    plan = launch_plan(cfg, *waves.shape)
    cr_hi, cr_lo, ci_hi, ci_lo, mel_hi, mel_lo = (
        c.float() for c in _split_constants(cfg, waves.device))
    frames = frame_signal(center_pad(waves, cfg), plan.n_frames, cfg.n_fft,
                          cfg.hop_length)
    dk, df = plan.n_fft_pad - cfg.n_fft, plan.n_freq_pad - cfg.n_freq
    f_hi, f_lo = (F.pad(t.float(), (0, dk)) for t in _bf16x3_split(frames))
    cr_hi, cr_lo, ci_hi, ci_lo = (F.pad(c, (0, df, 0, dk))
                                  for c in (cr_hi, cr_lo, ci_hi, ci_lo))
    mel_hi, mel_lo = (F.pad(m, (0, 0, 0, df)) for m in (mel_hi, mel_lo))
    mel = torch.zeros((*frames.shape[:2], 128))
    for f0 in range(0, plan.n_freq_pad, 64):
        bins = slice(f0, f0 + 64)
        re = torch.zeros((*frames.shape[:2], 64))
        im = torch.zeros_like(re)
        for k0 in range(0, plan.n_fft_pad, 64):
            for k in range(k0, k0 + 64, 16):
                ks = slice(k, k + 16)
                for a, br, bi in ((f_hi, cr_hi, ci_hi), (f_hi, cr_lo, ci_lo),
                                  (f_lo, cr_hi, ci_hi)):
                    re = re + a[..., ks] @ br[ks, bins]
                    im = im + a[..., ks] @ bi[ks, bins]
        p_hi, p_lo = (t.float() for t in _bf16x3_split(re * re + im * im))
        for t in range(0, 64, 16):
            ps, ms = slice(t, t + 16), slice(f0 + t, f0 + t + 16)
            for a, m in ((p_hi, mel_hi), (p_hi, mel_lo), (p_lo, mel_hi)):
                mel = mel + a[..., ps] @ m[ms]
    return mel


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


    @pytest.mark.parametrize("preset", PRESETS)
    def test_twin_in_kernel_order_within_the_card_bar(self, preset):
        """The twin summed in the kernel's order (chunk by chunk, 64-deep
        steps of k16 slices, the power split per chunk) stays inside the bar
        chip_smoke.py holds the kernel to against the twin,
        K45_BARS["K5"]["twin"], on the inputs of the card's check (row
        amplitudes 1 .. 2^-2, a silent row, a zero tail). The two orders
        do differ, so the check is not vacuous."""
        cfg, _ = _configs(preset)
        w = torch.from_numpy(spread_waves(3, seed=3))
        twin = mel_power_bf16x3_plain(w, cfg)
        got = _twin_in_kernel_order(w, cfg)
        ok, rel, _ = within(got, twin, *K45_BARS["K5"]["twin"])
        assert ok, rel
        assert rel > 0
        assert not got[1].any()  # the silent row


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
