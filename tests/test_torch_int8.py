"""The port's int8 digit-decomposition frontend (ops/mfcc_int8.py) and K4's
plain twin (ops/cuda_mfcc_int8.py) against the JAX package: the constant
digits, the wave digits, the grouped integer products, the mel power against
the Pallas kernel in interpret mode, and the full MFCC against the JAX int8
path, the Pallas int8 path and the f64 oracle. Inputs are made with numpy
from a seed and handed to both packages; everything runs on the CPU, where
K4's wrapper is its twin.
"""

import dataclasses

import numpy as np
import pytest
import torch

from asr_using_robust_nn_tpu.ops import mfcc_int8 as jint8
from asr_using_robust_nn_tpu.ops.mfcc_xla import FrontendConfig as JConfig
from asr_using_robust_nn_tpu.ops.mfcc_xla import frame_signal as jframe_signal
from asr_using_robust_nn_tpu.ops.pallas_mfcc import (
    mel_power_int8_pallas,
    mfcc_pallas_int8_batch,
)
from asr_using_robust_nn_tpu_torch.frontend.mfcc import Frontend
from asr_using_robust_nn_tpu_torch.ops import frontend_ref, mfcc_int8
from asr_using_robust_nn_tpu_torch.ops.cuda_mfcc import mel_bands
from asr_using_robust_nn_tpu_torch.ops.cuda_mfcc_int8 import (
    _band_tables,
    _digit_constants,
    chunk_bands,
    launch_plan,
    mel_power_int8_cuda,
    mel_power_int8_plain,
    mfcc_cuda_int8_batch,
)
from asr_using_robust_nn_tpu_torch.ops.mfcc_torch import (
    FrontendConfig,
    frame_signal,
)

PRESETS = ["digit", "speaker"]


def _configs(preset):
    return getattr(FrontendConfig, preset)(), getattr(JConfig, preset)()


def _spread_batch():
    """Gaussian rows whose amplitudes spread over 50x, with PCM rows whose
    peaks are exactly 1.0, 0.5 and 2^-15, a silent row, and zero tails past
    per-row lengths."""
    rng = np.random.default_rng(0)
    amps = np.array([0.02, 0.2, 1.0, 0.5, 0.3, 0.3, 0.3, 0.0])[:, None]
    w = np.clip(rng.standard_normal((8, 22050)) * amps * 0.3, -1, 1)
    for i, top in ((4, 32767), (5, 16384), (6, 1)):
        w[i] = np.round(w[i] / np.abs(w[i]).max() * top) / 32768.0
    w[4, 7] = -1.0
    lens = np.array([22050, 9000, 22050, 15000, 22050, 22050, 700, 22050])
    for i, n in enumerate(lens):
        w[i, n:] = 0.0
    return w.astype(np.float32), lens


def _within_1e4_or_one_ulp(got, want):
    """|got - want| <= max(1e-4, one fp32 ulp of want): both sides are fp32
    and c0 of a quiet frame is ~ -1100, where one ulp is 1.2e-4."""
    bar = np.maximum(1e-4, np.spacing(np.abs(want).astype(np.float32)))
    diff = np.abs(got - want)
    assert (diff <= bar).all(), (diff.max(), diff[diff > bar][:5])


def _oracle(cfg, y):
    return frontend_ref.mfcc_fixed_length_ref(
        y, cfg.utterance_length, n_fft=cfg.n_fft, hop_length=cfg.hop_length,
        win_length=cfg.win_length)


class TestDigits:
    def test_tables_equal_jax(self):
        assert mfcc_int8.KEEP_PAIRS == jint8.KEEP_PAIRS
        assert mfcc_int8._X_SCALES == jint8._X_SCALES

    @pytest.mark.parametrize("preset", PRESETS)
    def test_const_digits_equal_jax_exactly(self, preset):
        cfg, jcfg = _configs(preset)
        cr, ci = cfg.constants(np.float64)[:2]
        c = np.concatenate([cr, ci], axis=1)
        got = mfcc_int8._const_digits(c)
        want = jint8._const_digits(
            np.concatenate(jcfg.constants(np.float64)[:2], axis=1))
        for (d, s), (jd, js) in zip(got, want):
            assert d.dtype == np.int8 and s == js
            np.testing.assert_array_equal(d, jd)
        rec = sum(d.astype(np.float64) * s for d, s in got)
        assert np.abs(rec - c).max() <= got[2][1] / 2  # half the last digit

    @pytest.mark.parametrize("preset", PRESETS)
    def test_kernel_constants_are_the_padded_transposed_digits(self, preset):
        """K4's operand: Cr and Ci digitized apart (equal scales) by the JAX
        package's own digitizer, zero padded to whole 128-deep steps (the
        JAX wrapper's n_fft padding) and 64-bin chunks, transposed, and laid
        out as [Cr_e | Ci_e] tiles of 32 bins each; the group weights are
        the products of the x and constant scales."""
        cfg, jcfg = _configs(preset)
        ct, weights = _digit_constants(cfg, torch.device("cpu"))
        n_fft_pad = -(-cfg.n_fft // 128) * 128
        n_freq_pad = -(-cfg.n_freq // 64) * 64
        assert ct.dtype == torch.int8
        assert ct.shape == (3, n_freq_pad // 32, 64, n_fft_pad)
        assert n_fft_pad == (2048 if preset == "digit" else 512)
        jcr, jci = jcfg.constants(np.float64)[:2]
        jdigs = (jint8._const_digits(jcr), jint8._const_digits(jci))
        for side, digs in enumerate(jdigs):
            got = ct[:, :, 32 * side: 32 * side + 32].reshape(
                3, n_freq_pad, n_fft_pad).numpy()
            for e, (d, _) in enumerate(digs):
                want = np.zeros((n_freq_pad, n_fft_pad), np.int8)
                want[:cfg.n_freq, :cfg.n_fft] = d.T
                np.testing.assert_array_equal(got[e], want)
        assert weights == tuple(2.0 ** -6 * jdigs[0][k][1] for k in range(3))

    @pytest.mark.parametrize("preset,hop,copy", [
        ("digit", 512, 16), ("speaker", 220, 4), ("speaker", 161, 1),
        ("digit", 200, 4), ("digit", 520, 4)])
    @pytest.mark.parametrize("batch,width", [(1, 22050), (3, 9000),
                                             (1024, 22050), (2, 300)])
    def test_launch_plan(self, preset, hop, copy, batch, width):
        """K4's padding, grid and copy width: whole 128-deep steps (the JAX
        wrapper's padding) and 64-bin chunks; a digit row long enough for
        every frame's n_fft_pad samples, a multiple of 16 that holds the
        padded signal; 16-byte copies only when every frame starts
        16-byte aligned, 4-byte copies when it starts 4-byte aligned."""
        cfg = dataclasses.replace(getattr(FrontendConfig, preset)(),
                                  hop_length=hop)
        plan = launch_plan(cfg, batch, width)
        assert plan.n_fft_pad % 128 == 0 and plan.n_fft_pad - cfg.n_fft < 128
        assert plan.n_freq_pad % 64 == 0 and plan.n_freq_pad - cfg.n_freq < 64
        assert plan.n_frames == cfg.num_frames(width)
        assert plan.lalloc % 16 == 0
        assert plan.lalloc >= width + 2 * (cfg.n_fft // 2)
        assert plan.lalloc >= (plan.n_frames - 1) * hop + plan.n_fft_pad
        assert plan.grid * 64 >= batch * plan.n_frames > (plan.grid - 1) * 64
        assert plan.steps == (plan.n_freq_pad // 64) * (plan.n_fft_pad // 128)
        assert plan.copy_bytes == copy
        if copy > 1:  # every frame of every row starts aligned
            starts = (np.arange(batch)[:, None] * plan.lalloc
                      + np.arange(plan.n_frames)[None] * hop)
            assert (starts % copy == 0).all()

    @pytest.mark.parametrize("preset", PRESETS)
    def test_chunk_bands_and_the_banded_fold(self, preset):
        """Each chunk's [lo, hi) holds every band with a bin in it and no
        band without one (empty bands excepted); the fold as the kernel
        runs it (per 64-bin chunk, per touched band, the partial sum of its
        bins there added to the band's running sum) gives the dense mel
        product of the twin's power to 1e-6 relative: only the order of
        non-negative fp32 terms changes."""
        cfg, _ = _configs(preset)
        start, off, w = mel_bands(cfg.sr, cfg.n_fft, cfg.n_mels)
        n_freq_pad = launch_plan(cfg, 1, 22050).n_freq_pad
        chunks = chunk_bands(start, off, n_freq_pad)
        assert chunks.shape == (n_freq_pad // 64, 2) and chunks.dtype == np.int32
        length = np.diff(off)
        for c, (lo, hi) in enumerate(chunks):
            touch = (length > 0) & (start < 64 * c + 64) & \
                (start + length > 64 * c)
            assert touch[lo:hi][length[lo:hi] > 0].all()
            assert not touch[:lo].any() and not touch[hi:].any()
        np.testing.assert_array_equal(
            _band_tables(cfg, torch.device("cpu"))[3].numpy(), chunks)

        w8, _ = _spread_batch()
        power, f = mfcc_int8.int8_power(torch.from_numpy(w8[:3]), cfg)
        p = power.reshape(-1, cfg.n_freq).numpy()
        mel = np.zeros((p.shape[0], cfg.n_mels), np.float32)
        for c, (lo, hi) in enumerate(chunks):
            for b in range(lo, hi):
                i0 = max(start[b], 64 * c)
                i1 = min(start[b] + length[b], 64 * c + 64)
                part = np.zeros(p.shape[0], np.float32)
                for i in range(i0, i1):
                    part = part + p[:, i] * w[off[b] + i - start[b]]
                if i1 > i0:
                    mel[:, b] += part
        want = (power @ torch.from_numpy(cfg.constants(np.float32)[2])
                ).reshape(-1, cfg.n_mels).numpy()
        np.testing.assert_allclose(mel, want, rtol=1e-6,
                                   atol=1e-30)

    def test_reconstruction_exact_for_int16_audio(self):
        """int16-origin audio is represented exactly by the three base-128
        digits after block scaling, |d0| <= 64."""
        rng = np.random.default_rng(0)
        k = rng.integers(-32768, 32768, (3, 1000)).astype(np.float32)
        y = k / 32768.0
        digits, f = mfcc_int8._wave_digits(torch.from_numpy(y))
        rec = sum(d.double().numpy() * s
                  for d, s in zip(digits, mfcc_int8._X_SCALES))
        np.testing.assert_array_equal(rec / f.numpy()[:, None],
                                      y.astype(np.float64))
        assert int(digits[0].abs().max()) <= 64

    @pytest.mark.parametrize("peak", [1.0, 0.5, 2.0 ** -15, 0.75, 3e-5, 1.5])
    def test_block_scale_exact_at_and_off_powers_of_two(self, peak):
        """f is the exact power of two that puts the peak in (0.5, 1]; a
        peak that is itself a power of two scales to exactly 1.0 (an fp32
        log2 one ulp off would give 0.5 or 2.0)."""
        y = torch.zeros((2, 64))
        y[0, 3], y[0, 9] = -peak, peak / 3
        digits, f = mfcc_int8._wave_digits(y)
        scaled = peak * float(f[0])
        assert 0.5 < scaled <= 1.0
        assert float(f[0]) == 2.0 ** round(np.log2(float(f[0])))
        if np.log2(peak) == round(np.log2(peak)):
            assert scaled == 1.0 and int(digits[0][0, 3]) == -64
        assert float(f[1]) == 1.0 and not digits[0][1].any()  # silent row

    @pytest.mark.parametrize("preset", PRESETS)
    def test_digit_sum_groups_equal_jax_exactly(self, preset):
        """The grouped integer products are exact in both packages: equal
        int32 partials and weights, smallest weight first."""
        cfg, jcfg = _configs(preset)
        rng = np.random.default_rng(4)
        y = (rng.standard_normal((2, 3000)) * 0.2).astype(np.float32)
        c = np.concatenate(cfg.constants(np.float64)[:2], axis=1)
        c_digits = mfcc_int8._const_digits(c)
        digits, _ = mfcc_int8._wave_digits(torch.from_numpy(y))
        jdigits, _ = jint8._wave_digits(y)
        for d, jd in zip(digits, jdigits):
            np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        n_frames = 4
        fr = [frame_signal(d, n_frames, cfg.n_fft, cfg.hop_length)
              for d in digits]
        jfr = [jframe_signal(d, n_frames, jcfg.n_fft, jcfg.hop_length)
               for d in jdigits]
        got = list(mfcc_int8.digit_sum_groups(fr, c_digits))
        want = list(jint8.digit_sum_groups(jfr, c_digits))
        assert [w for _, w in got] == [w for _, w in want]
        assert [w for _, w in got] == sorted(w for _, w in got)
        for (p, _), (jp, _) in zip(got, want):
            assert p.dtype == torch.int32
            np.testing.assert_array_equal(p.numpy(), np.asarray(jp))


class TestMelPowerTwin:
    @pytest.mark.parametrize("preset", PRESETS)
    def test_plain_matches_pallas_interpret(self, preset):
        """K4's twin against the Pallas int8 kernel in interpret mode. Both
        hold exact integer products; the Pallas kernel converts and adds
        its six products one by one, the twin three grouped sums, and the
        mel sums run in different orders: rtol 2e-5 plus 1e-9 of the
        batch's peak."""
        cfg, jcfg = _configs(preset)
        w, _ = _spread_batch()
        got = mel_power_int8_plain(torch.from_numpy(w), cfg).numpy()
        want = np.asarray(mel_power_int8_pallas(w, jcfg, interpret=True))
        assert got.shape == want.shape == (8, cfg.num_frames(22050), 128)
        np.testing.assert_allclose(got, want, rtol=2e-5,
                                   atol=1e-9 * want.max())
        assert not got[7].any()  # the silent row
        # on a CPU tensor the kernel wrapper is the twin, and launches nothing
        before = mel_power_int8_cuda.launches
        np.testing.assert_array_equal(
            mel_power_int8_cuda(torch.from_numpy(w), cfg).numpy(), got)
        assert mel_power_int8_cuda.launches == before == 0

    def test_twin_refuses_a_digit_overflow(self, monkeypatch):
        """|d0| <= 64 is what keeps the int32 sums exact: the twin checks."""
        whole = mfcc_int8._wave_digits

        def too_big(y):
            digits, f = whole(y)
            return [digits[0] + 50] + digits[1:], f

        monkeypatch.setattr(mfcc_int8, "_wave_digits", too_big)
        with pytest.raises(AssertionError, match="overflow"):
            mel_power_int8_plain(torch.full((1, 4000), 0.9),
                                 FrontendConfig.digit())


class TestMFCC:
    @pytest.mark.parametrize("preset", PRESETS)
    def test_matches_jax_int8_pallas_int8_and_oracle(self, preset):
        """The whole int8 MFCC with amplitude spread, power-of-two peaks,
        lengths and a silent row. Against the JAX int8 path and the Pallas
        int8 path (interpret): within 1e-4 or one fp32 ulp; MFCCs, not
        digits, are held, since the JAX block scale goes through an fp32
        log2. Against the f64 oracle: atol 1e-3, rtol 1e-4, the JAX suite's
        own bar for its int8 paths."""
        cfg, jcfg = _configs(preset)
        w, lens = _spread_batch()
        tw, tl = torch.from_numpy(w), torch.from_numpy(lens)
        got = mfcc_int8.mfcc_int8_batch(tw, cfg, tl).numpy()
        twin = mfcc_cuda_int8_batch(tw, cfg, tl).numpy()
        assert got.shape == (8, cfg.n_mfcc, cfg.utterance_length)
        assert np.isfinite(got).all() and np.isfinite(twin).all()
        _within_1e4_or_one_ulp(
            got, np.asarray(jint8.mfcc_int8_batch(w, jcfg, lengths=lens)))
        _within_1e4_or_one_ulp(
            twin, np.asarray(mfcc_pallas_int8_batch(w, jcfg, lengths=lens,
                                                    interpret=True)))
        _within_1e4_or_one_ulp(twin, got)
        for i, n in enumerate(lens):
            want = _oracle(cfg, w[i, :n])
            np.testing.assert_allclose(got[i], want, atol=1e-3, rtol=1e-4)
            np.testing.assert_allclose(twin[i], want, atol=1e-3, rtol=1e-4)

    def test_frontend_backends(self):
        """`int8` and `cuda_int8` are Frontend backends; on the CPU the
        second runs K4's twin. They agree with each other to one ulp and
        with the default backend to the int8 class (atol 2e-3, rtol 1e-4,
        the JAX suite's int8-vs-xla bar)."""
        cfg = FrontendConfig.digit()
        rng = np.random.default_rng(2)
        w = (rng.standard_normal((4, 22050)) * 0.3).astype(np.float32)
        lens = [22050, 22050, 15000, 8000]
        a = Frontend(cfg, backend="int8", device="cpu")(w, lengths=lens)
        b = Frontend(cfg, backend="cuda_int8", device="cpu")(w, lengths=lens)
        c = Frontend(cfg, backend="cuda", device="cpu")(w, lengths=lens)
        _within_1e4_or_one_ulp(a.numpy(), b.numpy())
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=2e-3, rtol=1e-4)
        flat = Frontend(cfg, backend="cuda_int8", device="cpu").flat(w)
        assert flat.shape == (4, cfg.feature_dim)

    def test_silent_input_matches_oracle(self):
        got = mfcc_cuda_int8_batch(torch.zeros((1, 22050)),
                                   FrontendConfig.digit()).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(
            got[0], _oracle(FrontendConfig.digit(), np.zeros(22050)),
            atol=2e-3)
