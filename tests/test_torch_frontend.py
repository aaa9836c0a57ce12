"""The port's MFCC frontend (asr_using_robust_nn_tpu_torch) against the JAX
package: numpy host modules, FrontendConfig, framing, the K1 plain twin
against the Pallas kernel in interpret mode, the full MFCC against the
Pallas path and the f64 oracle, int16 ingress, and the K1 launch counter.

Inputs are made with numpy from a seed (`chip_smoke.synth_waves`, the
stand-in utterances the card check also uses) and handed to both packages.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_using_robust_nn_tpu.ops import filters as jfilters
from asr_using_robust_nn_tpu.ops import frontend_ref as jref
from asr_using_robust_nn_tpu.ops.mfcc_xla import FrontendConfig as JConfig
from asr_using_robust_nn_tpu.ops.mfcc_xla import (
    finish_mfcc_from_mel as jfinish_mfcc_from_mel,
)
from asr_using_robust_nn_tpu.ops.mfcc_xla import frame_signal as jframe_signal
from asr_using_robust_nn_tpu.ops.mfcc_xla import mfcc_xla_batch
from asr_using_robust_nn_tpu.ops.pallas_mfcc import (
    mel_power_pallas,
    mfcc_pallas_batch,
)
from asr_using_robust_nn_tpu_torch.frontend.mfcc import Frontend
from asr_using_robust_nn_tpu_torch.ops import filters, frontend_ref
from asr_using_robust_nn_tpu_torch.ops.cuda_mfcc import (
    mel_power_cuda,
    mel_power_plain,
    mfcc_cuda_batch,
)
from asr_using_robust_nn_tpu_torch.ops.mfcc_torch import (
    FrontendConfig,
    device_constants,
    finish_mfcc_from_mel,
    frame_signal,
    mfcc_torch_batch,
)
from chip_smoke import synth_waves as _waves

GOLD = np.load(os.path.join(os.path.dirname(__file__), "golden_mfcc.npz"))
GOLD_NAMES = ["chirp", "tone_noise", "impulses"]
PRESETS = ["digit", "speaker"]


def _configs(preset):
    return getattr(FrontendConfig, preset)(), getattr(JConfig, preset)()


def _within_1e4_or_one_ulp(got, want):
    """|got - want| <= max(1e-4, one fp32 ulp of want). Both sides are
    fp32; above |x| = 1024 (c0 of a silent frame is -1131) one ulp is
    1.2e-4, so two fp32 results can be no closer than that."""
    bar = np.maximum(1e-4, np.spacing(np.abs(want).astype(np.float32)))
    diff = np.abs(got - want)
    assert (diff <= bar).all(), (diff.max(), diff[diff > bar][:5])


def _oracle(cfg, y):
    return frontend_ref.mfcc_fixed_length_ref(
        y, cfg.utterance_length, n_fft=cfg.n_fft, hop_length=cfg.hop_length,
        win_length=cfg.win_length)


class TestHostModules:
    """The numpy copies equal the JAX package's originals (rtol 1e-12:
    the same f64 arithmetic, so only last-bit noise is allowed)."""

    @pytest.mark.parametrize("n_fft,win", [(2048, 2048), (441, 441),
                                           (512, 400)])
    def test_filters_equal_jax(self, n_fft, win):
        for a, b in zip(filters.rdft_matrices(n_fft, win),
                        jfilters.rdft_matrices(n_fft, win)):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
        np.testing.assert_allclose(filters.mel_filterbank(22050, n_fft),
                                   jfilters.mel_filterbank(22050, n_fft),
                                   rtol=1e-12, atol=0)
        np.testing.assert_allclose(filters.dct_matrix(20, 128),
                                   jfilters.dct_matrix(20, 128),
                                   rtol=1e-12, atol=0)
        np.testing.assert_allclose(filters.hann_window(win),
                                   jfilters.hann_window(win), rtol=1e-12)
        np.testing.assert_array_equal(
            filters.pad_center(filters.hann_window(win), n_fft),
            jfilters.pad_center(jfilters.hann_window(win), n_fft))
        assert filters.n_fft_bins(n_fft) == jfilters.n_fft_bins(n_fft)

    @pytest.mark.parametrize("preset", PRESETS)
    def test_frontend_ref_equal_jax(self, preset):
        cfg, _ = _configs(preset)
        y = _waves(1, width=15000, seed=3)[0]
        kw = dict(n_fft=cfg.n_fft, hop_length=cfg.hop_length,
                  win_length=cfg.win_length)
        np.testing.assert_allclose(frontend_ref.mfcc_ref(y, **kw),
                                   jref.mfcc_ref(y, **kw), rtol=1e-12)
        np.testing.assert_allclose(
            frontend_ref.mfcc_fixed_length_ref(y, cfg.utterance_length, **kw),
            jref.mfcc_fixed_length_ref(y, cfg.utterance_length, **kw),
            rtol=1e-12)
        n = np.array([0, 1, 219, 220, 440, 441, 22050])
        np.testing.assert_array_equal(
            frontend_ref.num_frames(n, cfg.hop_length, cfg.n_fft),
            jref.num_frames(n, cfg.hop_length, cfg.n_fft))

    def test_oracle_reproduces_golden(self):
        for name in GOLD_NAMES:
            for preset in PRESETS:
                cfg, _ = _configs(preset)
                np.testing.assert_allclose(_oracle(cfg, GOLD[f"in_{name}"]),
                                           GOLD[f"{preset}_{name}"],
                                           rtol=1e-12)


class TestConfigAndFraming:
    @pytest.mark.parametrize("preset", PRESETS)
    def test_config_equal_jax(self, preset):
        cfg, jcfg = _configs(preset)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        for n in (0, 1, 220, 440, 441, 9000, 22050, 22051):
            assert cfg.num_frames(n) == jcfg.num_frames(n)
        assert cfg.n_freq == jcfg.n_freq
        assert cfg.feature_dim == jcfg.feature_dim
        for a, b in zip(cfg.constants(), jcfg.constants()):
            np.testing.assert_array_equal(a, b)

    def test_bad_dft_algorithm_rejected(self):
        with pytest.raises(ValueError, match="dft_algorithm"):
            FrontendConfig(dft_algorithm="tf32")

    @pytest.mark.parametrize("preset", PRESETS)
    @pytest.mark.parametrize("width", [22050, 300])
    def test_frame_signal_exact(self, preset, width):
        """Pure data movement: bit-equal, including a signal too short for
        the requested frames (zero-extended tail)."""
        cfg, _ = _configs(preset)
        ypad = _waves(2, width=width, seed=5)
        n_frames = cfg.num_frames(width - 2 * (cfg.n_fft // 2)) \
            if width > cfg.n_fft else 3
        got = frame_signal(torch.from_numpy(ypad), n_frames, cfg.n_fft,
                           cfg.hop_length).numpy()
        want = np.asarray(jframe_signal(ypad, n_frames, cfg.n_fft,
                                        cfg.hop_length))
        np.testing.assert_array_equal(got, want)


class TestMelPowerTwin:
    @pytest.mark.parametrize("preset", PRESETS)
    @pytest.mark.parametrize("batch", [1, 3])
    def test_plain_matches_pallas_interpret(self, preset, batch):
        """rtol 1e-4, plus atol 1e-8 of the batch's peak: both are fp32
        GEMM chains in different summation orders, whose absolute error
        scales with the energy of the frame (sum of |terms|), not with the
        bin, so bins ~1e-6 of the peak may differ by more than 1e-4
        relative. No silent stretch here: frames that straddle one hold bins
        far below their neighbours, where a relative bound says nothing
        (the MFCC tests below cover them at an absolute bound after the
        dB)."""
        cfg, jcfg = _configs(preset)
        w = _waves(batch, seed=batch, gap=False)
        got = mel_power_plain(torch.from_numpy(w), cfg).numpy()
        want = np.asarray(mel_power_pallas(w, jcfg, interpret=True))
        assert got.shape == want.shape == (batch, cfg.num_frames(22050), 128)
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-8 * want.max())
        # on a CPU tensor the kernel wrapper IS the plain twin
        np.testing.assert_array_equal(
            mel_power_cuda(torch.from_numpy(w), cfg).numpy(), got)


class TestMFCC:
    @staticmethod
    def _masked_batch():
        """Full, short, very short and zero-length rows, zero past each
        length."""
        w = _waves(4, seed=11)
        lens = np.array([22050, 9000, 300, 0], np.int64)
        for i, n in enumerate(lens):
            w[i, n:] = 0.0
        return w, lens

    @pytest.mark.parametrize("preset", PRESETS)
    def test_finish_matches_jax_finish(self, preset):
        """The port's dB/DCT finish runs in float64 and rounds once; the
        JAX finish runs in fp32. On the same mel power (from the Pallas
        kernel in interpret mode), the port's result is the JAX finish run
        in float64, rounded to fp32: within one fp32 ulp, plus 1e-9 for
        the f64 cancellation noise of coefficients near zero. So the port
        departs from the reference's finish only by the reference's own
        fp32 rounding."""
        cfg, jcfg = _configs(preset)
        w, lens = self._masked_batch()
        n_frames = cfg.num_frames(w.shape[1])
        mel = np.array(mel_power_pallas(w, jcfg, interpret=True))
        got = finish_mfcc_from_mel(
            torch.from_numpy(mel), cfg, torch.from_numpy(lens), 4, n_frames,
            device_constants(cfg, torch.device("cpu"))[3]).numpy()
        with jax.enable_x64(True):
            want = np.asarray(jfinish_mfcc_from_mel(
                jnp.asarray(mel, jnp.float64), jcfg, jnp.asarray(lens), 4,
                n_frames, jnp.asarray(jcfg.constants(np.float64)[3]),
                jax.lax.Precision.HIGHEST))
        assert want.dtype == np.float64
        assert got.shape == want.shape == (4, cfg.n_mfcc,
                                           cfg.utterance_length)
        ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
        assert (np.abs(got - want) <= ulp + 1e-9).all()

    @pytest.mark.parametrize("preset", PRESETS)
    def test_matches_pallas_and_oracle_with_lengths(self, preset):
        """The whole plain MFCC. Against the f64 oracle: <= 5e-4 abs, the
        parity bar the JAX package meets (docs/PARITY.md). Against the
        Pallas path: digit within 1e-4 or one fp32 ulp; speaker 2e-4 abs.
        The speaker gap is the two fp32 rDFTs' summation orders on the
        noise floor, not the finish: the JAX finish itself, run on the
        port's mel, lands 1.97e-4 from the Pallas path, and the Pallas
        path is 2.9e-4 from the oracle on this input."""
        cfg, jcfg = _configs(preset)
        w, lens = self._masked_batch()
        got = mfcc_torch_batch(torch.from_numpy(w), cfg,
                               torch.from_numpy(lens)).numpy()
        want = np.asarray(mfcc_pallas_batch(w, jcfg, lengths=lens,
                                            interpret=True))
        assert got.shape == (4, cfg.n_mfcc, cfg.utterance_length)
        assert np.isfinite(got).all()
        if preset == "digit":
            _within_1e4_or_one_ulp(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
        for i, n in enumerate(lens[:3]):
            np.testing.assert_allclose(got[i], _oracle(cfg, w[i, :n]),
                                       atol=5e-4, rtol=0)
        if cfg.num_frames(0) == 0:  # odd n_fft: no valid frame at length 0
            assert not got[3].any()
        # the kernel path's wrapper on a CPU tensor gives the same bits
        np.testing.assert_array_equal(
            mfcc_cuda_batch(torch.from_numpy(w), cfg,
                            torch.from_numpy(lens)).numpy(), got)

    @pytest.mark.parametrize("preset", PRESETS)
    def test_golden(self, preset):
        """The frozen golden vectors, at the bar the JAX suite holds its own
        fp32 XLA path to on them (tests/test_golden.py: 2e-3 abs, 1e-4
        rel). The chirp's near-null bins inside the 80 dB window put an
        fp32-accumulated rDFT at ~6e-4 from the oracle on the CPU; the K1
        kernel accumulates in f64 and is held to 5e-4 on the card
        (chip_smoke.py)."""
        cfg, _ = _configs(preset)
        waves = np.stack([GOLD[f"in_{n}"] for n in GOLD_NAMES])
        got = Frontend(cfg, device="cpu")(waves).numpy()
        want = np.stack([GOLD[f"{preset}_{n}"] for n in GOLD_NAMES])
        np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-4)

    def test_reflect_pad_matches_xla(self):
        """pad_mode='reflect' (thesis-era librosa) goes through the same
        center pad as JAX: 1e-4 abs between two fp32 pipelines."""
        cfg = dataclasses.replace(FrontendConfig.digit(), pad_mode="reflect")
        jcfg = dataclasses.replace(JConfig.digit(), pad_mode="reflect")
        w = _waves(2, seed=4)
        np.testing.assert_allclose(
            mfcc_torch_batch(torch.from_numpy(w), cfg).numpy(),
            np.asarray(mfcc_xla_batch(w, jcfg)), atol=1e-4, rtol=0)


class TestFrontend:
    @pytest.mark.parametrize("preset", PRESETS)
    def test_int16_ingress_bit_equal(self, preset):
        """int16 PCM dequantized on the device by the power-of-two 1/32768
        is exact, so features are bit-equal to f32 ingress of w/32768."""
        cfg, _ = _configs(preset)
        pcm = np.random.default_rng(7).integers(
            -32768, 32768, (3, 22050)).astype(np.int16)
        fe = Frontend(cfg, device="cpu")
        f16 = fe(pcm)
        f32 = fe(pcm.astype(np.float32) / 32768.0)
        assert torch.equal(f16, f32)
        assert fe.flat(pcm).shape == (3, cfg.feature_dim)

    def test_backends_agree_and_unknown_rejected(self):
        cfg = FrontendConfig.digit()
        w = _waves(2, seed=8)
        lens = [22050, 5000]
        a = Frontend(cfg, backend="cuda", device="cpu")(w, lengths=lens)
        b = Frontend(cfg, backend="plain", device="cpu")(w, lengths=lens)
        assert torch.equal(a, b)
        with pytest.raises(ValueError, match="backend"):
            Frontend(cfg, backend="xla", device="cpu")

    def test_launch_counter_stays_zero_on_cpu(self):
        """On a CPU tensor the wrapper runs the plain twin and launches
        nothing."""
        before = mel_power_cuda.launches
        cfg = FrontendConfig.speaker()
        w = _waves(2, seed=9)
        mel_power_cuda(torch.from_numpy(w), cfg)
        mfcc_cuda_batch(torch.from_numpy(w), cfg)
        Frontend(cfg, device="cpu")(w)
        assert mel_power_cuda.launches == before == 0


# -- K1's FFT body: its host-side tables and its float64 decomposition twin --

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from asr_using_robust_nn_tpu_torch.ops import cuda_mfcc  # noqa: E402
from asr_using_robust_nn_tpu_torch.ops.cuda_mfcc import (  # noqa: E402
    fft_spectrum_plain,
    fft_tables,
    frames_per_block,
    kernel_body,
    mel_bands,
    mel_power_fft_plain,
    mel_power_mixed_plain,
    mixed_plan,
    mixed_spectrum_plain,
    mixed_tables,
    pairs_per_block,
    stage_permutation,
    stage_plan,
)

FFT_SIZES = [32, 64, 128, 256, 512, 1024, 2048, 4096]
# a window shorter than n_fft (zero padded to the centre) and an odd hop
SHORT_WINDOW = dataclasses.replace(FrontendConfig.digit(), n_fft=512,
                                   win_length=400, hop_length=161)
FFT_CONFIGS = {"digit": FrontendConfig.digit(), "win400_hop161": SHORT_WINDOW}


def _dense_spectrum(frames, cfg):
    """The windowed rDFT as the float64 dense product (re, im)."""
    cr, ci = filters.rdft_matrices(cfg.n_fft, cfg.win_length)
    return frames @ cr, frames @ ci


class TestFftBody:
    def test_body_is_a_function_of_the_config(self):
        """A power of two in [32, 4096] takes the FFT body; any other n_fft
        there whose prime factors are 2, 3, 5 and 7 the mixed body (the
        speaker preset's 441 = 3^2 7^2); a prime n_fft, or one outside
        the range, the dense body."""
        assert kernel_body(FrontendConfig.digit()) == "fft"
        assert kernel_body(FrontendConfig.speaker()) == "mixed"
        assert kernel_body(FrontendConfig.speaker_fast()) == "mixed"
        assert kernel_body(SHORT_WINDOW) == "fft"
        for n_fft, want in ((16, "dense"), (32, "fft"), (4096, "fft"),
                            (8192, "dense"), (1000, "mixed"), (400, "mixed"),
                            (441, "mixed"), (2187, "mixed"), (401, "dense"),
                            (443, "dense"), (22 * 19, "dense"),
                            (4410, "dense")):
            cfg = dataclasses.replace(FrontendConfig.digit(), n_fft=n_fft,
                                      win_length=n_fft)
            assert kernel_body(cfg) == want
        with pytest.raises(ValueError, match="power of two"):
            fft_tables(FrontendConfig.speaker())
        with pytest.raises(ValueError, match="power of two"):
            mel_power_fft_plain(torch.zeros(1, 22050),
                                FrontendConfig.speaker())
        for n_fft in (2048, 401):
            cfg = dataclasses.replace(FrontendConfig.speaker(), n_fft=n_fft,
                                      win_length=n_fft)
            with pytest.raises(ValueError, match="product of 2, 3, 5 and 7"):
                mixed_tables(cfg)

    @pytest.mark.parametrize("n_fft", FFT_SIZES)
    def test_tables(self, n_fft):
        """Lengths, float64, unit-modulus twiddles, a window that is the
        centre-padded Hann, bands that rebuild the fp32 filterbank."""
        win = n_fft if n_fft != 512 else 400
        cfg = dataclasses.replace(FrontendConfig.digit(), n_fft=n_fft,
                                  win_length=win)
        tab = fft_tables(cfg)
        m = n_fft // 2
        assert tab.m == m and int(np.prod(tab.radices)) == m
        assert set(tab.radices) <= {2, 4} and tab.radices.count(2) <= 1
        assert tab.window.shape == (n_fft,) and tab.window.dtype == np.float64
        np.testing.assert_array_equal(
            tab.window, filters.pad_center(filters.hann_window(win), n_fft))
        for t, n in ((tab.twiddle, m), (tab.split, m + 1)):
            assert t.shape == (n, 2) and t.dtype == np.float64
            np.testing.assert_allclose(np.hypot(t[:, 0], t[:, 1]), 1.0,
                                       rtol=0, atol=1e-15)
        k = np.arange(m + 1)
        np.testing.assert_allclose(
            tab.split[:, 0] + 1j * tab.split[:, 1],
            np.exp(-2j * np.pi * k / n_fft), rtol=0, atol=1e-15)
        assert tab.pos.shape == (m,) and tab.pos.dtype == np.int32
        assert tab.band_start.shape == (cfg.n_mels,)
        assert tab.band_off.shape == (cfg.n_mels + 1,)
        assert tab.band_w.dtype == np.float32
        assert tab.band_w.shape == (tab.band_off[-1],)
        mel = np.zeros((cfg.n_mels, cfg.n_freq), np.float32)
        for b in range(cfg.n_mels):
            n = tab.band_off[b + 1] - tab.band_off[b]
            mel[b, tab.band_start[b]: tab.band_start[b] + n] = \
                tab.band_w[tab.band_off[b]: tab.band_off[b + 1]]
        np.testing.assert_array_equal(mel.T, cfg.constants(np.float32)[2])

    @settings(max_examples=40, deadline=None)
    @given(n_fft=st.sampled_from(FFT_SIZES), data=st.data())
    def test_stage_permutation_is_a_bijection(self, n_fft, data):
        """For every n_fft the FFT body admits, and for its stages in any
        order, the stages' output permutation hits every index once; at
        the body's own plan the stages leave output k at pos[k]."""
        m = n_fft // 2
        plan = stage_plan(m)
        radices = tuple(data.draw(st.permutations(plan)))
        pos = stage_permutation(m, radices)
        assert sorted(pos.tolist()) == list(range(m))
        tab = cuda_mfcc._fft_tables(n_fft, n_fft, 22050, 128)._replace(
            radices=radices, pos=pos)
        rng = np.random.default_rng(n_fft)
        z = rng.standard_normal(m) + 1j * rng.standard_normal(m)
        got = cuda_mfcc._butterflies(torch.from_numpy(z), tab).numpy()[pos]
        want = np.fft.fft(z)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())

    @pytest.mark.parametrize("name", FFT_CONFIGS)
    def test_spectrum_matches_dense_dft_f64(self, name):
        """Real and imaginary parts against the float64 dense product, 1e-10
        of the frame's largest bin: a twiddle, ordering or sign error (the
        power hides the imaginary part's sign) is of order one."""
        cfg = FFT_CONFIGS[name]
        frames = np.random.default_rng(5).standard_normal((7, cfg.n_fft))
        got = fft_spectrum_plain(torch.from_numpy(frames),
                                 fft_tables(cfg)).numpy()
        re, im = _dense_spectrum(frames, cfg)
        assert got.shape == re.shape == (7, cfg.n_freq)
        scale = np.abs(re + 1j * im).max(axis=1, keepdims=True)
        assert (np.abs(got.real - re) <= 1e-10 * scale).all()
        assert (np.abs(got.imag - im) <= 1e-10 * scale).all()
        assert np.abs(got.imag[:, 1:-1]).min() > 0  # the sign is tested

    @pytest.mark.parametrize("batch", [1, 3])
    def test_matches_pallas_interpret_and_plain(self, batch):
        """The digit preset (the one the FFT body takes) at the bar the
        plain twin is held to against the Pallas kernel: rtol 1e-4 plus
        1e-8 of the batch's peak (two fp32 GEMM chains on the other side)."""
        cfg, jcfg = _configs("digit")
        w = _waves(batch, seed=batch, gap=False)
        got = mel_power_fft_plain(torch.from_numpy(w), cfg).numpy()
        assert got.dtype == np.float32
        want = np.asarray(mel_power_pallas(w, jcfg, interpret=True))
        assert got.shape == want.shape == (batch, cfg.num_frames(22050), 128)
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-8 * want.max())
        plain = mel_power_plain(torch.from_numpy(w), cfg).numpy()
        np.testing.assert_allclose(got, plain, rtol=1e-4,
                                   atol=1e-8 * plain.max())

    @pytest.mark.parametrize("name", FFT_CONFIGS)
    def test_mel_matches_f64_chain(self, name):
        """Against the float64 dense chain with float64 constants: 1e-6
        relative (the power's one rounding to fp32), rows with a silent
        stretch and a short row included."""
        cfg = FFT_CONFIGS[name]
        w = _waves(3, seed=2)
        w[2, 9000:] = 0.0
        got = mel_power_fft_plain(torch.from_numpy(w), cfg).numpy()
        n_frames = cfg.num_frames(22050)
        frames = frame_signal(
            torch.from_numpy(np.pad(w.astype(np.float64),
                                    ((0, 0), (cfg.n_fft // 2,) * 2))),
            n_frames, cfg.n_fft, cfg.hop_length).numpy()
        re, im = _dense_spectrum(frames, cfg)
        want = (re * re + im * im) @ cfg.constants(np.float32)[2].astype(
            np.float64)
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-12 * want.max())

    @pytest.mark.parametrize("name", FFT_CONFIGS)
    def test_mfcc_matches_oracle_with_lengths(self, name):
        """The FFT body's MFCC (its twin + the shared finish) within 5e-4
        abs of the f64 oracle, rows of every length."""
        cfg = FFT_CONFIGS[name]
        w, lens = TestMFCC._masked_batch()
        mel = mel_power_fft_plain(torch.from_numpy(w), cfg)
        got = finish_mfcc_from_mel(
            mel, cfg, torch.from_numpy(lens), 4, cfg.num_frames(22050),
            device_constants(cfg, torch.device("cpu"))[3]).numpy()
        for i, n in enumerate(lens[:3]):
            np.testing.assert_allclose(got[i], _oracle(cfg, w[i, :n]),
                                       atol=5e-4, rtol=0)

    def test_mfcc_matches_golden(self):
        """The frozen golden vectors at 5e-4 abs: the bar the fp32 paths
        miss on the chirp and the float64 transform meets."""
        cfg = FrontendConfig.digit()
        waves = np.stack([GOLD[f"in_{n}"] for n in GOLD_NAMES])
        mel = mel_power_fft_plain(torch.from_numpy(waves), cfg)
        got = finish_mfcc_from_mel(
            mel, cfg, None, 3, cfg.num_frames(waves.shape[1]),
            device_constants(cfg, torch.device("cpu"))[3]).numpy()
        want = np.stack([GOLD[f"digit_{n}"] for n in GOLD_NAMES])
        np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)

    @pytest.mark.parametrize("rows,want", [(44, 1), (704, 2), (2816, 4),
                                           (45056, 4)])
    def test_frames_per_block(self, rows, want):
        """On 132 SMs at the digit preset: a lone utterance one frame a
        block, a 16-row bucket two, 64 rows and up four; two blocks of the
        chosen size fit one SM's shared memory."""
        f = frames_per_block(rows, 1024, 132)
        assert f == want
        assert 2 * f * ((1024 + 128) * 16 + 1028 * 4) <= 232448
        assert frames_per_block(10 ** 6, 2048, 132) == 2  # n_fft 4096


# -- K1's mixed body: two frames a complex transform, mixed-radix stages ----

# the speaker preset, a shorter window with an odd hop, and two even n_fft
# (the even ones spread the kernel's shared-memory index)
MIXED_CONFIGS = {
    "speaker": FrontendConfig.speaker(),
    "win400_hop161": dataclasses.replace(FrontendConfig.speaker(),
                                         win_length=400, hop_length=161),
    "n400": dataclasses.replace(FrontendConfig.speaker(), n_fft=400,
                                win_length=400, hop_length=160),
    "n1000_win800": dataclasses.replace(FrontendConfig.speaker(), n_fft=1000,
                                        win_length=800, hop_length=250),
}
MIXED_SIZES = [48, 400, 441, 1000, 2187, 3072]


class TestMixedBody:
    @pytest.mark.parametrize("n_fft", MIXED_SIZES)
    def test_tables(self, n_fft):
        """The radices multiply to n_fft and are 7, 5, 4, 3 or 2, largest
        first; the permutation is a bijection; the twiddles are exp(-2 pi i
        k / n) to 1e-15 and exact at the quarter turns; the window is the
        centre-padded Hann; the bands rebuild the fp32 filterbank."""
        win = n_fft if n_fft != 1000 else 800
        cfg = dataclasses.replace(FrontendConfig.speaker(), n_fft=n_fft,
                                  win_length=win)
        tab = mixed_tables(cfg)
        assert tab.n == n_fft and int(np.prod(tab.radices)) == n_fft
        assert set(tab.radices) <= {2, 3, 4, 5, 7}
        assert tab.radices.count(2) <= 1
        assert list(tab.radices) == sorted(tab.radices, reverse=True)
        assert tab.radices == mixed_plan(n_fft)
        assert sorted(tab.pos.tolist()) == list(range(n_fft))
        assert tab.pos.dtype == np.int32
        assert tab.window.dtype == np.float64
        np.testing.assert_array_equal(
            tab.window, filters.pad_center(filters.hann_window(win), n_fft))
        k = np.arange(n_fft)
        assert tab.twiddle.shape == (n_fft, 2)
        assert tab.twiddle.dtype == np.float64
        np.testing.assert_allclose(
            tab.twiddle[:, 0] + 1j * tab.twiddle[:, 1],
            np.exp(-2j * np.pi * k / n_fft), rtol=0, atol=1e-15)
        quarter = (4 * k) % n_fft == 0
        exact = np.array([[1, 0], [0, -1], [-1, 0], [0, 1]], np.float64)
        np.testing.assert_array_equal(tab.twiddle[quarter],
                                      exact[(4 * k[quarter]) // n_fft])
        start, off, w = mel_bands(cfg.sr, n_fft, cfg.n_mels)
        for a, b in ((tab.band_start, start), (tab.band_off, off),
                     (tab.band_w, w)):
            np.testing.assert_array_equal(a, b)
        mel = np.zeros((cfg.n_mels, cfg.n_freq), np.float32)
        for b in range(cfg.n_mels):
            mel[b, start[b]: start[b] + off[b + 1] - off[b]] = \
                w[off[b]: off[b + 1]]
        np.testing.assert_array_equal(mel.T, cfg.constants(np.float32)[2])

    @settings(max_examples=30, deadline=None)
    @given(n_fft=st.sampled_from(MIXED_SIZES), data=st.data())
    def test_stages_in_any_order_are_an_fft(self, n_fft, data):
        """For every radix order, the stages (the kernel's dense r-point
        DFTs with the table's coefficients) leave the DFT of z at pos[k]."""
        radices = tuple(data.draw(st.permutations(mixed_plan(n_fft))))
        tab = cuda_mfcc._mixed_tables(n_fft, n_fft, 22050, 128)._replace(
            radices=radices, pos=stage_permutation(n_fft, radices))
        rng = np.random.default_rng(n_fft)
        z = rng.standard_normal(n_fft) + 1j * rng.standard_normal(n_fft)
        got = cuda_mfcc._butterflies(torch.from_numpy(z), tab).numpy()
        want = np.fft.fft(z)
        np.testing.assert_allclose(got[tab.pos], want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())

    @pytest.mark.parametrize("name", MIXED_CONFIGS)
    def test_spectrum_matches_dense_dft_f64(self, name):
        """Real and imaginary parts of every row, 7 rows (so the last pair
        is half empty), against the float64 dense product: 1e-10 of the
        row's largest bin."""
        cfg = MIXED_CONFIGS[name]
        frames = np.random.default_rng(5).standard_normal((7, cfg.n_fft))
        got = mixed_spectrum_plain(torch.from_numpy(frames),
                                   mixed_tables(cfg)).numpy()
        re, im = _dense_spectrum(frames, cfg)
        assert got.shape == re.shape == (7, cfg.n_freq)
        scale = np.abs(re + 1j * im).max(axis=1, keepdims=True)
        assert (np.abs(got.real - re) <= 1e-10 * scale).all()
        assert (np.abs(got.imag - im) <= 1e-10 * scale).all()
        assert np.abs(got.imag[:, 1:cfg.n_freq - 1]).min() > 0

    def test_pair_separation_with_an_odd_frame_count(self):
        """A row's spectrum does not depend on the row it is packed with:
        each of 5 rows (a quiet one beside a loud one, and a last row packed
        with zeros) equals its spectrum computed alone, to 1e-12 of its own
        largest bin."""
        cfg = FrontendConfig.speaker()
        tab = mixed_tables(cfg)
        frames = np.random.default_rng(3).standard_normal((5, cfg.n_fft))
        frames[1] *= 1e-3
        got = mixed_spectrum_plain(torch.from_numpy(frames), tab).numpy()
        for i in range(5):
            alone = mixed_spectrum_plain(torch.from_numpy(frames[i:i + 1]),
                                         tab).numpy()[0]
            assert np.abs(got[i] - alone).max() <= \
                1e-12 * np.abs(alone).max()

    @pytest.mark.parametrize("batch", [1, 3])
    def test_matches_pallas_interpret_and_plain(self, batch):
        """The speaker preset against the JAX package's Pallas kernel in
        interpret mode and the fp32 twin, at the bar the plain twin is held
        to against that kernel: rtol 1e-4 plus 1e-8 of the batch's peak.
        B = 3 is 303 rows: the last pair holds one row."""
        cfg, jcfg = _configs("speaker")
        w = _waves(batch, seed=batch, gap=False)
        got = mel_power_mixed_plain(torch.from_numpy(w), cfg).numpy()
        assert got.dtype == np.float32
        want = np.asarray(mel_power_pallas(w, jcfg, interpret=True))
        assert got.shape == want.shape == (batch, cfg.num_frames(22050), 128)
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-8 * want.max())
        plain = mel_power_plain(torch.from_numpy(w), cfg).numpy()
        np.testing.assert_allclose(got, plain, rtol=1e-4,
                                   atol=1e-8 * plain.max())

    @pytest.mark.parametrize("name", ["speaker", "win400_hop161"])
    def test_mel_matches_f64_chain(self, name):
        """Against the float64 dense chain with float64 constants: 1e-6
        relative (the power's one rounding to fp32), rows with a silent
        stretch and a short row included."""
        cfg = MIXED_CONFIGS[name]
        w = _waves(3, seed=2)
        w[2, 9000:] = 0.0
        got = mel_power_mixed_plain(torch.from_numpy(w), cfg).numpy()
        frames = frame_signal(
            torch.from_numpy(np.pad(w.astype(np.float64),
                                    ((0, 0), (cfg.n_fft // 2,) * 2))),
            cfg.num_frames(22050), cfg.n_fft, cfg.hop_length).numpy()
        re, im = _dense_spectrum(frames, cfg)
        want = (re * re + im * im) @ cfg.constants(np.float32)[2].astype(
            np.float64)
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-12 * want.max())

    def test_mfcc_matches_jax_oracle_with_lengths(self):
        """The mixed body's MFCC (its twin + the shared finish) within 5e-4
        abs of the JAX package's f64 oracle, rows of every length."""
        cfg, jcfg = _configs("speaker")
        w, lens = TestMFCC._masked_batch()
        mel = mel_power_mixed_plain(torch.from_numpy(w), cfg)
        got = finish_mfcc_from_mel(
            mel, cfg, torch.from_numpy(lens), 4, cfg.num_frames(22050),
            device_constants(cfg, torch.device("cpu"))[3]).numpy()
        for i, n in enumerate(lens[:3]):
            want = jref.mfcc_fixed_length_ref(
                w[i, :n], jcfg.utterance_length, n_fft=jcfg.n_fft,
                hop_length=jcfg.hop_length, win_length=jcfg.win_length)
            np.testing.assert_allclose(got[i], want, atol=5e-4, rtol=0)
        assert not got[3].any()  # no frame at length 0 (odd n_fft)

    def test_mfcc_matches_golden(self):
        """The speaker goldens at 5e-4 abs, the bar the fp32 paths miss on
        the chirp."""
        cfg = FrontendConfig.speaker()
        waves = np.stack([GOLD[f"in_{n}"] for n in GOLD_NAMES])
        mel = mel_power_mixed_plain(torch.from_numpy(waves), cfg)
        got = finish_mfcc_from_mel(
            mel, cfg, None, 3, cfg.num_frames(waves.shape[1]),
            device_constants(cfg, torch.device("cpu"))[3]).numpy()
        want = np.stack([GOLD[f"speaker_{n}"] for n in GOLD_NAMES])
        np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)

    @pytest.mark.parametrize("rows,want", [(101, 1), (1616, 2), (6464, 8),
                                           (103424, 8)])
    def test_pairs_per_block(self, rows, want):
        """On 132 SMs at the speaker preset: a lone utterance one pair a
        block, a 16-row bucket two, 64 rows and up eight; two blocks of the
        chosen size fit one SM's shared memory."""
        p = pairs_per_block(rows, 441, 132)
        assert p == want
        assert 2 * p * (441 * 16 + 2 * 224 * 4) <= 232448
        # an even n spreads its points: 66 KB a pair at 3072, so one
        assert pairs_per_block(10 ** 6, 3072, 132) == 1
        assert pairs_per_block(10 ** 6, 1000, 132) == 4
