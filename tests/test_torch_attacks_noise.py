"""The port's black-box noise families (asr_using_robust_nn_tpu_torch/
attacks/blackbox.py) against the JAX package's: each family as a pure
function fed the unit draws that the JAX function makes from its own key and
splits (bar 1e-6), the draws' statistics from a torch.Generator, the
audio attack's branch rule and padded tails, and the audio features of the
same noisy waves through both packages' frontends.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_using_robust_nn_tpu.attacks import blackbox as jbb
from asr_using_robust_nn_tpu.ops.mfcc_xla import FrontendConfig as JConfig
from asr_using_robust_nn_tpu_torch.attacks import blackbox as bb
from asr_using_robust_nn_tpu_torch.data.pipeline import slice_seconds
from asr_using_robust_nn_tpu_torch.frontend.mfcc import Frontend
from asr_using_robust_nn_tpu_torch.ops.mfcc_torch import FrontendConfig

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several test workers share a few cores; one torch thread each keeps
    this file near its solo time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen(seed):
    return torch.Generator(device=CPU).manual_seed(seed)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _waves(rng, b=3, n=4000, scale=0.1):
    return (rng.standard_normal((b, n)) * scale).astype(np.float32)


def _normal(key, shape):
    return np.asarray(jax.random.normal(key, shape, jnp.float32))


def _mixture_draws(key, shape):
    """mixtgauss's draws: split(key) -> (q from k1, z from k2)."""
    k1, k2 = jax.random.split(key)
    return _normal(k1, shape), _normal(k2, shape)


def _per_row(key, b, draw):
    """The per-row draws of a vmapped family: split(key, B), one key a
    row."""
    rows = [draw(k) for k in jax.random.split(key, b)]
    return tuple(np.stack(d) for d in zip(*rows))


class TestInjectedDraws:
    """Bar 1e-6 (absolute, on values of magnitude <= ~1) between the port's
    pure families and the JAX functions on the same unit draws."""

    def test_white(self, rng):
        x = _waves(rng)
        key = jax.random.PRNGKey(1)
        want = np.asarray(jbb.add_white_noise(jnp.asarray(x), 0.05, key))
        got = bb.white_noise(_t(x), 0.05, _t(_normal(key, x.shape)))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
        want = np.asarray(jbb.add_white_noise_on_dataset(x, 0.05, key))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)

    @pytest.mark.parametrize("p", [0.01, 0.5])
    def test_mixture(self, rng, p):
        x = _waves(rng)
        key = jax.random.PRNGKey(2)
        q, z = _mixture_draws(key, x.shape)
        want = np.asarray(jbb.mixtgauss(x.shape, p, 0.2, 2.0, key))
        got = bb.mixture_noise(p, 0.2, 2.0, _t(q), _t(z))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
        want = np.asarray(jbb.add_noise_mixture_on_dataset(x, p, 0.2, key))
        got = _t(x) + bb.mixture_noise(p, 0.2, 2.0, _t(q), _t(z))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)

    def test_snr_with_and_without_length(self, rng):
        x = _waves(rng, b=1, n=5000)[0]
        key = jax.random.PRNGKey(3)
        z = _t(_normal(key, x.shape))
        for length in (None, 3000):
            xin = x.copy()
            if length is not None:
                xin[length:] = 0.0
            want = np.asarray(jbb.add_white_noise_with_snr(
                jnp.asarray(xin), 10.0, key, length))
            got = bb.snr_noise(_t(xin), 10.0, z, None if length is None
                               else torch.tensor(length))
            np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)

    def test_snr_on_dataset(self, rng):
        x = _waves(rng, b=4)
        lens = np.array([4000, 2500, 1, 0], np.int64)
        for i, n in enumerate(lens):
            x[i, n:] = 0.0
        key = jax.random.PRNGKey(4)
        (z,) = _per_row(key, 4, lambda k: (_normal(k, (4000,)),))
        for lengths in (None, lens):
            want = np.asarray(jbb.add_snr_noise_on_dataset(
                x, 20.0, key, lengths=lengths))
            got = bb.snr_noise(_t(x), 20.0, _t(z), None if lengths is None
                               else torch.from_numpy(lengths))
            np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)

    @pytest.mark.parametrize("kw", [dict(sigma=0.03),
                                    dict(p=0.01, alpha=0.02),
                                    dict(snr_db=15.0), dict(alpha=0.05)])
    def test_noisy_waves(self, rng, kw):
        """Every branch of the audio attack's noise stage with lengths: the
        JAX function's draws (one normal of the batch for white noise, per
        row split -> split for the mixture, per row for SNR) injected."""
        x = _waves(rng, b=3)
        lens = np.array([4000, 2600, 1300], np.int64)
        for i, n in enumerate(lens):
            x[i, n:] = 0.0
        key = jax.random.PRNGKey(5)
        kind = bb.noise_kind(**kw)
        draws = {
            "white": lambda: (_normal(key, x.shape),),
            "mixture": lambda: _per_row(
                key, 3, lambda k: _mixture_draws(k, (4000,))),
            "snr": lambda: _per_row(key, 3,
                                    lambda k: (_normal(k, (4000,)),)),
            "clean": lambda: (),
        }[kind]()
        want = np.asarray(jbb.noisy_waves(x, key, lengths=lens, **kw))
        got = bb.apply_noise(kind, _t(x), tuple(_t(d) for d in draws),
                             lengths=torch.from_numpy(lens), **kw)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)

    def test_audio_noise_features_vs_jax_frontend(self, rng):
        """The port's audio_noise_features draws from its generator; the
        same noisy waves (the draws redone from the seed) through the JAX
        package's xla frontend agree within the cross-package MFCC bar of
        tests/test_torch_frontend.py: max(1e-4, one fp32 ulp)."""
        cfg, jcfg = FrontendConfig.digit(), JConfig.digit()
        x = _waves(rng, b=3, n=22050)
        lens = np.array([22050, 15000, 9000], np.int64)
        for i, n in enumerate(lens):
            x[i, n:] = 0.0
        got = bb.audio_noise_features(x, cfg, _gen(11), sigma=0.02,
                                      lengths=lens, device="cpu")
        z = torch.randn(x.shape, generator=_gen(11))
        noisy = bb.apply_noise("white", _t(x), (z,), sigma=0.02,
                               lengths=torch.from_numpy(lens)).numpy()
        want = jbb.audio_noise_features(noisy, jcfg, jax.random.PRNGKey(0),
                                        lengths=lens, backend="xla")
        assert got.shape == (3, 880) and got.dtype == np.float32
        bar = np.maximum(1e-4, np.spacing(np.abs(want).astype(np.float32)))
        assert np.all(np.abs(got - want) <= bar), np.abs(got - want).max()


class TestStatistics:
    def test_white_mean_std(self):
        n = bb.add_white_noise(torch.zeros(100_000), 0.5, _gen(0))
        assert abs(float(n.std()) - 0.5) < 0.01
        assert abs(float(n.mean())) < 0.01

    @pytest.mark.parametrize("p,tol", [(0.01, 1e-3), (0.5, 5e-3)])
    def test_mixture_impulse_fraction(self, p, tol):
        """With sigma0 = 0 the noise is nonzero exactly at the impulses,
        whose probability is P(|N(0,1)| < p) = erf(p / sqrt 2); tol is ~5
        standard errors of the fraction at 200 000 draws."""
        n = bb.mixtgauss((200_000,), p, 0.0, 1.0, _gen(1))
        frac = float((n != 0).double().mean())
        assert abs(frac - math.erf(p / math.sqrt(2))) < tol

    def test_snr_achieved(self):
        """The achieved SNR within 0.2 dB of the target, on a full row and
        on a row padded past its true length (power of the true samples)."""
        t = np.arange(22050) / 22050
        sig = np.sin(2 * np.pi * 440 * t).astype(np.float32)
        padded = np.concatenate([sig, np.zeros(5000, np.float32)])
        for snr in (20.0, 5.0):
            noisy = bb.add_white_noise_with_snr(_t(sig), snr, _gen(2))
            noise = noisy.numpy() - sig
            got = 10 * np.log10(np.mean(sig ** 2) / np.mean(noise ** 2))
            assert abs(got - snr) < 0.2
            noisy = bb.add_white_noise_with_snr(_t(padded), snr, _gen(3),
                                                length=22050).numpy()
            assert not noisy[22050:].any()  # the padded tail stays 0
            noise = noisy[:22050] - sig
            got = 10 * np.log10(np.mean(sig ** 2) / np.mean(noise ** 2))
            assert abs(got - snr) < 0.2

    @pytest.mark.parametrize("kw", [dict(sigma=0.05),
                                    dict(p=0.5, alpha=0.05),
                                    dict(snr_db=0.0)])
    def test_padded_tails_exactly_zero(self, rng, kw):
        x = _waves(rng, b=3)
        lens = np.array([4000, 1000, 0], np.int64)
        for i, n in enumerate(lens):
            x[i, n:] = 0.0
        out = bb.noisy_waves(x, _gen(4), lengths=lens, **kw).numpy()
        for i, n in enumerate(lens):
            assert not out[i, n:].any()
            assert n == 0 or not np.array_equal(out[i, :n], x[i, :n])

    def test_branch_rule_static_zeros(self, rng):
        """Any static numeric zero is off (int 0 and numpy zeros): alpha or
        p alone is clean audio; sigma wins over the mixture; the JAX rule
        gives the same branches."""
        x = _waves(rng, b=2)
        cases = [
            (dict(alpha=0.05), "clean"), (dict(p=0.01), "clean"),
            (dict(p=0, alpha=0.05), "clean"),
            (dict(p=np.float32(0.0), alpha=0.05), "clean"),
            (dict(sigma=np.int64(0), snr_db=10.0), "snr"),
            (dict(sigma=0, p=0.01, alpha=0.05), "mixture"),
            (dict(sigma=0.01, p=0.01, alpha=0.05), "white"),
            (dict(sigma=torch.tensor(0.0)), "white"), ({}, "clean"),
        ]
        for kw, kind in cases:
            assert bb.noise_kind(**kw) == kind, kw
            if any(isinstance(v, torch.Tensor) for v in kw.values()):
                continue  # on even at 0.0, so it adds zero noise
            out = bb.noisy_waves(x, _gen(5), **kw).numpy()
            assert np.array_equal(out, x) == (kind == "clean"), kw
            jout = np.asarray(jbb.noisy_waves(x, jax.random.PRNGKey(0), **kw))
            assert np.array_equal(jout, x) == (kind == "clean"), kw


class TestSliced:
    def test_noise_then_slice(self, rng):
        """The speaker form noises each whole recording (one draw a
        recording, in order), then slices 1-s windows and featurizes them;
        labels repeat per window. Redone by hand from the same seed it is
        bit-equal, and its windows and labels are the JAX function's."""
        cfg = FrontendConfig.speaker()
        sr = cfg.sr
        recs = [(rng.standard_normal(n) * 0.1).astype(np.float32)
                for n in (4 * sr + 100, int(2.5 * sr), 3 * sr)]
        labels = np.array([3, 1, 7])
        feats, labs = bb.audio_noise_features_sliced(
            recs, labels, cfg, _gen(6), sigma=0.01, device="cpu")
        g = _gen(6)
        wins = [slice_seconds((_t(r) + 0.01 * torch.randn(
            len(r), generator=g)).numpy(), sr) for r in recs]
        want = Frontend(cfg, device="cpu").flat(
            np.concatenate(wins)).numpy()
        np.testing.assert_array_equal(feats, want)
        _, jlabs = jbb.audio_noise_features_sliced(
            recs, labels, JConfig.speaker(), jax.random.PRNGKey(0),
            sigma=0.01, backend="xla")
        assert feats.shape == (3, 2020)  # 2 + 0 + 1 windows
        np.testing.assert_array_equal(labs, [3, 3, 7])
        np.testing.assert_array_equal(labs, jlabs)
        # nothing long enough: empty features of the preset's width
        f0, l0 = bb.audio_noise_features_sliced(
            recs[1:2], labels[1:2], cfg, _gen(7), snr_db=10.0, device="cpu")
        assert f0.shape == (0, 2020) and l0.shape == (0,)
