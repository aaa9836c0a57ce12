"""The port's frontend alternates against the JAX package and the f64 oracle
on the CPU: `mfcc_fft_batch` (the torch.fft.rfft chain), the radix-2 split
of `mel_power_plain` (`dft_split_levels`), the hop-block rDFT in fp32 and
int8 (ops/mfcc_hopdft.py), their support predicates and refusals, the
`Frontend` backends with `auto`, and `InferenceEngine(backend=...)`.

Tolerances: against the JAX function on the same numpy waves 1e-4 abs (two
fp32 pipelines; the finish runs in f64 here); against the oracle the JAX
suite's own bars for each path (tests/test_frontend.py: the rfft chain
atol 2e-3 rtol 1e-4, the hop-block paths atol 1e-3 rtol 1e-4); the split
against the direct path 1e-4 (the JAX suite's bar).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_using_robust_nn_tpu.ops import mfcc_hopdft as jhop
from asr_using_robust_nn_tpu.ops import mfcc_xla as jx
from asr_using_robust_nn_tpu_torch.frontend import mfcc as fe_mod
from asr_using_robust_nn_tpu_torch.frontend.mfcc import Frontend, auto_backend
from asr_using_robust_nn_tpu_torch.ops import frontend_ref
from asr_using_robust_nn_tpu_torch.ops import mfcc_hopdft as hop
from asr_using_robust_nn_tpu_torch.ops.mfcc_torch import (
    FrontendConfig, mel_power_plain, mfcc_fft_batch, mfcc_torch_batch)

PRESETS = ["digit", "speaker"]
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread keeps the file near its solo time under the suite's
    worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(preset):
    return getattr(FrontendConfig, preset)(), getattr(jx.FrontendConfig,
                                                      preset)()


def _spread_waves(n, seed):
    """Noise at four amplitudes from 0.02 to 1 (the JAX suite's rows)."""
    rng = np.random.default_rng(seed)
    amps = np.array([0.02, 0.2, 1.0, 0.5])[:n, None]
    return (rng.standard_normal((n, 22050)) * amps).astype(np.float32)


def _oracle(w, cfg):
    return np.stack([frontend_ref.mfcc_fixed_length_ref(
        row, cfg.utterance_length, sr=cfg.sr, n_fft=cfg.n_fft,
        hop_length=cfg.hop_length, win_length=cfg.win_length)
        for row in w])


@pytest.mark.parametrize("preset", PRESETS)
def test_fft_chain_vs_jax_and_oracle(preset):
    cfg, jcfg = _cfgs(preset)
    w = _spread_waves(3, seed=1)
    lens = np.array([22050, 9000, 300])
    got = mfcc_fft_batch(torch.from_numpy(w), cfg,
                         torch.from_numpy(lens)).numpy()
    want = np.asarray(jx.mfcc_fft_batch(jnp.asarray(w), jcfg,
                                        jnp.asarray(lens)))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    got = mfcc_fft_batch(torch.from_numpy(w), cfg).numpy()
    np.testing.assert_allclose(got, _oracle(w, cfg), atol=2e-3, rtol=1e-4)


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_split_vs_jax_and_direct(levels):
    """`dft_split_levels` on the plain path against JAX's split at the same
    levels (1e-4) and against the port's direct path (1e-4, the JAX
    suite's bar)."""
    cfg, jcfg = _cfgs("digit")
    cfg = dataclasses.replace(cfg, dft_split_levels=levels)
    jcfg = dataclasses.replace(jcfg, dft_split_levels=levels)
    w = _spread_waves(3, seed=levels)
    got = mfcc_torch_batch(torch.from_numpy(w), cfg).numpy()
    want = np.asarray(jx.mfcc_xla_batch(jnp.asarray(w), jcfg))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    direct = mfcc_torch_batch(torch.from_numpy(w),
                              FrontendConfig.digit()).numpy()
    np.testing.assert_allclose(got, direct, atol=1e-4, rtol=0)
    # the split also reaches Frontend('plain'), as in the JAX package
    fe = Frontend(cfg, backend="plain", device="cpu")
    np.testing.assert_array_equal(fe(w).numpy(), got)


@pytest.mark.parametrize("n_fft, hop, levels", [(441, 220, 1), (2048, 512, 10),
                                                (1024, 6, 2), (512, 256, 9)])
def test_split_refuses_what_does_not_divide(n_fft, hop, levels):
    cfg = dataclasses.replace(FrontendConfig.digit(), n_fft=n_fft,
                              win_length=n_fft, hop_length=hop,
                              dft_split_levels=levels)
    with pytest.raises(ValueError, match="2\\^\\(levels\\+1\\) \\| n_fft"):
        mel_power_plain(torch.zeros(1, 4000), cfg)


@pytest.mark.parametrize("variant, preset", [
    ("f32", "digit"), ("f32", "speaker"), ("int8", "digit")])
def test_hopdft_vs_jax_and_oracle(variant, preset):
    cfg, jcfg = _cfgs(preset)
    fn, jfn = {"f32": (hop.mfcc_hopdft_batch, jhop.mfcc_hopdft_batch),
               "int8": (hop.mfcc_hopdft_int8_batch,
                        jhop.mfcc_hopdft_int8_batch)}[variant]
    w = _spread_waves(4, seed=7)
    lens = np.array([22050, 15000, 22050, 4000])
    got = fn(torch.from_numpy(w), cfg, torch.from_numpy(lens)).numpy()
    want = np.asarray(jfn(jnp.asarray(w), jcfg, jnp.asarray(lens)))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    got = fn(torch.from_numpy(w), cfg).numpy()
    np.testing.assert_allclose(got, _oracle(w, cfg), atol=1e-3, rtol=1e-4)


def test_hopdft_int8_partials_and_combine_are_exact_integers():
    """The int8 path's block partials and phase combine are integers: the
    float64 digit GEMMs cast to int32 equal an int64 reference product, and
    the combine runs in int32."""
    from asr_using_robust_nn_tpu_torch.ops.mfcc_int8 import (
        _const_digits, _wave_digits, digit_sum_groups)
    from asr_using_robust_nn_tpu_torch.ops.mfcc_torch import center_pad

    cfg = FrontendConfig.digit()
    w = torch.from_numpy(_spread_waves(2, seed=3))
    cr, ci = hop.block_dft_constants(cfg)
    c_digits = _const_digits(np.concatenate([cr, ci], axis=1))
    y_digits, _ = _wave_digits(center_pad(w, cfg))
    n_frames = cfg.num_frames(22050)
    blocks = [hop._blocks(d, cfg, n_frames) for d in y_digits]
    wr, wi = (torch.from_numpy(a) for a in hop.combine_coeffs(cfg))
    for p, _ in digit_sum_groups(blocks, c_digits):
        assert p.dtype == torch.int32
        re, im = hop._combine_phase(p[..., :cfg.n_freq], p[..., cfg.n_freq:],
                                    wr, wi, cfg, n_frames)
        assert re.dtype == im.dtype == torch.int32
    i, j = 0, 0  # the leading digit pair, as an exact int64 product
    ref = blocks[i].long() @ torch.from_numpy(c_digits[j][0].astype(np.int64))
    f64 = (blocks[i].double() @ torch.from_numpy(
        c_digits[j][0].astype(np.float64))).to(torch.int32)
    assert torch.equal(ref.to(torch.int32), f64)
    assert int(ref.abs().max()) < 2 ** 31


def test_support_predicates_and_refusals():
    digit, speaker = FrontendConfig.digit(), FrontendConfig.speaker()
    for cfg in (digit, speaker,
                dataclasses.replace(digit, win_length=1024),
                dataclasses.replace(digit, hop_length=4096),
                dataclasses.replace(digit, hop_length=683)):
        jcfg = jx.FrontendConfig(**dataclasses.asdict(cfg))
        assert hop.hopdft_supported(cfg) == jhop.hopdft_supported(jcfg)
        assert hop.hopdft_int8_supported(cfg) == \
            jhop.hopdft_int8_supported(jcfg)
    assert hop.hopdft_supported(speaker)
    assert not hop.hopdft_int8_supported(speaker)
    with pytest.raises(ValueError, match="win == n_fft"):
        Frontend(dataclasses.replace(digit, win_length=1024),
                 backend="hopdft", device="cpu")
    with pytest.raises(ValueError, match="exact integer roots"):
        Frontend(speaker, backend="hopdft_int8", device="cpu")
    with pytest.raises(ValueError, match="unknown frontend backend"):
        Frontend(digit, backend="xla", device="cpu")
    for fn in (hop.mfcc_hopdft_batch, hop.mfcc_hopdft_int8_batch):
        with pytest.raises(ValueError):
            fn(torch.zeros(1, 22050), dataclasses.replace(
                digit, hop_length=4096))


def test_constants_equal_jax():
    for preset in PRESETS:
        cfg, jcfg = _cfgs(preset)
        for a, b in zip(hop.block_dft_constants(cfg),
                        jhop._block_dft_constants(jcfg)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(hop.tail_dft_constants(cfg),
                                      jhop._tail_dft_constants(jcfg))
        for a, b in zip(hop.combine_coeffs(cfg), jhop._combine_coeffs(jcfg)):
            np.testing.assert_array_equal(a, b)


def test_auto_resolves_by_table():
    """On the CPU, `auto` is 'cuda' for every config (its wrapper runs the
    plain twin there); on a CUDA device it is a lookup in `H100_TABLE`: the
    fastest backend holding `GOLDEN_BAR` on the goldens for a preset, K1
    for any other config. No device is touched: `auto_backend` is pure."""
    digit, speaker = FrontendConfig.digit(), FrontendConfig.speaker()
    odd = dataclasses.replace(digit, hop_length=300)
    for cfg in (digit, speaker, odd):
        assert auto_backend(cfg, CPU) == "cuda"
        assert Frontend(cfg, device="cpu").backend == "cuda"
    card = torch.device("cuda", 0)
    assert auto_backend(odd, card) == "cuda"
    assert set(fe_mod.H100_TABLE) == {"digit", "speaker"}
    for preset, cfg in (("digit", digit), ("speaker", speaker)):
        rows = fe_mod.H100_TABLE[preset]
        assert set(rows) <= set(Frontend._BACKENDS)
        held = {b: ms for b, (ms, err) in rows.items()
                if err <= fe_mod.GOLDEN_BAR}
        got = auto_backend(cfg, card)
        assert got in held and held[got] == min(held.values())


def test_frontend_backends_on_the_cpu():
    """Every backend through `Frontend` against the plain one, at the bar of
    its scheme (the plain fp32 pipeline is itself within 1e-3 of the
    oracle here)."""
    w = _spread_waves(2, seed=11)
    bars = {"cuda": 1e-4, "plain": 0.0, "fft": 1e-3, "int8": 2e-3,
            "hopdft": 1e-3, "hopdft_int8": 2e-3, "cuda_int8": 2e-3,
            "cuda_bf16x3": 3e-2}
    assert set(bars) == set(Frontend._BACKENDS)
    for preset in PRESETS:
        cfg = getattr(FrontendConfig, preset)()
        ref = Frontend(cfg, backend="plain", device="cpu")(w).numpy()
        for name, bar in bars.items():
            if name == "hopdft_int8" and preset == "speaker":
                continue  # refused at construction (above)
            got = Frontend(cfg, backend=name, device="cpu")(w).numpy()
            assert np.abs(got - ref).max() <= bar, (preset, name)


@pytest.mark.parametrize("backend", ["auto", "cuda", "plain", "fft", "int8",
                                     "hopdft", "hopdft_int8"])
def test_engine_backends_give_the_default_labels(backend):
    """`InferenceEngine(backend=...)` passes through to its Frontend; every
    backend gives the default engine's labels on seeded tone requests."""
    from asr_using_robust_nn_tpu_torch.models.mlp import MLPConfig, init_mlp
    from asr_using_robust_nn_tpu_torch.serve.engine import InferenceEngine

    cfg = MLPConfig.digit_constrained()
    params, state = init_mlp(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    rng = np.random.default_rng(5)
    feats = Frontend(FrontendConfig.digit(), backend="plain", device="cpu")
    t = np.arange(22050) / 22050.0
    w = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 3000, (6, 1)) * t)
         ).astype(np.float32)
    f = feats.flat(w).numpy()
    scaler = (f.mean(0), f.std(0) + 1.0)
    kw = dict(scaler=scaler, buckets=(8,), device="cpu")
    want = InferenceEngine(cfg, FrontendConfig.digit(), params, state,
                           **kw).classify(w)
    eng = InferenceEngine(cfg, FrontendConfig.digit(), params, state,
                          backend=backend, **kw)
    assert eng._fe.backend == ("cuda" if backend == "auto" else backend)
    got = eng.classify(w)
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["probs"], want["probs"], atol=1e-3)
