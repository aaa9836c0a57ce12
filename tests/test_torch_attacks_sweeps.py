"""The port's robustness sweeps (asr_using_robust_nn_tpu_torch/attacks/
sweeps.py): the grids against the JAX package's, the fused audio sweep
against the port's unfused blackbox_sweep with the same seed, the per-point
scaler refit against standardize_fit_all, the clean sweep point against the
JAX fused sweep, the per-point generator rule, the sliced speaker sweep and
whitebox_sweep's rules.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_using_robust_nn_tpu.attacks import sweeps as jsweeps
from asr_using_robust_nn_tpu.models import mlp as jmlp
from asr_using_robust_nn_tpu.ops.mfcc_xla import FrontendConfig as JConfig
from asr_using_robust_nn_tpu_torch.attacks import sweeps
from asr_using_robust_nn_tpu_torch.data.pipeline import standardize_fit_all
from asr_using_robust_nn_tpu_torch.models import mlp
from asr_using_robust_nn_tpu_torch.models.convert import params_from_numpy
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


def _model(in_dim, n_classes, seed):
    """A small JAX-initialized model: (JAX logits, port logits, port
    predict)."""
    jcfg = jmlp.MLPConfig(in_dim=in_dim, n_classes=n_classes, hidden=(16,),
                          dropout=(0.0,))
    jp, js = jmlp.init_mlp(jcfg, jax.random.PRNGKey(seed))
    cfg = mlp.MLPConfig(in_dim=in_dim, n_classes=n_classes, hidden=(16,),
                        dropout=(0.0,))
    p, s = params_from_numpy(jax.tree.map(np.asarray, jp),
                             jax.tree.map(np.asarray, js), CPU)

    def jlogits(xx):
        return jmlp.apply_mlp(jcfg, jp, js, jnp.asarray(xx, jnp.float32),
                              train=False)[0]

    def logits(xx):
        return mlp.apply_mlp(cfg, p, s, xx, train=False)[0]

    @torch.no_grad()
    def predict(xx):
        return torch.softmax(logits(torch.as_tensor(
            np.asarray(xx, np.float32))), -1).numpy()

    return jlogits, logits, predict


@pytest.fixture(scope="module")
def digit_case():
    """12 one-second waves (3 with a masked tail), labels, train/dev
    features for the refit, two 880-wide models."""
    rng = np.random.default_rng(0)
    n = 12
    waves = (rng.standard_normal((n, 22050)) * 0.1).astype(np.float32)
    lengths = np.full((n,), 22050, np.int64)
    lengths[:3] = 15000
    waves[:3, 15000:] = 0.0
    labels = rng.integers(0, 4, n).astype(np.int64)
    tr = rng.standard_normal((40, 880)) * 20 - 5
    dv = rng.standard_normal((10, 880)) * 20 - 5
    return waves, lengths, labels, tr, dv, _model(880, 4, 0), _model(880, 4, 1)


def test_grids_equal_jax():
    assert sorted(sweeps.GRIDS) == sorted(jsweeps.GRIDS)
    for k, v in jsweeps.GRIDS.items():
        np.testing.assert_array_equal(np.asarray(sweeps.GRIDS[k]),
                                      np.asarray(v), err_msg=k)


def test_refit_equals_standardize_fit_all(digit_case):
    """refit_standardize from the train+dev moments reduced once equals
    standardize_fit_all on the concatenation: 1e-5; a constant feature
    keeps scale 1."""
    _, _, _, tr, dv, _, _ = digit_case
    rng = np.random.default_rng(1)
    feats = (rng.standard_normal((12, 880)) * 30 + 7).astype(np.float32)
    tr, dv = tr.copy(), dv.copy()
    tr[:, 3] = dv[:, 3] = feats[:, 3] = 2.5  # constant column
    n1, mu1, m21 = sweeps._moments(torch.from_numpy(
        np.concatenate([tr, dv])))
    got = sweeps.refit_standardize(torch.from_numpy(feats), n1, mu1, m21)
    want = standardize_fit_all(tr, dv, feats)[2]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert not got[:, 3].any()


@pytest.mark.parametrize("attack,grid", [
    ("white_audio", [0.0, 0.02, 0.05]),
    ("mixture_audio", [0.0, 0.01]),
    ("snr_audio", [30.0, 0.0]),
])
def test_fused_equals_unfused(digit_case, attack, grid):
    """The fused sweep and blackbox_sweep (noise -> features -> the
    standardize callable -> predict) with the same seed draw the same noise:
    curves equal at 1e-6."""
    waves, lengths, labels, tr, dv, (_, lc, pc), (_, lu, pu) = digit_case
    cfg = FrontendConfig.digit()

    def std(feats):
        return standardize_fit_all(tr, dv, feats)[2]

    unfused = sweeps.blackbox_sweep(
        attack, pc, pu, labels, strengths=grid, test_waves=waves,
        lengths=lengths, frontend_cfg=cfg, standardize=std, seed=7,
        device="cpu")
    fused = sweeps.fused_audio_sweep(
        attack, lc, lu, labels, test_waves=waves, lengths=lengths,
        frontend_cfg=cfg, strengths=grid, refit_arrays=(tr, dv), seed=7,
        device="cpu")
    for k in ("accuracy_constrained", "accuracy_unconstrained"):
        np.testing.assert_allclose(getattr(fused, k), getattr(unfused, k),
                                   atol=1e-6)
    np.testing.assert_array_equal(fused.strengths, grid)


def test_clean_point_equals_jax_fused(digit_case):
    """At strength 0 the white sweep runs the clean path: the port's fused
    point and the JAX package's (backend xla) give the same two accuracies,
    within 1/n (features agree at the cross-package MFCC bar, so only a
    borderline argmax could differ)."""
    waves, lengths, labels, tr, dv, (jlc, lc, _), (jlu, lu, _) = digit_case
    want = jsweeps.fused_audio_sweep(
        "white_audio", jlc, jlu, labels, test_waves=waves, lengths=lengths,
        frontend_cfg=JConfig.digit(), strengths=[0.0],
        refit_arrays=(tr, dv), backend="xla")
    got = sweeps.fused_audio_sweep(
        "white_audio", lc, lu, labels, test_waves=waves, lengths=lengths,
        frontend_cfg=FrontendConfig.digit(), strengths=[0.0],
        refit_arrays=(tr, dv), device="cpu")
    n = len(labels)
    for k in ("accuracy_constrained", "accuracy_unconstrained"):
        assert np.abs(getattr(got, k) - getattr(want, k)).max() <= 1 / n


def test_point_generator_rule():
    """Point i of seed s is seeded with a hash of (s, i): reproducible,
    distinct across points and seeds, also in the low 32 bits the CPU
    generator keeps."""
    draw = lambda s, i: torch.randn(  # noqa: E731
        4, generator=sweeps.point_generator(s, i, CPU))
    assert torch.equal(draw(3, 1), draw(3, 1))
    assert not torch.equal(draw(3, 1), draw(3, 2))
    assert not torch.equal(draw(3, 1), draw(4, 1))
    word = np.random.SeedSequence((3, 1)).generate_state(1, np.uint64)[0]
    assert sweeps.point_generator(3, 1, CPU).initial_seed() == int(word)


def test_mfcc_sweeps_degrade_and_are_seeded(digit_case):
    """Feature-domain noise: accuracy at sigma 0 is the clean accuracy, the
    curve falls with sigma, and the same seed repeats the curve."""
    rng = np.random.default_rng(2)
    means = rng.standard_normal((4, 24)) * 3
    y = rng.integers(0, 4, 200)
    x = (means[y] + rng.standard_normal((200, 24)) * 0.3).astype(np.float32)

    def predict(xx):  # nearest class mean
        d = ((np.asarray(xx)[:, None, :] - means[None]) ** 2).sum(-1)
        return -d

    res = sweeps.blackbox_sweep("white_mfcc", predict, predict, y,
                                strengths=[0.0, 3.0, 30.0], test_features=x,
                                device="cpu")
    assert res.accuracy_constrained[0] == 1.0
    assert res.accuracy_constrained[2] < 0.5
    same = sweeps.blackbox_sweep("white_mfcc", predict, predict, y,
                                 strengths=[0.0, 3.0, 30.0], test_features=x,
                                 device="cpu")
    np.testing.assert_array_equal(same.accuracy_constrained,
                                  res.accuracy_constrained)
    again = sweeps.blackbox_sweep("mixture_mfcc", predict, predict, y,
                                  strengths=[0.0, 5.0], test_features=x,
                                  mixture_p=0.5, device="cpu", seed=1)
    assert again.accuracy_constrained[0] == 1.0
    assert again.accuracy_constrained[1] < 1.0
    with pytest.raises(ValueError, match="unknown blackbox attack"):
        sweeps.blackbox_sweep("nope", predict, predict, y, strengths=[1.0],
                              device="cpu")


def test_speaker_sliced_sweep():
    """The speaker form: recordings noised whole, sliced, one frontend call
    a point; labels per window; the two models see the same features."""
    rng = np.random.default_rng(3)
    cfg = FrontendConfig.speaker()
    recs = [(rng.standard_normal(n) * 0.1).astype(np.float32)
            for n in (4 * cfg.sr, 3 * cfg.sr + 10)]
    _, _, predict = _model(2020, 5, 2)
    res = sweeps.blackbox_sweep("snr_audio", predict, predict, [1, 2],
                                strengths=[60.0, 0.0], test_waves_list=recs,
                                frontend_cfg=cfg, device="cpu")
    assert res.accuracy_constrained.shape == (2,)
    np.testing.assert_array_equal(res.accuracy_constrained,
                                  res.accuracy_unconstrained)
    # accuracies over 3 windows
    assert set(np.round(res.accuracy_constrained * 3, 6)) <= {0, 1, 2, 3}


def test_whitebox_sweep_rules():
    """jsma with label_source='true' raises; jsma evaluates the first 100
    samples by default; the result's dict and accuracy on tensors."""
    _, logits, predict = _model(8, 3, 3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((130, 8)).astype(np.float32)
    y = rng.integers(0, 3, 130)
    with pytest.raises(ValueError, match="does not apply to jsma"):
        sweeps.whitebox_sweep("jsma", logits, logits, predict, predict, x, y,
                              label_source="true", device="cpu")
    res = sweeps.whitebox_sweep("jsma", logits, logits, predict, predict, x,
                                y, strengths=[1.0], device="cpu")
    assert float(res.accuracy_constrained[0] * 100).is_integer()
    first = sweeps.whitebox_sweep("jsma", logits, logits, predict, predict,
                                  x[:100], y[:100], strengths=[1.0],
                                  device="cpu")
    np.testing.assert_array_equal(res.accuracy_constrained,
                                  first.accuracy_constrained)
    d = res.as_dict()
    assert d["attack"] == "jsma" and d["strengths"] == [1.0]
    assert sweeps.accuracy(torch.eye(3), torch.tensor([0, 2, 2])) == 2 / 3
    cw = sweeps.whitebox_sweep("cw_linf", logits, logits, predict, predict,
                               x[:8], y[:8], device="cpu")
    assert np.asarray(cw.strengths).tolist() == [10.0]
