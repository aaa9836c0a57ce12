"""The port's Lipschitz analyzers and certificates
(asr_using_robust_nn_tpu_torch/constraints/lipschitz.py, certify.py) against
the JAX package's on the same seeded numpy trees and features.

Tolerances: the bounds and radii are fp32 SVDs and forwards summed in other
orders, 1e-4 relative. A certified-accuracy curve is a count of radii above
each eps, so the curves must be equal wherever no radius lies within 1e-4
relative of the eps (the grids below drop the points that do).
"""

import re

import jax
import numpy as np
import pytest
import torch

from asr_using_robust_nn_tpu.constraints import certify as jcert
from asr_using_robust_nn_tpu.constraints import lipschitz as jlip
from asr_using_robust_nn_tpu.models import mlp as jmlp
from asr_using_robust_nn_tpu_torch.constraints import certify as cert
from asr_using_robust_nn_tpu_torch.constraints import lipschitz as lip
from asr_using_robust_nn_tpu_torch.models import mlp
from asr_using_robust_nn_tpu_torch.models.convert import params_from_numpy

from conftest import blobs_task

KW = dict(in_dim=16, n_classes=4, hidden=(32, 16), dropout=(0.0, 0.0))
REL = 1e-4


def _model(seed, **kw):
    """Seeded JAX init as numpy, BN statistics moved off their init."""
    jcfg = jmlp.MLPConfig(**dict(KW, **kw))
    p, s = jax.tree_util.tree_map(
        np.asarray, jmlp.init_mlp(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for layer, st in zip(p["layers"], s["layers"]):
        if "gamma" in layer:
            layer["gamma"] = rng.uniform(0.5, 1.5, layer["gamma"].shape
                                         ).astype(np.float32)
            layer["beta"] = rng.normal(0, 0.1, layer["beta"].shape
                                       ).astype(np.float32)
            st["mean"] = rng.normal(0, 0.2, st["mean"].shape
                                    ).astype(np.float32)
            st["var"] = rng.uniform(0.3, 2.0, st["var"].shape
                                    ).astype(np.float32)
    return jcfg, mlp.MLPConfig(**dict(KW, **kw)), p, s


def _close(a, b, rel=REL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rel, atol=0)


@pytest.mark.parametrize("batch_norm", [True, False])
def test_analyzers_match_jax(batch_norm):
    jcfg, cfg, p, s = _model(1, batch_norm=batch_norm)
    tp, ts = params_from_numpy(p, s, device="cpu")
    norms = lip.get_norms(tp)
    _close(norms.numpy(), jlip.get_norms(p))
    _close(float(lip.get_upper_lipschitz(norms)),
           float(jlip.get_upper_lipschitz(jlip.get_norms(p))))
    _close(float(lip.get_lipschitz_constrained(cfg, tp, ts)),
           float(jlip.get_lipschitz_constrained(jcfg, p, s)))
    _close(float(lip.get_lipschitz_sound(cfg, tp, ts)),
           float(jlip.get_lipschitz_sound(jcfg, p, s)))


def _numbers(lines):
    return [float(v) for ln in lines
            for v in re.findall(r"[-+]?\d+\.\d+(?:e[-+]?\d+)?", ln)]


def test_lipschitz_monitor_prints_the_jax_lines():
    jcfg, cfg, p, s = _model(2)
    tp, ts = params_from_numpy(p, s, device="cpu")
    got, want = [], []
    lip.lipschitz_monitor(cfg, got.append)(3, tp, ts, {})
    jlip.lipschitz_monitor(jcfg, want.append)(3, p, s, {})
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert re.sub(r"[\d.e+-]+", "#", g) == re.sub(r"[\d.e+-]+", "#", w)
    _close(_numbers(got), _numbers(want), rel=1e-3)  # printed at 4 digits


def _data(seed, n=200):
    x, y = blobs_task(np.random.default_rng(seed), n=n, d=16, k=4,
                      spread=1.0)
    return x, y.astype(np.int64)


def _safe_grid(radii_sets, scale):
    """A grid over the radii's range without points within REL of any
    radius."""
    r = np.concatenate([np.asarray(v, np.float64) for v in radii_sets])
    grid = np.linspace(0.0, scale, 41)
    keep = [e for e in grid
            if e == 0.0 or np.all(np.abs(r - e) > REL * e)]
    return np.asarray(keep)


@pytest.mark.parametrize("batch_norm", [True, False])
def test_certified_radii_match_jax(batch_norm):
    jcfg, cfg, p, s = _model(4, batch_norm=batch_norm)
    x, y = _data(5)
    radii, correct, lb = cert.certified_radii(cfg, p, s, x, y, device="cpu")
    jr, jc, jl = jcert.certified_radii(jcfg, p, s, x, y)
    assert radii.shape == (len(x),) and radii.dtype == np.float32
    np.testing.assert_array_equal(correct, jc)
    assert 0 < correct.sum() < len(x)
    _close(lb, jl)
    np.testing.assert_allclose(radii, jr, rtol=REL, atol=1e-7)
    assert np.all(radii[~correct] == 0.0)
    grid = _safe_grid([radii, jr], float(np.max(jr)) * 1.1)
    for norm in ("l2", "linf"):
        np.testing.assert_array_equal(
            cert.certified_accuracy_curve(radii, correct, grid, norm, d=16),
            jcert.certified_accuracy_curve(jr, jc, grid, norm, d=16))


def test_certify_sweep_matches_jax(tmp_path):
    jcfg_c, cfg_c, pc, sc = _model(6, nonneg=True)
    for layer in pc["layers"]:
        layer["w"] = np.abs(layer["w"]) * 0.3
    jcfg_u, cfg_u, pu, su = _model(7, batch_norm=False)
    x, y = _data(8)
    rc, _, _ = cert.certified_radii(cfg_c, pc, sc, x, y, device="cpu")
    ru, _, _ = cert.certified_radii(cfg_u, pu, su, x, y, device="cpu")
    grid = _safe_grid([rc, ru], float(max(rc.max(), ru.max())))
    res = cert.certify_sweep(cfg_c, pc, sc, cfg_u, pu, su, x, y, grid,
                             device="cpu")
    jres = jcert.certify_sweep(jcfg_c, pc, sc, jcfg_u, pu, su, x, y, grid)
    got, want = res.as_dict(), jres.as_dict()
    assert got.keys() == want.keys()
    for k in ("strengths", "certified_constrained",
              "certified_unconstrained"):
        assert got[k] == want[k]
    for k in ("lipschitz_sound_constrained", "lipschitz_sound_unconstrained"):
        _close(got[k], want[k])
    for k in ("radius_stats_constrained", "radius_stats_unconstrained"):
        assert got[k].keys() == want[k].keys()
        assert got[k]["n_correct"] == want[k]["n_correct"]
        _close([got[k][m] for m in ("mean", "median", "max")],
               [want[k][m] for m in ("mean", "median", "max")])
    curve = got["certified_constrained"]
    assert all(a >= b for a, b in zip(curve, curve[1:]))
    import matplotlib

    matplotlib.use("Agg")
    ax = res.plot()
    ax.figure.savefig(tmp_path / "c.png")
    assert len(ax.lines) == 2


def test_curve_argument_errors_and_eps0():
    radii = np.array([0.5, 0.0, 1.0])
    correct = np.array([True, False, True])
    with pytest.raises(ValueError, match="needs d"):
        cert.certified_accuracy_curve(radii, correct, [0.1], norm="linf")
    with pytest.raises(ValueError, match="'l2' or 'linf'"):
        cert.certified_accuracy_curve(radii, correct, [0.1], norm="l1")
    np.testing.assert_array_equal(
        cert.certified_accuracy_curve(radii, correct, [0.0, 0.5, 0.9]),
        [2 / 3, 1 / 3, 1 / 3])
    assert cert._radius_stats(radii, np.zeros(3, bool)) == {"n_correct": 0}


def test_sound_bound_is_a_bound():
    """The sound constant bounds every finite difference of the logits."""
    _, cfg, p, s = _model(9)
    tp, ts = params_from_numpy(p, s, device="cpu")
    bound = float(lip.get_lipschitz_sound(cfg, tp, ts))
    g = torch.Generator().manual_seed(0)
    x = torch.randn(64, 16, generator=g)
    dx = torch.randn(64, 16, generator=g) * 1e-2
    f = lambda v: mlp.apply_mlp(cfg, tp, ts, v)[0]  # noqa: E731
    ratio = (torch.linalg.norm(f(x + dx) - f(x), dim=1)
             / torch.linalg.norm(dx, dim=1))
    assert float(ratio.max()) <= bound
    assert np.isfinite(bound)
