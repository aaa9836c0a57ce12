"""The speaker study's analysis block and MFCC sweeps at the speaker widths
(2020 -> 1024 -> 512 -> 256 -> 128 -> 64 -> 20), the port against the JAX
package, on the CPU, from one set of weights carried across.

The weights are JAX's initial ones with a BatchNorm state that a long
constrained fit leaves behind: units whose running variance sits far under
`bn_eps` (near-dead units), gamma of both signs. On them:

- `get_lipschitz_constrained` (the reference's formula), `get_lipschitz_sound`
  and `get_norms` agree within 1e-4 relative (SVDs: float64 in the port,
  float32 in the JAX package);
- the two MFCC-domain sweeps of the speaker study (white and mixture noise on
  the raw features, the scaler refit on [train; dev; attacked test] after
  the attack, `SR/attacks.py:348`) agree with `blackbox_sweep(...,
  standardize=std)` of the JAX package: the clean point exactly, the noisy
  points (other draws: threefry against torch's generator) within
  4 sqrt(2 p (1 - p) / n) plus one row.
"""

import jax
import numpy as np
import pytest
import torch

from asr_using_robust_nn_tpu.attacks import sweeps as jsweeps
from asr_using_robust_nn_tpu.constraints import (
    get_lipschitz_constrained as jlip,
    get_lipschitz_sound as jlip_sound,
    get_norms as jnorms,
)
from asr_using_robust_nn_tpu.data import standardize_fit_all as jstd
from asr_using_robust_nn_tpu.models import mlp as jmlp
from asr_using_robust_nn_tpu_torch.attacks.sweeps import GRIDS, blackbox_sweep
from asr_using_robust_nn_tpu_torch.constraints import (
    get_lipschitz_constrained, get_lipschitz_sound, get_norms)
from asr_using_robust_nn_tpu_torch.data.pipeline import standardize_fit_all
from asr_using_robust_nn_tpu_torch.examples._study import model_fns
from asr_using_robust_nn_tpu_torch.models.convert import params_from_numpy
from asr_using_robust_nn_tpu_torch.models.mlp import MLPConfig

CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _carried(jcfg, seed, dead_share=0.1):
    """JAX's initial weights of `jcfg` with a trained-looking BN state:
    running means off zero, running variances spread over 1e-3 .. 2 with
    `dead_share` of each layer's units at 1e-7 .. 1e-6 (under bn_eps), and
    gamma drawn around 1 with a fifth of it negative."""
    p, s = _np_tree(jmlp.init_mlp(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    dead = 0
    for lp, ls in zip(p["layers"], s["layers"]):
        if "var" not in ls:
            continue
        n = ls["var"].shape[0]
        var = 10.0 ** rng.uniform(-3, 0.3, n)
        off = rng.random(n) < dead_share
        var[off] = 10.0 ** rng.uniform(-7, -6, int(off.sum()))
        dead += int(off.sum())
        ls["var"] = var.astype(np.float32)
        ls["mean"] = rng.normal(0, 0.5, n).astype(np.float32)
        g = rng.normal(1.0, 0.4, n)
        g[rng.random(n) < 0.2] *= -1
        lp["gamma"] = g.astype(np.float32)
        lp["beta"] = rng.normal(0, 0.2, n).astype(np.float32)
    assert dead > 0 or not jcfg.batch_norm
    return p, s


def test_speaker_width_analysis_matches_jax():
    jcfg = jmlp.MLPConfig.speaker_constrained()
    cfg = MLPConfig.speaker_constrained()
    p, s = _carried(jcfg, seed=3)
    assert min(float(ls["var"].min()) for ls in s["layers"]
               if "var" in ls) < 1e-3 * jcfg.bn_eps
    tp, ts = params_from_numpy(p, s, device=CPU)
    pairs = {
        "lipschitz_constrained": (get_lipschitz_constrained(cfg, tp, ts),
                                  jlip(jcfg, p, s)),
        "lipschitz_sound": (get_lipschitz_sound(cfg, tp, ts),
                            jlip_sound(jcfg, p, s)),
        "norms": (get_norms(tp), jnorms(p)),
    }
    for k, (got, want) in pairs.items():
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        assert np.all(np.isfinite(got)) and got.shape == want.shape, k
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("attack", ["white_mfcc", "mixture_mfcc"])
def test_speaker_width_mfcc_sweeps_match_jax(attack):
    rng = np.random.default_rng(8)
    loc = rng.normal(0, 60, 2020)
    scale = 10.0 ** rng.uniform(0.5, 1.7, 2020)

    def raw(n):
        return (loc + scale * rng.standard_normal((n, 2020))).astype(
            np.float32)

    train, dev, test = raw(400), raw(100), raw(120)
    models = {}
    for name in ("unconstrained", "constrained"):
        jcfg = getattr(jmlp.MLPConfig, f"speaker_{name}")()
        cfg = getattr(MLPConfig, f"speaker_{name}")()
        p, s = _carried(jcfg, seed=4 if name == "constrained" else 5)
        tp, ts = params_from_numpy(p, s, device=CPU)

        def jpredict(x, jcfg=jcfg, p=p, s=s):
            return np.asarray(jax.nn.softmax(jmlp.apply_mlp(
                jcfg, p, s, jax.numpy.asarray(x, jax.numpy.float32),
                train=False)[0], -1))

        models[name] = (model_fns(cfg, tp, ts, CPU)[1], jpredict)

    def std(feats):
        return standardize_fit_all(train, dev, feats)[2]

    def jstd_after(feats):
        return jstd(train, dev, feats)[2]

    # labels: the constrained model's clean answers, so that its curve
    # starts at 1 and the noise has something to take away
    labels = np.argmax(models["constrained"][1](jstd_after(test)), -1)
    assert len(np.unique(labels)) > 1
    strengths = list(GRIDS["mfcc_sigmas" if attack == "white_mfcc"
                           else "mfcc_alphas"])
    got = blackbox_sweep(attack, models["constrained"][0],
                         models["unconstrained"][0], labels,
                         strengths=strengths, test_features=test,
                         standardize=std, seed=0, device=CPU).as_dict()
    want = jsweeps.blackbox_sweep(attack, models["constrained"][1],
                                  models["unconstrained"][1], labels,
                                  strengths=strengths, test_features=test,
                                  standardize=jstd_after, seed=0).as_dict()
    n = len(labels)
    row = 1.0 / n + 1e-9
    assert got["accuracy_constrained"][0] == 1.0
    for side in ("accuracy_constrained", "accuracy_unconstrained"):
        g, w = np.asarray(got[side]), np.asarray(want[side])
        assert g.shape == w.shape == (len(strengths),), side
        assert g[0] == w[0], (side, g[0], w[0])  # the clean point
        for st, a, b in zip(strengths[1:], g[1:], w[1:]):
            q = (a + b) / 2
            tol = 4 * np.sqrt(2 * q * (1 - q) / n) + row
            assert abs(a - b) <= tol, (side, st, a, b, tol)
    # the noise moves the constrained curve (else the check holds nothing)
    assert min(got["accuracy_constrained"]) < 0.9
