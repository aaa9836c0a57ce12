"""The port's MLP (asr_using_robust_nn_tpu_torch/models) against the JAX
package's: the same parameters (made by JAX `init_mlp`, carried over with
`params_from_numpy`) and the same numpy inputs through both `apply_mlp`s.

Tolerance 1e-5 (rtol and atol): two fp32 forward passes of a 6-layer stack
whose GEMMs sum in different orders; this is the model-forward bar of the
port (ROADMAP.md).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from asr_using_robust_nn_tpu.models import mlp as jmlp
from asr_using_robust_nn_tpu_torch.models import mlp
from asr_using_robust_nn_tpu_torch.models.convert import (
    params_from_numpy,
    params_to_numpy,
)

PRESETS = ["digit_unconstrained", "digit_constrained",
           "speaker_unconstrained", "speaker_constrained"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _jax_tree(preset, seed=0):
    """JAX-initialized params with non-trivial BN affine and moving stats,
    as numpy arrays."""
    jcfg = getattr(jmlp.MLPConfig, preset)()
    params, state = jax.tree_util.tree_map(
        np.asarray, jmlp.init_mlp(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for p, s in zip(params["layers"], state["layers"]):
        if "gamma" in p:
            n = p["gamma"].shape[0]
            p["gamma"] = (0.5 + rng.random(n)).astype(np.float32)
            p["beta"] = (0.1 * rng.standard_normal(n)).astype(np.float32)
            s["mean"] = (0.2 * rng.random(n)).astype(np.float32)
            s["var"] = (0.5 + rng.random(n)).astype(np.float32)
    return jcfg, params, state


def _x(cfg, n=12, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (n, cfg.in_dim)).astype(np.float32)


@pytest.mark.parametrize("preset", PRESETS)
def test_config_equal_jax(preset):
    cfg = getattr(mlp.MLPConfig, preset)()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        getattr(jmlp.MLPConfig, preset)())
    assert cfg.n_dense == 6


@pytest.mark.parametrize("preset", PRESETS)
def test_eval_forward_matches_jax(preset):
    jcfg, jp, js = _jax_tree(preset)
    cfg = getattr(mlp.MLPConfig, preset)()
    params, state = params_from_numpy(jp, js, device="cpu")
    x = _x(cfg)
    want, _ = jmlp.apply_mlp(jcfg, jp, js, x, train=False)
    got, new_state = mlp.apply_mlp(cfg, params, state, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        mlp.predict_probs(cfg, params, state, torch.from_numpy(x)).numpy(),
        np.asarray(jmlp.predict_probs(jcfg, jp, js, x)), **TOL)
    # eval leaves the moving statistics as they were
    for s0, s1 in zip(state["layers"], new_state["layers"]):
        for k in s0:
            assert torch.equal(s0[k], s1[k])


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("row_weights", [False, True])
def test_train_forward_matches_jax(preset, row_weights):
    """Train mode at dropout 0 (no rng / generator): batch moments, with
    and without per-row weights (zero-weight rows must drop out of the
    statistics), and the momentum update of the moving statistics."""
    jcfg, jp, js = _jax_tree(preset, seed=2)
    cfg = getattr(mlp.MLPConfig, preset)()
    params, state = params_from_numpy(jp, js, device="cpu")
    x = _x(cfg, n=32, seed=3)
    w = None
    if row_weights:
        w = np.ones(x.shape[0], np.float32)
        w[-8:] = 0.0
    want, want_state = jmlp.apply_mlp(jcfg, jp, js, x, train=True,
                                      weights=w)
    got, got_state = mlp.apply_mlp(
        cfg, params, state, torch.from_numpy(x), train=True,
        weights=None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for gs, ws in zip(got_state["layers"], want_state["layers"]):
        assert gs.keys() == ws.keys()
        for k in gs:
            np.testing.assert_allclose(gs[k].numpy(), np.asarray(ws[k]),
                                       **TOL)


def test_zero_weight_rows_do_not_move_batch_stats():
    cfg = mlp.MLPConfig.digit_constrained()
    params, state = mlp.init_mlp(cfg, torch.Generator().manual_seed(0),
            device="cpu")
    x = torch.from_numpy(_x(cfg, n=8, seed=4))
    w = torch.tensor([1.0] * 6 + [0.0] * 2)
    noise = x.clone()
    noise[6:] = 1e3  # padded rows with wild content and weight 0
    _, s_a = mlp.apply_mlp(cfg, params, state, x, train=True, weights=w)
    _, s_b = mlp.apply_mlp(cfg, params, state, noise, train=True, weights=w)
    for a, b in zip(s_a["layers"], s_b["layers"]):
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=1e-6, atol=1e-6)


def test_bf16_compute_matches_jax():
    """bf16-rounded GEMM operands with fp32 sums on both sides. 2e-2: a
    1e-7 difference upstream can flip one bf16 rounding (2^-8 relative) of
    an activation, which the remaining layers carry to the logits."""
    jcfg, jp, js = _jax_tree("digit_unconstrained", seed=5)
    jcfg = jcfg.with_bf16()
    cfg = mlp.MLPConfig.digit_unconstrained().with_bf16()
    params, state = params_from_numpy(jp, js, device="cpu")
    x = _x(cfg, seed=6)
    want, _ = jmlp.apply_mlp(jcfg, jp, js, x)
    got, _ = mlp.apply_mlp(cfg, params, state, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2,
                               atol=2e-2)


def test_dropout_from_generator():
    """Dropout draws come from the given torch.Generator: the same seed
    gives the same output, kept units are scaled by 1/keep, and about
    `rate` of the first block's units are dropped."""
    cfg = dataclasses.replace(mlp.MLPConfig.digit_unconstrained(),
                              batch_norm=False, hidden=(4096,),
                              dropout=(0.4,))
    params, state = mlp.init_mlp(cfg, torch.Generator().manual_seed(1),
            device="cpu")
    params["layers"][1]["w"] = torch.eye(4096)[:, :10]  # expose block 1
    x = torch.from_numpy(_x(cfg, n=64, seed=7))
    a, _ = mlp.apply_mlp(cfg, params, state, x, train=True,
                         generator=torch.Generator().manual_seed(9))
    b, _ = mlp.apply_mlp(cfg, params, state, x, train=True,
                         generator=torch.Generator().manual_seed(9))
    assert torch.equal(a, b)
    clean, _ = mlp.apply_mlp(cfg, params, state, x, train=False)
    live = clean != 0
    kept = (a != 0) & live
    np.testing.assert_allclose(a[kept].numpy(), (clean[kept] / 0.6).numpy(),
                               rtol=1e-6)
    assert 0.3 < 1 - kept.sum().item() / live.sum().item() < 0.5


def test_init_mlp_glorot_and_layout():
    cfg = mlp.MLPConfig.speaker_constrained()
    params, state = mlp.init_mlp(cfg, torch.Generator().manual_seed(0),
            device="cpu")
    jp, js = jmlp.init_mlp(getattr(jmlp.MLPConfig, "speaker_constrained")(),
                           jax.random.PRNGKey(0))
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda _: 0, (jp, js))) == \
        jax.tree_util.tree_structure(
            jax.tree_util.tree_map(lambda _: 0, (params, state)))
    for p, q in zip(params["layers"], jp["layers"]):
        assert p["w"].shape == q["w"].shape
        limit = np.sqrt(6.0 / sum(p["w"].shape))
        assert p["w"].abs().max() <= limit and p["w"].std() > limit / 3
        assert not p["b"].any()
    again, _ = mlp.init_mlp(cfg, torch.Generator().manual_seed(0),
            device="cpu")
    assert torch.equal(again["layers"][0]["w"], params["layers"][0]["w"])


@pytest.mark.parametrize("preset", ["digit_constrained",
                                    "speaker_unconstrained"])
def test_params_round_trip(preset):
    _, jp, js = _jax_tree(preset, seed=8)
    params, state = params_from_numpy(jp, js, device="cpu")
    back_p, back_s = params_to_numpy(params, state)
    for a, b in zip(jax.tree_util.tree_leaves((back_p, back_s)),
                    jax.tree_util.tree_leaves((jp, js))):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
