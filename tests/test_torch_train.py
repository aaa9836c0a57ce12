"""The port's training path (asr_using_robust_nn_tpu_torch/train, attacks)
against the JAX package: Adam, the update order, the device-resident epoch
and evaluator, `Trainer.fit` in both modes, and FGSM. Parameters, Adam state
and the constraint's u cross with `models/convert.py`; data are seeded numpy
arrays given to both.

Tolerances: fp32 programs whose sums run in different orders; over a few
Adam steps that is O(1e-7) per step (1e-6 on Adam, 1e-4 on params after two
constrained steps, 1e-4 on loss histories after 3 epochs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from asr_using_robust_nn_tpu.attacks.whitebox import fgsm as jfgsm
from asr_using_robust_nn_tpu.constraints import (
    make_simple_norm_constraint as jmake)
from asr_using_robust_nn_tpu.models import mlp as jmlp
from asr_using_robust_nn_tpu.train import epoch_scan as jes
from asr_using_robust_nn_tpu.train import trainer as jtr
from asr_using_robust_nn_tpu_torch.attacks import fgsm
from asr_using_robust_nn_tpu_torch.constraints import (
    make_simple_norm_constraint)
from asr_using_robust_nn_tpu_torch.models import mlp
from asr_using_robust_nn_tpu_torch.models.convert import (
    adam_state_from_numpy, adam_state_to_numpy, cstate_from_numpy,
    params_from_numpy, params_to_numpy)
from asr_using_robust_nn_tpu_torch.train import epoch_scan as es
from asr_using_robust_nn_tpu_torch.train import trainer as tr

from conftest import blobs_task

KW = dict(in_dim=20, n_classes=4, hidden=(32, 16), nonneg=True,
          dropout=(0.0, 0.0))


def _jax_init(seed=0, **kw):
    jcfg = jmlp.MLPConfig(**dict(KW, **kw))
    p, s = jax.tree_util.tree_map(
        np.asarray, jmlp.init_mlp(jcfg, jax.random.PRNGKey(seed)))
    return jcfg, mlp.MLPConfig(**dict(KW, **kw)), p, s


def _leaves_close(a_tree, b_tree, **tol):
    a = jax.tree_util.tree_leaves(a_tree)
    b = jax.tree_util.tree_leaves(b_tree)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x, np.float32),
                                   np.asarray(y, np.float32), **tol)


def _grads(rng, p):
    return jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32) * 0.1, p)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adam_matches_optax(moments):
    """5 steps of seeded gradients: updates, moments and count agree with
    `adam_optimizer` (optax.adam, or `_scale_by_adam_stored` for bf16
    moments)."""
    rng = np.random.default_rng(0)
    _, _, p, _ = _jax_init()
    jopt = jtr.adam_optimizer(1e-3, moments)
    opt = tr.adam_optimizer(1e-3, moments)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    js = jopt.init(jp)
    params, _ = params_from_numpy(p, {"layers": []}, device="cpu")
    st = opt.init(params)
    for _ in range(5):
        g = _grads(rng, p)
        ju, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        u, st = opt.update(params_from_numpy(g, {"layers": []},
                device="cpu")[0], st)
        params = tr._tree_map(lambda a, b: a + b, params, u)
        _leaves_close(params_to_numpy(u, {"layers": []})[0], ju, atol=1e-6,
                      rtol=0)
    _leaves_close(params_to_numpy(params, {"layers": []})[0], jp, atol=1e-6,
                  rtol=0)
    count, mu, nu = adam_state_to_numpy(st)
    assert int(count) == int(js[0].count) == 5
    assert st["mu"]["layers"][0]["w"].dtype == getattr(torch, moments)
    _leaves_close(mu, js[0].mu, atol=1e-6, rtol=0)
    _leaves_close(nu, js[0].nu, atol=1e-6, rtol=0)


def test_adam_state_round_trip():
    rng = np.random.default_rng(1)
    _, _, p, _ = _jax_init()
    mu, nu = _grads(rng, p), _grads(rng, p)
    st = adam_state_from_numpy(np.int32(9), mu, nu, device="cpu")
    count, mu2, nu2 = adam_state_to_numpy(st)
    assert int(count) == 9 and st["count"].dtype == torch.int32
    _leaves_close(mu2, mu, atol=0, rtol=0)
    _leaves_close(nu2, nu, atol=0, rtol=0)


def test_apply_update_order_matches_jax():
    """Adam, then NonNeg, then the projection: same grads and state in, same
    params, Adam state and u out. An update that drives weights negative
    shows the clamp comes before the projection (the projection's sigma is
    of the clamped kernels)."""
    rng = np.random.default_rng(2)
    jcfg, cfg, p, _ = _jax_init(seed=2)
    g = jax.tree_util.tree_map(
        lambda a: np.sign(rng.standard_normal(a.shape)).astype(np.float32), p)
    jcon = jmake(0.5, n_iter=8)
    jopt = jtr.adam_optimizer(0.05)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    jcs = jcon.init(jp)
    jp2, jo2, jcs2 = jtr.apply_update(
        jopt, jcfg, jcon.apply, jax.tree_util.tree_map(jnp.asarray, g), jp,
        jopt.init(jp), jcs)
    con = make_simple_norm_constraint(0.5, n_iter=8)
    opt = tr.adam_optimizer(0.05)
    params, _ = params_from_numpy(p, {"layers": []}, device="cpu")
    p2, o2, cs2 = tr.apply_update(
        opt, cfg, con.apply, params_from_numpy(g, {"layers": []},
                device="cpu")[0], params,
        opt.init(params), cstate_from_numpy(
            jax.tree_util.tree_map(np.asarray, jcs), device="cpu"))
    _leaves_close(params_to_numpy(p2, {"layers": []})[0], jp2, atol=2e-6,
                  rtol=1e-5)
    assert all(bool((layer["w"] >= 0).all()) for layer in p2["layers"])
    np.testing.assert_allclose(cs2["u"].numpy(), np.asarray(jcs2["u"]),
                               atol=1e-5)
    assert int(o2["count"]) == int(jo2[0].count) == 1


def _padded_split(rng, n=150, batch=64):
    from asr_using_robust_nn_tpu_torch.parallel.mesh import pad_to_multiple

    x, y = blobs_task(rng, n=n, d=20, k=4)
    d, n_true = pad_to_multiple(x, batch)
    lab, _ = pad_to_multiple(y.astype(np.int32), batch)
    return d, lab, n_true


def test_epoch_program_matches_jax():
    """One unshuffled dropout-0 epoch of 3 steps (the last ragged) with the
    projection: params within 1e-4, loss within 1e-5."""
    rng = np.random.default_rng(3)
    d, lab, n_true = _padded_split(rng)
    jcfg, cfg, p, s = _jax_init(seed=3)
    jcon = jmake(0.5, n_iter=8)
    jopt = jtr.adam_optimizer(1e-3)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    jcs = jcon.init(jp)
    cs = cstate_from_numpy(jax.tree_util.tree_map(np.asarray, jcs),
            device="cpu")
    jep = jes.build_epoch_fn(jcfg, jopt, jcon.apply, batch_size=64,
                             shuffle=False)
    jout = jep(jp, jax.tree_util.tree_map(jnp.asarray, s), jopt.init(jp),
               jcs, jnp.asarray(d), jnp.asarray(lab), jax.random.PRNGKey(0),
               jax.random.PRNGKey(1), n_true=n_true)
    con = make_simple_norm_constraint(0.5, n_iter=8)
    opt = tr.adam_optimizer(1e-3)
    params, state = params_from_numpy(p, s, device="cpu")
    ep = es.build_epoch_fn(cfg, opt, con.apply, batch_size=64, shuffle=False)
    out = ep(params, state, opt.init(params), cs, torch.from_numpy(d),
             torch.from_numpy(lab).long(), None, None, n_true)
    got_p, got_s = params_to_numpy(out[0], out[1])
    _leaves_close(got_p, jout[0], atol=1e-4, rtol=0)
    _leaves_close(got_s, jout[1], atol=1e-4, rtol=0)
    assert abs(float(out[4]) - float(jout[4])) < 1e-5
    assert abs(float(out[5]) - float(jout[5])) < 1e-6
    assert int(out[2]["count"]) == 3


def test_eval_program_matches_jax():
    rng = np.random.default_rng(4)
    d, lab, n_true = _padded_split(rng, n=100, batch=32)
    jcfg, cfg, p, s = _jax_init(seed=4)
    jl, ja = jes.build_eval_fn(jcfg, batch_size=32)(
        jax.tree_util.tree_map(jnp.asarray, p),
        jax.tree_util.tree_map(jnp.asarray, s), jnp.asarray(d),
        jnp.asarray(lab), n_true=n_true)
    params, state = params_from_numpy(p, s, device="cpu")
    loss, acc = es.build_eval_fn(cfg, batch_size=32)(
        params, state, torch.from_numpy(d), torch.from_numpy(lab).long(),
        n_true)
    assert abs(float(loss) - float(jl)) < 1e-6
    assert abs(float(acc) - float(ja)) < 1e-6


def _fit_both(resident, epochs=3):
    rng = np.random.default_rng(5)
    x, y = blobs_task(rng, n=200, d=20, k=4)
    vx, vy = x[:64], y[:64]
    jcfg, cfg, p, s = _jax_init(seed=5)
    jcon = jmake(0.5, n_iter=8)
    jcs = jcon.init(jax.tree_util.tree_map(jnp.asarray, p))
    tkw = dict(batch_size=64, epochs=epochs, patience=epochs,
               device_resident=resident, shuffle=not resident)
    jt = jtr.Trainer(jcfg, jtr.TrainConfig(epoch_backend="xla", **tkw),
                     constraint=jcon.apply, constraint_state=jcs)
    jres = jt.fit(x, y, vx, vy, params=p, state=s)
    con = make_simple_norm_constraint(0.5, n_iter=8)
    t = tr.Trainer(cfg, tr.TrainConfig(epoch_backend="plain", **tkw),
                   constraint=con.apply, constraint_state=cstate_from_numpy(
                       jax.tree_util.tree_map(np.asarray, jcs), device="cpu"),
                               device="cpu")
    params, state = params_from_numpy(p, s, device="cpu")
    return jres, t.fit(x, y, vx, vy, params=params, state=state)


@pytest.mark.parametrize("resident", [False, True])
def test_fit_matches_jax(resident):
    """3 epochs of Trainer.fit, streaming (numpy-shuffled batches, the same
    permutation in both) and device-resident (unshuffled): the loss and
    val histories agree within 1e-4 and the trained params closely."""
    jres, res = _fit_both(resident)
    for k in ("loss", "acc", "val_loss", "val_acc"):
        np.testing.assert_allclose(res["history"][k], jres["history"][k],
                                   atol=1e-4, rtol=0)
    assert res["steps"] == jres["steps"] == 12
    assert res["epochs_run"] == 3
    _leaves_close(params_to_numpy(res["params"], res["state"])[0],
                  jres["params"], atol=2e-4, rtol=0)
    assert int(res["opt_state"]["count"]) == 12
    np.testing.assert_allclose(res["constraint_state"]["u"].numpy(),
                               np.asarray(jres["constraint_state"]["u"]),
                               atol=1e-4)
    assert res["best_val_loss"] == pytest.approx(jres["best_val_loss"],
                                                 abs=1e-4)


def test_fit_early_stopping_and_io_options(tmp_path, monkeypatch):
    rng = np.random.default_rng(6)
    x, y = blobs_task(rng, n=128, d=20, k=4)
    cfg = mlp.MLPConfig(**dict(KW, batch_norm=False))
    t = tr.Trainer(cfg, tr.TrainConfig(batch_size=64, epochs=50, patience=2,
                                       learning_rate=0.0), device="cpu")
    res = t.fit(x, y, x[:32], y[:32])
    assert res["epochs_run"] == 3  # val_loss never improves after epoch 1
    assert len(res["history"]["val_loss"]) == 3
    assert res["epoch_backend"] == "streaming"
    assert res["checkpoint_writes"] == 0
    # checkpoint and metrics I/O: one save (the only improvement), one
    # JSONL row per scalar and epoch (TensorBoard left out here)
    import json
    import sys

    from asr_using_robust_nn_tpu_torch.train.checkpoints import (
        CheckpointManager)

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    res_io = t.fit(x, y, x[:32], y[:32], checkpoint_dir=tmp_path / "ck",
                   metrics_dir=tmp_path / "m")
    assert res_io["checkpoint_writes"] == 1
    tree, meta = CheckpointManager(tmp_path / "ck").load_best()
    assert meta == {"epoch": 0, "val_loss": res_io["history"]["val_loss"][0]}
    for a, b in zip(tree["params"]["layers"],
                    res_io["best_params"]["layers"]):
        assert all(np.array_equal(a[k], b[k].numpy()) for k in a)
    rows = [json.loads(r) for r in
            (tmp_path / "m" / "metrics.jsonl").read_text().splitlines()]
    assert len(rows) == 4 * 3 and rows[2]["tag"] == "val_loss"
    with pytest.raises(ValueError, match="validation"):
        t.fit(x, y, x[:0], y[:0])
    probs = t.predict(res["best_params"], res["best_state"], x[:10])
    assert probs.shape == (10, 4)
    np.testing.assert_allclose(probs.sum(1), 1.0, rtol=1e-6)


def test_fgsm_matches_jax():
    rng = np.random.default_rng(7)
    jcfg, cfg, p, s = _jax_init(seed=7, nonneg=False)
    x, y = blobs_task(rng, n=32, d=20, k=4)
    x[0] = 0.0  # rows whose gradient has exact zeros after ReLU
    jx = jfgsm(lambda xx: jmlp.apply_mlp(jcfg, p, s, xx)[0], jnp.asarray(x),
               jnp.asarray(y), 0.1)
    params, state = params_from_numpy(p, s, device="cpu")
    got = fgsm(lambda xx: mlp.apply_mlp(cfg, params, state, xx)[0],
               torch.from_numpy(x), torch.from_numpy(y).long(), 0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(jx), atol=1e-6)
    assert np.array_equal(got.numpy() == x, np.asarray(jx) == x)
