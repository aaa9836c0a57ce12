"""The port's multi-run trainer (asr_using_robust_nn_tpu_torch/train/
multi_run.py): per-run equivalence with the solo trainers, exact freezing,
rho sweeps, early stopping per run, both epoch backends, and one epoch
against the JAX package's multi-run program.

The port's plain backend runs the runs as one batched program (a `torch.bmm`
a Dense) with the solo generator derivation, its fused backend loops over
the solo programs, so run r equals a solo run of seed r bit for bit on the
CPU with one torch thread (tolerance 0). Against JAX (same stacked initial parameters, shuffle off,
dropout 0, one epoch of 5 steps): two fp32 programs whose sums run in
different orders, 2e-4 on the parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_using_robust_nn_tpu.constraints.engine import (
    make_simple_norm_constraint as jmake)
from asr_using_robust_nn_tpu.models import mlp as jmlp
from asr_using_robust_nn_tpu.train import multi_run as jmr
from asr_using_robust_nn_tpu.train.trainer import adam_optimizer as jadam
from asr_using_robust_nn_tpu_torch.constraints import (
    make_simple_norm_constraint)
from asr_using_robust_nn_tpu_torch.models.convert import (
    adam_state_from_numpy, adam_state_to_numpy, cstate_from_numpy,
    fstate_from_numpy, fstate_to_numpy, params_from_numpy, params_to_numpy)
from asr_using_robust_nn_tpu_torch.models.mlp import (
    MLPConfig, dense_kernels, init_mlp)
from asr_using_robust_nn_tpu_torch.ops import cuda_train as ct
from asr_using_robust_nn_tpu_torch.parallel.mesh import (data_mesh,
                                                         pad_to_multiple)
from asr_using_robust_nn_tpu_torch.train.epoch_scan import build_epoch_fn
from asr_using_robust_nn_tpu_torch.train.multi_run import (
    build_multi_run_epoch_fn, build_multi_run_eval_fn,
    build_multi_run_fused_epoch_fn, fit_multi_run, fold_runs,
    init_multi_run_fused_state, init_multi_run_state)
from asr_using_robust_nn_tpu_torch.train.trainer import (
    TrainConfig, Trainer, _generator, _tree_leaves, _tree_map,
    adam_optimizer)

from conftest import blobs_task, product_norm_oracle

KW = dict(in_dim=24, n_classes=4, hidden=(16, 8), dropout=(0.1, 0.0),
          nonneg=True)
CFG = MLPConfig(**KW)
BS = 64
OPT = adam_optimizer(1e-3)
CON = make_simple_norm_constraint(rho=1.0)
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the bit-for-bit bars below hold a `torch.bmm` slice
    of the batched plain epoch to the `torch.mm` of a solo epoch, which is
    the same product summed in the same order only on one thread (several
    threads may split a large product differently); it also keeps the file
    near its solo time under the suite's worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy_data(n, n_val, in_dim=24, n_classes=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, in_dim)).astype(np.float32)
    y = rng.integers(0, n_classes, n).astype(np.int64)
    x[np.arange(n), y] += 2.0  # learnable signal
    xv = rng.standard_normal((n_val, in_dim)).astype(np.float32)
    yv = rng.integers(0, n_classes, n_val).astype(np.int64)
    xv[np.arange(n_val), yv] += 2.0
    return x, y, xv, yv


def _padded(x, y):
    d, n_true = pad_to_multiple(x, BS)
    lab, _ = pad_to_multiple(y, BS)
    return torch.from_numpy(d), torch.from_numpy(lab), n_true


def _run(tree, r):
    return _tree_map(lambda t: t[r], tree)


def _assert_trees_equal(a, b):
    """Bit-equal leaves, matched by key (dict orders may differ)."""
    assert len(_tree_leaves(a)) == len(_tree_leaves(b))

    def same(x, y):
        assert x.shape == y.shape and torch.equal(x, y)

    _tree_map(same, a, b)


def test_per_run_matches_single_run_epoch():
    """Each run of the multi-run epoch == the solo epoch program for that
    seed (same constraint, dropout, shuffle), bit for bit."""
    x, y, _, _ = _toy_data(300, 8)
    d, lab, n_true = _padded(x, y)
    seeds = [3, 7, 11]
    params, state, opt_state, cstate, kp, kd = init_multi_run_state(
        CFG, OPT, seeds, CON.init, device="cpu")
    mfn = build_multi_run_epoch_fn(CFG, OPT, CON.apply, batch_size=BS,
                                   epochs_per_call=2)
    p2, s2, o2, c2, ml, ma = mfn(
        params, state, opt_state, cstate, d, lab, fold_runs(kp, 0, CPU),
        fold_runs(kd, 0, CPU), np.ones(3, bool), None, n_true)
    sfn = build_epoch_fn(CFG, OPT, CON.apply, batch_size=BS,
                         epochs_per_call=2)
    for r, seed in enumerate(seeds):
        p1, s1 = init_mlp(CFG, _generator(CPU, seed, 0), device="cpu")
        p1b, s1b, o1b, c1b, l1, a1 = sfn(
            p1, s1, OPT.init(p1), CON.init(p1), d, lab,
            _generator(CPU, seed, 1, 0), _generator(CPU, seed, 2, 0), n_true)
        _assert_trees_equal((p1b, s1b, o1b, c1b), _run((p2, s2, o2, c2), r))
        assert float(l1) == float(ml[r]) and float(a1) == float(ma[r])
    # the stacked inputs were not modified
    assert int(opt_state["count"].sum()) == 0


def test_rho_sweep_matches_fixed_rho_runs():
    """constraint_factory + per-run rhos == separate fixed-rho constraints,
    and runs at different rho diverge."""
    x, y, _, _ = _toy_data(300, 8)
    d, lab, n_true = _padded(x, y)
    rhos = [0.5, 1.0, 2.0]
    st = init_multi_run_state(CFG, OPT, [5, 5, 5], CON.init, device="cpu")
    gens = lambda: (fold_runs(st[4], 0, CPU),  # noqa: E731
                    fold_runs(st[5], 0, CPU))
    mfn = build_multi_run_epoch_fn(
        CFG, OPT, constraint_factory=make_simple_norm_constraint,
        batch_size=BS, epochs_per_call=2)
    p2, *_ = mfn(*st[:4], d, lab, *gens(), np.ones(3, bool),
                 np.asarray(rhos, np.float32), n_true)
    fixed = build_multi_run_epoch_fn(CFG, OPT, CON.apply, batch_size=BS,
                                     epochs_per_call=2)
    pf, *_ = fixed(*st[:4], d, lab, *gens(), np.ones(3, bool), None, n_true)
    _assert_trees_equal(_run(p2, 1), _run(pf, 1))
    w = p2["layers"][0]["w"]
    assert not torch.allclose(w[0], w[1]) and not torch.allclose(w[1], w[2])
    # each run's product norm lands at its own rho
    for r, rho in enumerate(rhos):
        sigma = product_norm_oracle(
            [k[r].numpy() for k in dense_kernels(p2)])
        assert abs(sigma / rho - 1.0) < 0.05, (r, sigma)


@pytest.mark.parametrize("backend", ["plain", "fused"])
def test_inactive_run_fully_frozen(backend):
    """active=False runs keep every leaf bit-identical; active runs train."""
    x, y, _, _ = _toy_data(300, 8)
    d, lab, n_true = _padded(x, y)
    act = np.array([True, False, True])
    if backend == "plain":
        *old, kp, kd = init_multi_run_state(CFG, OPT, [3, 7, 11], CON.init,
                                            device="cpu")
        mfn = build_multi_run_epoch_fn(CFG, OPT, CON.apply, batch_size=BS)
        *new, ml, _ = mfn(*old, d, lab, fold_runs(kp, 0, CPU),
                          fold_runs(kd, 0, CPU), act, None, n_true)
        old, new = tuple(old), tuple(new)
        moved = (new[0]["layers"][0]["w"], old[0]["layers"][0]["w"])
    else:
        spec = ct.FusedStepSpec(cfg=CFG, batch=BS, rho=1.0, pi_iters=8)
        old, kp, kd = init_multi_run_fused_state(spec, [3, 7, 11],
                                                 device="cpu")
        mfn = build_multi_run_fused_epoch_fn(spec)
        new, ml, _ = mfn(old, ct.pad_features(spec, d), lab,
                         fold_runs(kp, 0, CPU), fold_runs(kd, 0, CPU), act,
                         n_true)
        moved = (new["masters"][0], old["masters"][0])
    _assert_trees_equal(_run(old, 1), _run(new, 1))
    assert not torch.equal(moved[0][0], moved[1][0])
    assert not torch.equal(moved[0][2], moved[1][2])
    assert bool(torch.isnan(ml[1])) and bool(torch.isfinite(ml[[0, 2]]).all())


def test_each_run_matches_solo_fused_epoch():
    """The fused multi-run epoch == the solo fused epoch per seed."""
    rng = np.random.default_rng(0)
    x, y = blobs_task(rng, n=128, d=24, k=4)
    spec = ct.FusedStepSpec(cfg=CFG, batch=BS, rho=0.5, pi_iters=8)
    data = ct.pad_features(spec, torch.from_numpy(x))
    lab = torch.from_numpy(y.astype(np.int64))
    seeds = [3, 9]
    fstates, kp, kd = init_multi_run_fused_state(spec, seeds, device="cpu")
    mr = build_multi_run_fused_epoch_fn(spec, epochs_per_call=2)
    fs2, losses, accs = mr(fstates, data, lab, fold_runs(kp, 0, CPU),
                           fold_runs(kd, 0, CPU), None, 128)
    ep = ct.build_fused_epoch_fn(spec, epochs_per_call=2)
    for r, s in enumerate(seeds):
        p, st = init_mlp(CFG, _generator(CPU, s, 0), device="cpu")
        solo, loss_s, acc_s = ep(ct.pack_state(spec, p, st), data, lab,
                                 _generator(CPU, s, 1, 0),
                                 _generator(CPU, s, 2, 0), 128)
        assert float(losses[r]) == float(loss_s)
        assert float(accs[r]) == float(acc_s)
        _assert_trees_equal(_run(fs2, r), solo)


def _solo_fit(tcfg, seed, con, x, y, xv, yv):
    import dataclasses

    p0, _ = init_mlp(CFG, torch.Generator().manual_seed(0), device="cpu")
    tr = Trainer(CFG, dataclasses.replace(tcfg, seed=seed),
                 constraint=con.apply, constraint_state=con.init(p0),
                 device="cpu")
    return tr.fit(x, y, xv, yv)


@pytest.mark.parametrize("backend", ["plain", "fused"])
def test_fit_multi_run_matches_trainer_fit_per_seed(backend):
    """fit_multi_run == a loop of Trainer.fit(device_resident=True) per
    seed on the same epoch backend: histories, epochs run, best snapshot and
    final Adam state, bit for bit."""
    x, y, xv, yv = _toy_data(300, 80)
    con = make_simple_norm_constraint(rho=1.0, n_iter=8)
    seeds = [3, 7]
    tcfg = TrainConfig(batch_size=BS, epochs=8, patience=6,
                       device_resident=True, epochs_per_dispatch=2,
                       epoch_backend=backend)
    res = fit_multi_run(CFG, tcfg, x, y, xv, yv, seeds, constraint=con.apply,
                        constraint_init=con.init, epoch_backend=backend,
                        device="cpu")
    assert res["best_params"]["layers"][0]["w"].shape[0] == 2
    assert res["history"]["val_loss"].shape == (4, 2)
    for r, seed in enumerate(seeds):
        out = _solo_fit(tcfg, seed, con, x, y, xv, yv)
        assert res["best_val_loss"][r] == out["best_val_loss"]
        assert res["epochs_run"][r] == out["epochs_run"]
        for k in ("loss", "acc", "val_loss", "val_acc"):
            np.testing.assert_array_equal(
                res["history"][k][:, r].astype(np.float64),
                np.asarray(out["history"][k]))
        for k in ("best_params", "best_state", "params", "opt_state",
                  "constraint_state"):
            _assert_trees_equal(_run(res[k], r), out[k])
    # the retained optimizer state has the optimizer's structure (resume)
    one = _tree_map(lambda t: t[0], res["best_opt_state"])
    want = OPT.init(_tree_map(lambda t: t[0], res["best_params"]))
    assert [t.shape for t in _tree_leaves(one)] == [
        t.shape for t in _tree_leaves(want)]


def test_early_stopping_per_run():
    """Runs stop at different chunks; a frozen run's val rows repeat its
    frozen value exactly and its best snapshot dates from before the
    freeze."""
    x, y, xv, yv = _toy_data(300, 80)
    # random val labels: val_loss worsens as the train set is fit
    yv = np.random.default_rng(1).permutation(yv)
    tcfg = TrainConfig(batch_size=BS, epochs=30, patience=2,
                       device_resident=True, epochs_per_dispatch=1)
    res = fit_multi_run(CFG, tcfg, x, y, xv, yv, [3, 7, 11],
                        constraint=CON.apply, constraint_init=CON.init,
                        device="cpu")
    er = res["epochs_run"]
    assert (er < 30).all(), er  # patience fired for every run
    vh = res["history"]["val_loss"]
    for r in range(3):
        stop = int(er[r])  # epochs_per_dispatch=1 -> chunk index
        frozen = vh[stop:, r]
        if len(frozen) > 1:
            assert np.all(frozen == frozen[0])
            assert np.isnan(res["history"]["loss"][stop:, r]).all()
        np.testing.assert_allclose(res["best_val_loss"][r],
                                   vh[:stop, r].min(), rtol=1e-6)
        assert res["best_epoch"][r] == 1 + int(np.argmin(vh[:stop, r]))


def test_rho_grid_fit():
    """A seeds x rhos paired grid trains in one call and the stronger
    constraint yields the smaller product norm."""
    x, y, xv, yv = _toy_data(300, 80)
    tcfg = TrainConfig(batch_size=BS, epochs=8, patience=8,
                       device_resident=True, epochs_per_dispatch=4)
    res = fit_multi_run(CFG, tcfg, x, y, xv, yv, [3, 3], rhos=[0.1, 10.0],
                        constraint_factory=make_simple_norm_constraint,
                        device="cpu")
    norms = [product_norm_oracle([k[r].numpy()
                                  for k in dense_kernels(res["params"])])
             for r in range(2)]
    assert abs(norms[0] / 0.1 - 1.0) < 0.05 and norms[0] < norms[1], norms


def test_validation_errors():
    x, y, xv, yv = _toy_data(64, 8)
    tcfg = TrainConfig(batch_size=BS, epochs=2, device_resident=True)
    kw = dict(device="cpu")
    with pytest.raises(ValueError, match="non-empty validation"):
        fit_multi_run(CFG, tcfg, x, y, x[:0], y[:0], [0, 1], **kw)
    with pytest.raises(ValueError, match="go together"):
        fit_multi_run(CFG, tcfg, x, y, xv, yv, [0, 1],
                      constraint_factory=make_simple_norm_constraint, **kw)
    with pytest.raises(ValueError, match="either constraint or"):
        fit_multi_run(CFG, tcfg, x, y, xv, yv, [0, 1], constraint=CON.apply,
                      constraint_factory=make_simple_norm_constraint,
                      rhos=[1.0, 2.0], **kw)
    with pytest.raises(ValueError, match="one entry per run"):
        fit_multi_run(CFG, tcfg, x, y, xv, yv, [0, 1],
                      constraint_factory=make_simple_norm_constraint,
                      rhos=[1.0], **kw)
    with pytest.raises(ValueError, match="epoch_backend"):
        fit_multi_run(CFG, tcfg, x, y, xv, yv, [0, 1], epoch_backend="xla",
                      **kw)
    with pytest.raises(ValueError, match="epochs_per_dispatch"):
        fit_multi_run(CFG, TrainConfig(batch_size=BS, epochs_per_dispatch=0),
                      x, y, xv, yv, [0, 1], **kw)
    with pytest.raises(ValueError, match="single-device"):
        fit_multi_run(CFG, tcfg, x, y, xv, yv, [0, 1], mesh=data_mesh(),
                      epoch_backend="fused", **kw)


def test_fused_backend_refuses_unsupported():
    x, y, xv, yv = _toy_data(64, 8)
    tcfg = TrainConfig(batch_size=BS, epochs=2, patience=2)
    part = make_simple_norm_constraint(0.5, affected_layers_indices=(0,))
    with pytest.raises(ValueError, match="fused"):
        fit_multi_run(CFG, tcfg, x, y, xv, yv, [0, 1], constraint=part.apply,
                      constraint_init=part.init, epoch_backend="fused",
                      device="cpu")
    with pytest.raises(ValueError, match="fused"):
        fit_multi_run(CFG, tcfg, x, y, xv, yv, [0, 1], rhos=[0.5, 1.0],
                      constraint_factory=make_simple_norm_constraint,
                      epoch_backend="fused", device="cpu")


def test_multi_run_eval_matches_solo():
    x, y, xv, yv = _toy_data(64, 40)
    params, state, *_ = init_multi_run_state(CFG, OPT, [1, 2], device="cpu")
    d, _ = pad_to_multiple(xv, 8)
    lab, _ = pad_to_multiple(yv, 8)
    vl, va = build_multi_run_eval_fn(CFG, batch_size=8)(
        params, state, torch.from_numpy(d), torch.from_numpy(lab), 40)
    assert vl.shape == (2,) and va.shape == (2,)
    from asr_using_robust_nn_tpu_torch.train.epoch_scan import build_eval_fn

    for r in range(2):
        l1, a1 = build_eval_fn(CFG, batch_size=8)(
            _tree_map(lambda t: t[r], params),
            _tree_map(lambda t: t[r], state), torch.from_numpy(d),
            torch.from_numpy(lab), 40)
        assert float(l1) == float(vl[r]) and float(a1) == float(va[r])


# -- against the JAX package ----------------------------------------------------

def test_multi_run_epoch_matches_jax():
    """The same stacked initial parameters (numpy), shuffle off, dropout 0,
    one epoch through both packages' `build_multi_run_epoch_fn`."""
    kw = dict(KW, dropout=(0.0, 0.0))
    jcfg, cfg = jmlp.MLPConfig(**kw), MLPConfig(**kw)
    x, y, _, _ = _toy_data(300, 8)
    d, n_true = pad_to_multiple(x, BS)
    lab, _ = pad_to_multiple(y, BS)
    jcon, jopt = jmake(rho=1.0), jadam(1e-3)
    jst = jmr.init_multi_run_state(jcfg, jopt, [3, 7, 11], jcon.init)
    jp, js, jo, jc, jkp, jkd = jst
    p_np, s_np = jax.tree_util.tree_map(np.asarray, (jp, js))
    u_np = {"u": np.asarray(jc["u"])}
    jfn = jmr.build_multi_run_epoch_fn(jcfg, jopt, jcon.apply, batch_size=BS,
                                       shuffle=False)
    jp2, js2, jo2, jc2, jl, ja = jfn(jp, js, jo, jc, jnp.asarray(d),
                                     jnp.asarray(lab, jnp.int32), jkp, jkd,
                                     jnp.ones((3,), bool), None, n_true)

    params, state = params_from_numpy(p_np, s_np, device="cpu")
    zeros = jax.tree_util.tree_map(np.zeros_like, p_np)
    opt_state = adam_state_from_numpy(np.zeros(3, np.int32), zeros, zeros,
                                      device="cpu")
    cstate = cstate_from_numpy(u_np, device="cpu")
    fn = build_multi_run_epoch_fn(cfg, OPT, CON.apply, batch_size=BS,
                                  shuffle=False)
    p2, s2, o2, c2, ml, ma = fn(params, state, opt_state, cstate,
                                torch.from_numpy(d), torch.from_numpy(lab),
                                [None] * 3, None, None, None, n_true)
    got_p, got_s = params_to_numpy(p2, s2)
    for a, b in zip(jax.tree_util.tree_leaves(got_p),
                    jax.tree_util.tree_leaves(jp2)):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-4, rtol=0)
    for a, b in zip(jax.tree_util.tree_leaves(got_s),
                    jax.tree_util.tree_leaves(js2)):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-4, rtol=0)
    np.testing.assert_allclose(ml.numpy(), np.asarray(jl), atol=2e-4)
    np.testing.assert_allclose(ma.numpy(), np.asarray(ja), atol=1e-6)
    count, mu, _ = adam_state_to_numpy(o2)
    np.testing.assert_array_equal(count, np.asarray(jo2[0].count))
    for a, b in zip(jax.tree_util.tree_leaves(mu),
                    jax.tree_util.tree_leaves(jo2[0].mu)):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-4, rtol=0)
    np.testing.assert_allclose(c2["u"].numpy(), np.asarray(jc2["u"]),
                               atol=2e-4)


def test_frozen_run_rows_vs_jax(monkeypatch):
    """`fit_multi_run` through both packages on the CPU: the same stacked
    initial parameters and power-iteration vectors (numpy, from the JAX
    init), the same numpy-seeded data, shuffle off, dropout 0, and a patience
    that freezes the runs at different chunks. Parameters, BN state, the
    validation rows, `best_*` and `epochs_run` agree (two fp32 programs
    whose sums run in different orders, over up to 8 epochs of 5 steps:
    5e-4), and so do the train rows of every run up to its `epochs_run`.

    Past `epochs_run[r]` the train rows differ by design, asserted by name:
    the JAX program trains every run in every chunk and masks the frozen
    ones afterwards, so those rows show the discarded chunk's finite
    values; the port does not train a run whose result it would discard
    (a frozen run costs no GPU time), so those rows read NaN."""
    from asr_using_robust_nn_tpu.train.trainer import (
        TrainConfig as JTrainConfig)
    from asr_using_robust_nn_tpu_torch.train import multi_run as mr

    kw = dict(KW, dropout=(0.0, 0.0))
    jcfg, cfg = jmlp.MLPConfig(**kw), MLPConfig(**kw)
    x, y, xv, yv = _toy_data(300, 80)
    yv = np.random.default_rng(1).permutation(yv)  # val_loss worsens
    seeds = [3, 7, 11]
    tkw = dict(batch_size=BS, epochs=8, patience=1, device_resident=True,
               epochs_per_dispatch=1, shuffle=False)
    jcon, jopt = jmake(rho=1.0), jadam(1e-3)
    jinit = jmr.init_multi_run_state(jcfg, jopt, seeds, jcon.init)
    p_np, s_np = jax.tree_util.tree_map(np.asarray, (jinit[0], jinit[1]))
    u_np = {"u": np.asarray(jinit[3]["u"])}
    jres = jmr.fit_multi_run(jcfg, JTrainConfig(**tkw), x, y, xv, yv, seeds,
                             constraint=jcon.apply, constraint_init=jcon.init)

    def init_from_jax(model_cfg, optimizer, run_seeds, constraint_init=None,
                      mesh=None, device=None):
        port = init_multi_run_state(model_cfg, optimizer, run_seeds,
                                    constraint_init, device=device)
        params, state = params_from_numpy(p_np, s_np, device="cpu")
        zeros = jax.tree_util.tree_map(np.zeros_like, p_np)
        opt_state = adam_state_from_numpy(np.zeros(3, np.int32), zeros, zeros,
                                          device="cpu")
        return (params, state, opt_state,
                cstate_from_numpy(u_np, device="cpu"), port[4], port[5])

    monkeypatch.setattr(mr, "init_multi_run_state", init_from_jax)
    res = fit_multi_run(cfg, TrainConfig(**tkw), x, y, xv, yv, seeds,
                        constraint=CON.apply, constraint_init=CON.init,
                        device="cpu")

    er = res["epochs_run"]
    np.testing.assert_array_equal(er, jres["epochs_run"])
    np.testing.assert_array_equal(res["best_epoch"], jres["best_epoch"])
    n_chunks = res["history"]["loss"].shape[0]
    assert jres["history"]["loss"].shape[0] == n_chunks
    assert len(set(er.tolist())) > 1 and er.min() < n_chunks, er
    tol = dict(atol=5e-4, rtol=0)
    np.testing.assert_allclose(res["best_val_loss"], jres["best_val_loss"],
                               **tol)
    for key in ("val_loss", "val_acc"):
        np.testing.assert_allclose(res["history"][key], jres["history"][key],
                                   **tol)
    for got, want in ((params_to_numpy(res["params"], res["state"]),
                       (jres["params"], jres["state"])),
                      (params_to_numpy(res["best_params"], res["best_state"]),
                       (jres["best_params"], jres["best_state"]))):
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a, np.asarray(b), **tol)
    frozen_rows = 0
    for r in range(len(seeds)):
        stop = int(er[r])  # epochs_per_dispatch=1 -> chunk index
        for key in ("loss", "acc"):
            got, want = res["history"][key][:, r], jres["history"][key][:, r]
            np.testing.assert_allclose(got[:stop], want[:stop], **tol)
            port_rows_past_freeze_are_nan = np.isnan(got[stop:]).all()
            jax_rows_past_freeze_are_finite = np.isfinite(want[stop:]).all()
            assert port_rows_past_freeze_are_nan, (r, key, got)
            assert jax_rows_past_freeze_are_finite, (r, key, want)
        frozen_rows += n_chunks - stop
    assert frozen_rows > 0  # at least one run sat frozen through a chunk


# -- models/convert.py: K6 and stacked states cross unchanged -------------------

def _k6_state_np():
    """A JAX K6 state after two constrained steps (interpret mode): scales
    != 1 and bf16 copies that are not a cast of the masters."""
    from asr_using_robust_nn_tpu.ops import pallas_train as jpt

    kw = dict(in_dim=20, n_classes=4, hidden=(32, 16), nonneg=True,
              dropout=(0.0, 0.0))
    jspec = jpt.FusedStepSpec(cfg=jmlp.MLPConfig(**kw), batch=64, rho=0.5,
                              pi_iters=8, interpret=True)
    jp, js = jmlp.init_mlp(jspec.cfg, jax.random.PRNGKey(0))
    fs = jpt.pack_state(jspec, jp, js)
    rng = np.random.default_rng(0)
    x, y = blobs_task(rng, n=64, d=20, k=4)
    step = jpt.build_fused_step(jspec)
    for it in range(2):
        fs, _, _ = step(fs, jpt.pad_features(jspec, x), jnp.asarray(y),
                        jnp.ones((64,), jnp.float32), jnp.int32(it))
    return jax.tree_util.tree_map(np.asarray, fs)


def _assert_fstate_round_trip(fs_np):
    back = fstate_to_numpy(fstate_from_numpy(fs_np, device="cpu"))
    for k in ("masters", "w16", "mw", "vw"):
        for a, b in zip(back[k], fs_np[k]):
            np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    for k, v in fs_np["small"].items():
        np.testing.assert_array_equal(back["small"][k], v)
    for k in ("scales", "u", "count"):
        np.testing.assert_array_equal(back[k], fs_np[k])
    return back


def test_k6_state_round_trips_unchanged():
    """No fold of `scales` into the masters and no recast of `w16` on the
    way across, in either direction."""
    fs_np = _k6_state_np()
    assert np.all(fs_np["scales"][0, :3] != 1.0)
    m0 = np.asarray(fs_np["masters"][0])
    assert not np.array_equal(
        np.asarray(fs_np["w16"][0], np.float32),
        torch.tensor(m0).to(torch.bfloat16).float().numpy())
    _assert_fstate_round_trip(fs_np)
    fs = fstate_from_numpy(fs_np, device="cpu")
    assert fs["w16"][0].dtype == torch.bfloat16
    assert fs["count"].dtype == torch.int32 and int(fs["count"][0]) == 2


def test_stacked_multi_run_state_round_trips():
    """A multi-run state, runs axis leading, crosses leaf by leaf: the fused
    stack (from K6 states) and the plain stack with its (R,) Adam count."""
    one = _k6_state_np()
    stacked = jax.tree_util.tree_map(lambda a: np.stack([a, a * 2, a * 4]),
                                     one)
    back = _assert_fstate_round_trip(stacked)
    assert back["masters"][0].shape[0] == 3 and back["count"].shape == (3, 1)

    params, state, opt_state, cstate, _, _ = init_multi_run_state(
        CFG, OPT, [1, 2, 3], CON.init, device="cpu")
    opt_state["count"] += torch.tensor([4, 5, 6], dtype=torch.int32)
    p_np, s_np = params_to_numpy(params, state)
    count, mu, nu = adam_state_to_numpy(opt_state)
    assert count.tolist() == [4, 5, 6]
    p2, s2 = params_from_numpy(p_np, s_np, device="cpu")
    o2 = adam_state_from_numpy(count, mu, nu, device="cpu")
    _assert_trees_equal((p2, s2, o2), (params, state, opt_state))
    assert p2["layers"][0]["w"].shape == (3, 24, 16)


@pytest.mark.parametrize("algo", ["norm", "custom"])
def test_fit_multi_run_other_factories_vs_jax(algo, monkeypatch):
    """`norm` and `custom` as `constraint_factory` in a rho sweep on the
    plain backend, through both packages' `fit_multi_run`: the same stacked
    initial parameters and norm start vectors (numpy, from the JAX init),
    shuffle off, dropout 0, 3 epochs of 5 steps. Parameters and the
    validation rows within 5e-4 (the frozen-run test's bar)."""
    from asr_using_robust_nn_tpu.constraints.engine import (
        make_custom_constraint as jcustom, make_norm_constraint as jnorm)
    from asr_using_robust_nn_tpu.train.trainer import (
        TrainConfig as JTrainConfig)
    from asr_using_robust_nn_tpu_torch.constraints import (
        make_custom_constraint, make_norm_constraint)
    from asr_using_robust_nn_tpu_torch.train import multi_run as mr

    kw = dict(KW, dropout=(0.0, 0.0))
    jcfg, cfg = jmlp.MLPConfig(**kw), MLPConfig(**kw)
    x, y, xv, yv = _toy_data(300, 80)
    seeds, rhos = [3, 7], [0.5, 2.0]
    tkw = dict(batch_size=BS, epochs=3, patience=10, device_resident=True,
               epochs_per_dispatch=1, shuffle=False)
    jfac, fac = {"norm": (jnorm, make_norm_constraint),
                 "custom": (jcustom, make_custom_constraint)}[algo]
    jinit = jmr.init_multi_run_state(jcfg, jadam(1e-3), seeds,
                                     jfac(1.0).init)
    p_np, s_np = jax.tree_util.tree_map(np.asarray, (jinit[0], jinit[1]))
    u_np = jax.tree_util.tree_map(np.asarray, jinit[3])
    jres = jmr.fit_multi_run(jcfg, JTrainConfig(**tkw), x, y, xv, yv, seeds,
                             constraint_factory=jfac, rhos=rhos)

    def init_from_jax(model_cfg, optimizer, run_seeds, constraint_init=None,
                      mesh=None, device=None):
        port = init_multi_run_state(model_cfg, optimizer, run_seeds,
                                    constraint_init, device=device)
        params, state = params_from_numpy(p_np, s_np, device="cpu")
        zeros = jax.tree_util.tree_map(np.zeros_like, p_np)
        opt_state = adam_state_from_numpy(np.zeros(2, np.int32), zeros,
                                          zeros, device="cpu")
        cstate = ({"u": [torch.tensor(u) for u in u_np["u"]]}
                  if algo == "norm" else ())
        assert _tree_map(lambda t: t.shape, cstate) == _tree_map(
            lambda t: t.shape, port[3])
        return (params, state, opt_state, cstate, port[4], port[5])

    monkeypatch.setattr(mr, "init_multi_run_state", init_from_jax)
    res = fit_multi_run(cfg, TrainConfig(**tkw), x, y, xv, yv, seeds,
                        constraint_factory=fac, rhos=rhos, device="cpu")
    tol = dict(atol=5e-4, rtol=0)
    for key in ("val_loss", "val_acc", "loss"):
        np.testing.assert_allclose(res["history"][key], jres["history"][key],
                                   **tol)
    np.testing.assert_allclose(res["best_val_loss"], jres["best_val_loss"],
                               **tol)
    got = params_to_numpy(res["params"], res["state"])
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves((jres["params"],
                                               jres["state"]))):
        np.testing.assert_allclose(a, np.asarray(b), **tol)
    if algo == "norm":
        for a, b in zip(res["constraint_state"]["u"],
                        jres["constraint_state"]["u"]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-4)
