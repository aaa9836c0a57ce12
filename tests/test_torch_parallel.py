"""The port's data- and tensor-parallel trainers and the runs-sharded
multi-run against the JAX package's on the CPU (asr_using_robust_nn_tpu/
parallel/, its 8-device virtual mesh from tests/conftest.py): the
counterpart of tests/test_parallel.py.

The JAX side runs here; the port's side runs in worlds of 2 and of 4 gloo
ranks (`run_ranks` over tests/test_torch_distributed.py::parallel_world,
which imports no JAX), each spawned once, from the same numpy inputs
(weights through models/convert.py). Tolerances:

- the data-parallel and tensor-parallel steps against JAX's at dropout 0:
  1e-5 on the loss (relative), the parameters and the BN running stats
  (two fp32 programs summing in different orders). Adam's first update is
  lr * g / (|g| + 1e-7), so where the gradient itself is rounding noise
  (|g| < 1e-6 in the port's single-device gradient, e.g. a bias feeding BN
  whose ReLU is open on every row: BN removes it, its exact gradient is 0)
  any two programs move the parameter by different fractions of lr; those
  entries are held to lr;
- constrained data-parallel steps (simple_norm) against JAX's after three
  steps: 2e-4, docs/PARITY.md's projection tolerance;
- the runs-sharded multi-run against JAX's mesh multi-run (4 runs on 4
  devices there, 2 a rank here; shuffle off, dropout 0): best_val_loss
  rtol 3e-4, epochs_run equal.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from asr_using_robust_nn_tpu.constraints.engine import (
    make_simple_norm_constraint as jmake)
from asr_using_robust_nn_tpu.models import mlp as jmlp
from asr_using_robust_nn_tpu.parallel import (
    DataParallelTrainer as JDP, TensorParallelTrainer as JTP, data_mesh as
    jdata_mesh, mlp_tp_specs as jspecs, shard_mlp as jshard, tp_mesh as
    jtp_mesh)
from asr_using_robust_nn_tpu.parallel.tensor_parallel import (
    _check_divisible as jcheck)
from asr_using_robust_nn_tpu.train import multi_run as jmr
from asr_using_robust_nn_tpu.train.trainer import (
    TrainConfig as JTrainConfig, adam_optimizer as jadam)
from asr_using_robust_nn_tpu_torch.models.mlp import MLPConfig
from asr_using_robust_nn_tpu_torch.parallel import mlp_tp_specs
from asr_using_robust_nn_tpu_torch.parallel.launch import run_ranks
from asr_using_robust_nn_tpu_torch.parallel.tensor_parallel import (
    _check_divisible)

import test_torch_distributed as td

TIMEOUT = 240
KW = dict(in_dim=16, n_classes=4, hidden=(32, 16), dropout=(0.0, 0.0))
CON_KW = dict(KW, nonneg=True)


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _tree_np(params, state):
    return jax.tree_util.tree_map(np.asarray, (params, state))


def _grad(cfg_kw, tree, x, y):
    """The port's single-device loss gradient at `tree` (numpy leaves), in
    the JAX tree's leaf order."""
    from asr_using_robust_nn_tpu_torch.models.convert import (
        params_from_numpy, params_to_numpy)
    from asr_using_robust_nn_tpu_torch.models.mlp import apply_mlp
    from asr_using_robust_nn_tpu_torch.train.trainer import (
        _value_and_grad, cce_from_logits)

    cfg = MLPConfig(**cfg_kw)

    def loss(p, s):
        logits, _ = apply_mlp(cfg, p, s, torch.as_tensor(x), train=True)
        return cce_from_logits(logits, torch.as_tensor(y)), ()

    _, g = _value_and_grad(loss, *params_from_numpy(*tree, device="cpu"))
    return _leaves(params_to_numpy(g, {"layers": []})[0])


def _jstep(trainer, p, s, c, x, y, steps=1):
    """JAX trainer steps from numpy trees (copies: its steps donate)."""
    p, s = jax.tree_util.tree_map(jax.numpy.array, (p, s))
    o = trainer.optimizer.init(p)
    c = None if c is None else jax.tree_util.tree_map(jax.numpy.array, c)
    for _ in range(steps):
        p, s, o, c, loss, _ = trainer.train_step(p, s, o, c, x, y,
                                                 jax.random.PRNGKey(1))
    return {"params": _leaves(p), "state": _leaves(s), "loss": float(loss)}


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's results and the numpy inputs both sides share."""
    cfg, ccfg = jmlp.MLPConfig(**KW), jmlp.MLPConfig(**CON_KW)
    tree = _tree_np(*jmlp.init_mlp(cfg, jax.random.PRNGKey(0)))
    c_tree = _tree_np(*jmlp.init_mlp(ccfg, jax.random.PRNGKey(1)))
    x, y = td.blobs(64, seed=2)
    batches = [(x, y.astype(np.int32)), (x[:5], y[:5].astype(np.int32))]
    con = jmake(0.5, n_iter=8)
    u = np.asarray(con.init(c_tree[0])["u"])
    c_batch = (x, y.astype(np.int32))
    out = {"dp": []}
    for bx, by in batches:
        dp = JDP(cfg, jdata_mesh(), JTrainConfig(batch_size=len(bx)))
        out["dp"].append({**_jstep(dp, *tree, None, bx, by),
                          "grads": _grad(KW, tree, bx, by)})
    dpc = JDP(ccfg, jdata_mesh(), JTrainConfig(batch_size=64),
              constraint=con.apply)
    out["dp_con"] = _jstep(dpc, *c_tree, {"u": u}, *c_batch, steps=3)
    tp = JTP(ccfg, jtp_mesh(4, 2), JTrainConfig(batch_size=64),
             constraint=con.apply, constraint_state={"u": u})
    p, s = jshard(tp.mesh, *jax.tree_util.tree_map(jax.numpy.array, c_tree))
    p, s, _, _, loss, _ = tp.train_step(
        p, s, jax.jit(tp.optimizer.init)(p), tp._place_cstate(),
        *tp.place_batch(*c_batch), jax.random.PRNGKey(1))
    out["tp"] = {"params": _leaves(p), "state": _leaves(s),
                 "loss": float(loss), "grads": _grad(CON_KW, c_tree, *c_batch)}

    # the runs axis: 4 runs on a 4-device 'runs' mesh
    rcfg = jmlp.MLPConfig(in_dim=24, n_classes=4, hidden=(16, 8),
                          dropout=(0.0, 0.0), nonneg=True)
    seeds = [3, 7, 11, 13]
    rcon = jmake(1.0)
    init = jmr.init_multi_run_state(rcfg, jadam(1e-3), seeds, rcon.init)
    runs_init = (*_tree_np(init[0], init[1]), np.asarray(init[3]["u"]))
    rx, ry, rxv, ryv = td.run_data()
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("runs",))
    res = jmr.fit_multi_run(
        rcfg, JTrainConfig(**td.RUN_TCFG, shuffle=False), rx, ry, rxv, ryv,
        seeds, constraint=rcon.apply, constraint_init=rcon.init, mesh=mesh)
    out["runs"] = {"best_val_loss": np.asarray(res["best_val_loss"]),
                   "epochs_run": np.asarray(res["epochs_run"])}
    inputs = {"tree": tree, "batches": batches, "c_tree": c_tree, "u": u,
              "c_batch": c_batch, "runs_seeds": seeds,
              "runs_init": runs_init}
    return out, inputs


@pytest.fixture(scope="module")
def worlds(jax_side):
    """{2: [rank results], 4: [...]}: the port's side in worlds of 2 and 4
    (the runs case in the world of 2, the (2, 2) fit cases in the world of
    4)."""
    _, inputs = jax_side
    four = {k: v for k, v in inputs.items() if not k.startswith("runs")}
    return {w: run_ranks(td.parallel_world, w, "gloo", "cpu",
                         args=({"jax": inp},), timeout=TIMEOUT)
            for w, inp in ((2, inputs), (4, four))}


def _close(got, want, tol):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=tol, rtol=0)


LR = 1e-3


def _close_step(got, want, grads, tol=1e-5):
    """One step's parameters within `tol`, except entries whose gradient is
    rounding noise (|g| < 1e-6 in the port's single-device gradient; the
    JAX package's reads an exact 0 for some of them), held to lr."""
    for a, b, g in zip(got, want, grads):
        flat = np.abs(g) < 1e-6
        np.testing.assert_allclose(a[~flat], b[~flat], atol=tol, rtol=0)
        np.testing.assert_allclose(a[flat], b[flat], atol=LR * 1.01, rtol=0)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("batch", [0, 1], ids=["64_rows", "5_rows_ragged"])
def test_dp_step_matches_jax(jax_side, worlds, world, batch):
    """One data-parallel step (BN on, dropout 0) against JAX's on its
    8-device mesh; the 5-row batch pads to the world with weight-0 rows
    (BN's moments leave them out)."""
    want = jax_side[0]["dp"][batch]
    for r in worlds[world]:
        got = r["dp"][batch]
        assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
        _close_step(got["params"], want["params"], want["grads"])
        _close(got["state"], want["state"], 1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_constrained_dp_matches_jax(jax_side, worlds, world):
    """Three constrained steps (NonNeg, simple_norm rho 0.5, the JAX u
    carried over) against JAX's data-parallel trainer: 2e-4."""
    want = jax_side[0]["dp_con"]
    for r in worlds[world]:
        got = r["dp_con"]
        assert abs(got["loss"] - want["loss"]) <= 2e-4
        _close(got["params"], want["params"], 2e-4)


@pytest.mark.parametrize("world", [2, 4])
def test_tp_step_matches_jax(jax_side, worlds, world):
    """One constrained tensor-parallel step on (1, 2) and (2, 2) meshes
    against JAX's on (4, 2) and against the port's single-device step:
    1e-5; layer 0 is column-parallel (its kernel split by columns)."""
    want_jax = jax_side[0]["tp"]
    for want in (want_jax, {**td.single_step_np(
            dataclasses.replace(td.SMALL, nonneg=True), jax_side[1]),
            "grads": want_jax["grads"]}):
        for r in worlds[world]:
            got = r["tp"]
            assert got["shard_w0"] == (16, 16)
            assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(
                want["loss"])
            _close_step(got["params"], want["params"], want["grads"])
            _close(got["state"], want["state"], 1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_psum_step_matches_dp(worlds, world):
    """The explicit-collective step equals DataParallelTrainer's on a no-BN
    model (1e-6)."""
    for r in worlds[world]:
        got = r["psum"]
        assert abs(got["psum_loss"] - got["dp_loss"]) <= 1e-6
        _close(got["psum"], got["dp"], 1e-6)


@pytest.mark.parametrize("cfg_kw", [KW, dict(KW, batch_norm=False),
                                    dict(KW, hidden=(32, 16, 8))])
def test_specs_alternate_as_jax(cfg_kw):
    """Every leaf's split axis equals the JAX package's PartitionSpec."""
    got = mlp_tp_specs(MLPConfig(**cfg_kw))
    want = jspecs(jmlp.MLPConfig(**cfg_kw))
    for g_tree, w_tree in zip(got, want):
        g_layers, w_layers = g_tree["layers"], w_tree["layers"]
        assert len(g_layers) == len(w_layers)
        for g, w in zip(g_layers, w_layers):
            assert sorted(g) == sorted(w)
            for k in g:
                assert tuple(g[k]) == tuple(w[k]), (k, g[k], w[k])
    p = got[0]["layers"]
    assert p[0]["w"] == (None, "model") and p[1]["w"] == ("model", None)


@pytest.mark.parametrize("n_model", [2, 4, 8])
def test_digit_config_is_shardable(n_model):
    for cfg in ("digit_constrained", "speaker_unconstrained"):
        _check_divisible(getattr(MLPConfig, cfg)(), n_model)
        jcheck(getattr(jmlp.MLPConfig, cfg)(), n_model)
    with pytest.raises(ValueError, match="not divisible"):
        _check_divisible(MLPConfig(**dict(KW, hidden=(30, 16))), 4)


def test_indivisible_dim_rejected_on_a_mesh(worlds):
    for r in worlds[4]:
        assert "not divisible" in r["tp_indivisible"]


def test_tp_fit_trains_sharded(worlds):
    """fit on a (2, 2) mesh trains the shards (layer 0 holds half its
    columns) and its history is the single-device fit's (rtol 1e-4, as the
    JAX package holds its own)."""
    x, y = td.blobs(256, seed=6)
    want = td.single_fit(td.SMALL, x[:192], y[:192], x[192:], y[192:],
                         epochs=3)
    for r in worlds[4]:
        got = r["fit"]
        assert got["shard_w0"] == (16, 16)
        np.testing.assert_allclose(got["history"]["loss"], want["loss"],
                                   rtol=1e-4)
        np.testing.assert_allclose(got["history"]["val_loss"],
                                   want["val_loss"], rtol=1e-4)


def test_tp_fit_warm_start(worlds):
    """fit(params=best_params, state=best_state) re-shards the whole trees;
    a restored optimizer state is refused, as in the JAX package."""
    for r in worlds[4]:
        got = r["fit"]
        assert got["warm_shard_w0"] == (16, 16)
        assert np.isfinite(got["warm_history"]["loss"]).all()
        assert got["warm_history"]["loss"][0] < got["history"]["loss"][0]
        assert got["adopt_opt"].startswith("NotImplementedError")


def test_tp_fit_ragged_final_batch(worlds):
    """151 rows at batch 64: the 23-row tail does not divide over 'data'
    and runs whole on both data ranks; the history is the single-device
    fit's (rtol 1e-4)."""
    x, y = td.blobs(256, seed=6)
    want = td.single_fit(td.SMALL, x[:151], y[:151], x[:32], y[:32],
                         epochs=3)
    for r in worlds[4]:
        np.testing.assert_allclose(r["fit"]["ragged_history"]["loss"],
                                   want["loss"], rtol=1e-4)


def test_tp_fit_keeps_the_constraint_state(worlds):
    """Two fits from one caller-owned constraint state: both train, the
    trainer's state is left as it was (each fit copies it)."""
    for r in worlds[4]:
        got = r["fit"]
        assert got["cstate_kept"]
        for h in got["con_histories"]:
            assert np.isfinite(h["loss"]).all()
        np.testing.assert_array_equal(got["con_histories"][0]["loss"],
                                      got["con_histories"][1]["loss"])


def test_runs_sharded_matches_jax_mesh(jax_side, worlds):
    """4 runs over 2 ranks from JAX's stacked init against JAX's multi-run
    with the runs axis on 4 devices: rtol 3e-4 (the JAX package's own bar
    between its sharded and unsharded runs); the same stop epochs."""
    want = jax_side[0]["runs"]
    for r in worlds[2]:
        got = r["runs_from_jax"]
        np.testing.assert_array_equal(got["epochs_run"], want["epochs_run"])
        np.testing.assert_allclose(got["best_val_loss"],
                                   want["best_val_loss"], rtol=3e-4)
