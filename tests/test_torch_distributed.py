"""The port's parallel slice over torch.distributed on the CPU, in worlds of
gloo ranks (asr_using_robust_nn_tpu_torch/parallel/): the counterpart of the
JAX package's tests/test_distributed.py and of the parts of
tests/test_parallel.py / tests/test_multi_run.py that hold the port to its
own single-device programs.

Each world is spawned once (a module fixture over `run_ranks`, one torch
thread a rank) and runs every case in every rank; the tests then compare
what the ranks returned. Every wait has a timeout (`run_ranks` kills a
world that does not finish; the torchrun commands run under
`subprocess.run(timeout=...)`), so a deadlocked collective fails a test
instead of hanging the suite.

This file imports neither JAX nor the JAX package: the ranks import it (the
`*_world` functions below run in them), and tests/test_torch_parallel.py,
which holds the port to JAX, sends its cases to `parallel_world`.

Tolerances: the data-parallel and tensor-parallel programs against the
single-device ones are two fp32 programs whose sums run in other orders:
1e-5. The runs-sharded multi-run trains each run as the unsharded one does:
bit for bit on one thread.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from asr_using_robust_nn_tpu_torch.constraints import (
    make_simple_norm_constraint)
from asr_using_robust_nn_tpu_torch.models.convert import (
    cstate_from_numpy, params_from_numpy)
from asr_using_robust_nn_tpu_torch.models.mlp import MLPConfig, init_mlp
from asr_using_robust_nn_tpu_torch.parallel import (
    DataParallelTrainer, TensorParallelTrainer, data_mesh,
    maybe_init_distributed, psum_train_step, tp_mesh)
from asr_using_robust_nn_tpu_torch.parallel import mesh as pm
from asr_using_robust_nn_tpu_torch.parallel.launch import run_ranks
from asr_using_robust_nn_tpu_torch.train import multi_run as mr
from asr_using_robust_nn_tpu_torch.train.trainer import (
    TrainConfig, Trainer, _tree_leaves, adam_optimizer)
from asr_using_robust_nn_tpu_torch.utils import device as device_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
TOY = MLPConfig(in_dim=40, n_classes=10, hidden=(32, 16), dropout=(0.1, 0.0),
                batch_norm=True, nonneg=True)
SMALL = MLPConfig(in_dim=16, n_classes=4, hidden=(32, 16),
                  dropout=(0.0, 0.0))
RUN_CFG = MLPConfig(in_dim=24, n_classes=4, hidden=(16, 8),
                    dropout=(0.1, 0.0), nonneg=True)
TIMEOUT = 240


def blobs(n, d=16, k=4, seed=0):
    """Separable blobs (tests/conftest.py's task, without importing it:
    the ranks must not import JAX)."""
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((k, d)) * 3.0
    y = rng.integers(0, k, n)
    x = (means[y] + rng.standard_normal((n, d))).astype(np.float32)
    return x, y


def _np(tree):
    return [t.detach().cpu().numpy().copy() for t in _tree_leaves(tree)]


def step_np(trainer, params, state, opt_state, cstate, x, y, steps=1,
            seed=1):
    """`steps` train steps of `trainer` on one batch -> numpy results."""
    gen = torch.Generator().manual_seed(seed)
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    for _ in range(steps):
        params, state, opt_state, cstate, loss, acc = trainer.train_step(
            params, state, opt_state, cstate, xt, yt, gen)
    return params, state, {"loss": float(loss), "acc": float(acc)}


def init_np(cfg, seed=0):
    return init_mlp(cfg, torch.Generator().manual_seed(seed), device=CPU)


def _raises(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return None


# -- what the ranks run -------------------------------------------------------

def _mesh_case():
    world = dist.get_world_size()
    m1 = data_mesh()
    m2 = tp_mesh(world // 2, 2)
    x = torch.tensor([dist.get_rank() + 1.0], requires_grad=True)
    with torch.enable_grad():
        y = pm.all_reduce_sum(m1, x)
        (g_sum,) = torch.autograd.grad(y * (dist.get_rank() + 1.0), x)
        c = pm.copy_to_axis(m2, x * 1.0, "model")
        (g_copy,) = torch.autograd.grad(c.sum() * 2.0, x)
        r = pm.reduce_from_axis(m2, x * 1.0, "model")
        (g_red,) = torch.autograd.grad(r.sum() * 3.0, x)
    rows = pm.gather_rows(m1, torch.full((2, 3), float(dist.get_rank())))
    t = torch.tensor([dist.get_rank() + 1.0])
    dist.all_reduce(t)
    return {"world": world, "rank": dist.get_rank(), "backend":
            dist.get_backend(), "world_sum": float(t),
            "shape1": m1.shape, "coords1": m1.coords,
            "shape2": m2.shape, "coords2": m2.coords,
            "axes2": m2.axis_names, "sum": float(y), "g_sum": float(g_sum),
            "copy": float(c), "g_copy": float(g_copy), "reduce": float(r),
            "g_reduce": float(g_red), "gathered": rows.numpy(),
            "sharded": pm.sharded_batch(m1, np.arange(4 * world)),
            "bad_mesh": _raises(lambda: data_mesh(world + 1))}


def _dp_dropout_case():
    """DataParallelTrainer's step at dropout 0.1 (toy config, constrained,
    a batch that does not divide over the world)."""
    con = make_simple_norm_constraint(0.1, n_iter=4)
    tr = DataParallelTrainer(TOY, data_mesh(), TrainConfig(batch_size=13),
                             constraint=con.apply, device=CPU)
    p, s = init_np(TOY)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((13, 40)).astype(np.float32)
    y = rng.integers(0, 10, 13)
    p, s, m = step_np(tr, p, s, tr.optimizer.init(p), con.init(p), x, y, 2)
    return {"params": _np(p), "state": _np(s), **m}


def single_dropout_step():
    """The single-device counterpart of `_dp_dropout_case`."""
    con = make_simple_norm_constraint(0.1, n_iter=4)
    tr = Trainer(TOY, TrainConfig(batch_size=13), constraint=con.apply,
                 device=CPU)
    p, s = init_np(TOY)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((13, 40)).astype(np.float32)
    y = rng.integers(0, 10, 13)
    p, s, m = step_np(tr, p, s, tr.optimizer.init(p), con.init(p), x, y, 2)
    return {"params": _np(p), "state": _np(s), **m}


DR = dict(batch_size=32, epochs=3, patience=10, device_resident=True)


def device_resident_fit(trainer_cls, *args, **tkw):
    cfg0 = dataclasses.replace(TOY, dropout=(0.0, 0.0))
    x, y = blobs(200, d=40, k=10, seed=4)
    tr = trainer_cls(cfg0, *args, TrainConfig(**{**DR, **tkw}), device=CPU)
    return tr.fit(x[:160], y[:160], x[160:], y[160:])["history"]


def _device_resident_case():
    mesh = data_mesh()
    return {
        "history": device_resident_fit(DataParallelTrainer, mesh),
        "indivisible": _raises(lambda: device_resident_fit(
            DataParallelTrainer, mesh, batch_size=33)),
        "fused": _raises(lambda: device_resident_fit(
            DataParallelTrainer, mesh, epoch_backend="fused"))}


def run_data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((300, 24)).astype(np.float32)
    y = rng.integers(0, 4, 300)
    x[np.arange(300), y] += 2.0
    yv = rng.permutation(y[:80])  # val_loss worsens: runs freeze apart
    return x, y, x[:80], yv


RUN_TCFG = dict(batch_size=64, epochs=5, patience=2, device_resident=True,
                epochs_per_dispatch=1)


def multi_run(mesh, seeds, init=None):
    """`fit_multi_run` of RUN_CFG (simple_norm rho 1) over `seeds`;
    `init` (numpy stacked params, state, u of every run) replaces the
    port's seeded init."""
    x, y, xv, yv = run_data()
    con = make_simple_norm_constraint(1.0)
    kw = dict(constraint=con.apply, constraint_init=con.init, mesh=mesh,
              device=CPU)
    cfg, tcfg = RUN_CFG, TrainConfig(**RUN_TCFG)
    if init is not None:  # the JAX package's draws: no dropout, no shuffle
        cfg = dataclasses.replace(RUN_CFG, dropout=(0.0, 0.0))
        tcfg = dataclasses.replace(tcfg, shuffle=False)
        kw["_init"] = init
    return _fit_multi_run(cfg, tcfg, x, y, xv, yv, seeds, **kw)


def _fit_multi_run(cfg, tcfg, x, y, xv, yv, seeds, _init=None, **kw):
    if _init is None:
        return mr.fit_multi_run(cfg, tcfg, x, y, xv, yv, seeds, **kw)
    p_np, s_np, u_np = _init
    all_seeds = list(seeds)
    port_init = mr.init_multi_run_state

    def from_numpy(model_cfg, optimizer, run_seeds, constraint_init=None,
                   mesh=None, device=None):
        """The stacked numpy init of the runs `run_seeds` (this rank's)."""
        idx = [all_seeds.index(int(s)) for s in run_seeds]
        pick = lambda a: np.ascontiguousarray(np.asarray(a)[idx])  # noqa
        port = port_init(model_cfg, optimizer, run_seeds, constraint_init,
                         device=device)
        params, state = params_from_numpy(
            _map(pick, p_np), _map(pick, s_np), device=CPU)
        opt = optimizer.init(params)
        opt["count"] = torch.zeros(len(idx), dtype=torch.int32)
        return (params, state, opt, cstate_from_numpy(
            {"u": pick(u_np)}, device=CPU), port[4], port[5])

    mr.init_multi_run_state = from_numpy
    try:
        return mr.fit_multi_run(cfg, tcfg, x, y, xv, yv, seeds, **kw)
    finally:
        mr.init_multi_run_state = port_init


def _map(fn, tree):
    return {"layers": [{k: fn(v) for k, v in layer.items()}
                       for layer in tree["layers"]]}


def _runs_result(res):
    return {"best_val_loss": res["best_val_loss"],
            "epochs_run": res["epochs_run"], "best_epoch": res["best_epoch"],
            "history": res["history"], "best_params": _np(res["best_params"])}


def _runs_case():
    return {"indivisible": _raises(lambda: multi_run(data_mesh(), [0, 1, 2])),
            "sharded": _runs_result(multi_run(data_mesh(), [3, 7, 11, 13]))}


def _dp_from(cfg, tree, x, y, steps=1, con=None, u=None):
    """DataParallelTrainer's `steps` steps from numpy trees (+ the JAX u)."""
    tr = DataParallelTrainer(cfg, data_mesh(), TrainConfig(batch_size=len(x)),
                             constraint=None if con is None else con.apply,
                             device=CPU)
    p, s = params_from_numpy(*tree, device=CPU)
    c = None if u is None else cstate_from_numpy({"u": u}, device=CPU)
    p, s, m = step_np(tr, p, s, tr.optimizer.init(p), c, x, y, steps)
    return {"params": _np(p), "state": _np(s), **m}


def _tp_from(cfg, tree, x, y, con, u, n_data):
    world = dist.get_world_size()
    tr = TensorParallelTrainer(cfg, tp_mesh(n_data, world // n_data),
                               TrainConfig(batch_size=len(x)),
                               constraint=con.apply, device=CPU)
    p, s = params_from_numpy(*tree, device=CPU)
    p, s, o, _ = tr._adopt_train_state(p, s)
    shard_w0 = tuple(p["layers"][0]["w"].shape)
    p, s, m = step_np(tr, p, s, o, cstate_from_numpy({"u": u}, device=CPU),
                      x, y)
    p, s, _ = tr._full_trees(p, s)
    return {"params": _np(p), "state": _np(s), "shard_w0": shard_w0, **m}


def single_step_np(cfg, jx):
    """The port's single-device constrained step from the numpy inputs of
    tests/test_torch_parallel.py (its tensor-parallel case)."""
    con = make_simple_norm_constraint(0.5, n_iter=8)
    x, y = jx["c_batch"]
    tr = Trainer(cfg, TrainConfig(batch_size=len(x)), constraint=con.apply,
                 device=CPU)
    p, s = params_from_numpy(*jx["c_tree"], device=CPU)
    p, s, m = step_np(tr, p, s, tr.optimizer.init(p), cstate_from_numpy(
        {"u": jx["u"]}, device=CPU), x, y)
    return {"params": _np(p), "state": _np(s), **m}


def _tp_fit_cases():
    """The four fit cases of the JAX package's TestTensorParallelFit on a
    (2, 2) mesh, each with its single-device fit."""
    x, y = blobs(256, seed=6)
    tcfg = TrainConfig(batch_size=64, epochs=3, patience=100, seed=0)
    mesh = tp_mesh(2, 2)
    tp = TensorParallelTrainer(SMALL, mesh, tcfg, device=CPU)
    res = tp.fit(x[:192], y[:192], x[192:], y[192:])
    warm = tp.fit(x[:192], y[:192], x[192:], y[192:],
                  params=res["best_params"], state=res["best_state"])
    ragged = tp.fit(x[:151], y[:151], x[:32], y[:32])  # a 23-row tail
    con = make_simple_norm_constraint(0.5, n_iter=8)
    c_cfg = dataclasses.replace(SMALL, nonneg=True)
    p0, _ = init_np(c_cfg)
    cstate = con.init(p0)
    u0 = cstate["u"].clone()
    tc = TensorParallelTrainer(c_cfg, mesh, dataclasses.replace(
        tcfg, epochs=1), constraint=con.apply, constraint_state=cstate,
        device=CPU)
    c1 = tc.fit(x[:192], y[:192], x[192:], y[192:])
    c2 = tc.fit(x[:192], y[:192], x[192:], y[192:])
    return {"fit": {
        "shard_w0": tuple(res["params"]["layers"][0]["w"].shape),
        "history": res["history"], "warm_history": warm["history"],
        "warm_shard_w0": tuple(warm["params"]["layers"][0]["w"].shape),
        "ragged_history": ragged["history"],
        "con_histories": [c1["history"], c2["history"]],
        "cstate_kept": bool(torch.equal(tc.constraint_state["u"], u0)),
        "adopt_opt": _raises(lambda: tp._adopt_train_state(
            res["best_params"], res["best_state"],
            tp.optimizer.init(res["best_params"])))}}


def single_fit(cfg, x, y, xv, yv, **kw):
    tr = Trainer(cfg, TrainConfig(batch_size=64, patience=100, seed=0, **kw),
                 device=CPU)
    return tr.fit(x, y, xv, yv)["history"]


def jax_cases(jx: dict) -> dict:
    """The port's side of tests/test_torch_parallel.py's comparisons with
    the JAX package, from its numpy inputs."""
    world = dist.get_world_size()
    out = {"dp": [_dp_from(SMALL, jx["tree"], x, y) for x, y in jx["batches"]]}
    c_cfg = dataclasses.replace(SMALL, nonneg=True)
    con = make_simple_norm_constraint(0.5, n_iter=8)
    out["dp_con"] = _dp_from(c_cfg, jx["c_tree"], *jx["c_batch"], steps=3,
                             con=con, u=jx["u"])
    out["tp"] = _tp_from(c_cfg, jx["c_tree"], *jx["c_batch"], con, jx["u"],
                         n_data=world // 2)
    nb = dataclasses.replace(SMALL, batch_norm=False)
    p, s = init_np(nb)
    opt = adam_optimizer(1e-3)
    xb, yb = jx["batches"][0]
    p1, _, _, loss, _ = psum_train_step(nb, opt, data_mesh())(
        p, s, opt.init(p), torch.as_tensor(xb), torch.as_tensor(yb),
        torch.Generator().manual_seed(1))
    dp = DataParallelTrainer(nb, data_mesh(), TrainConfig(batch_size=len(xb)),
                             device=CPU)
    p2, _, m = step_np(dp, p, s, opt.init(p), None, xb, yb)
    out["psum"] = {"psum": _np(p1), "dp": _np(p2), "psum_loss": float(loss),
                   "dp_loss": m["loss"]}
    if world == 4:
        out.update(_tp_fit_cases())
        out["tp_indivisible"] = _raises(lambda: TensorParallelTrainer(
            dataclasses.replace(SMALL, hidden=(30, 16)), tp_mesh(1, 4),
            TrainConfig(batch_size=8), device=CPU))
    if "runs_init" in jx:
        out["runs_from_jax"] = _runs_result(multi_run(
            data_mesh(), jx["runs_seeds"], jx["runs_init"]))
    return out


def parallel_world(inputs: dict) -> dict:
    """What a rank runs: every port-only case of this file, or (given
    `inputs["jax"]`, numpy made with the JAX package by
    tests/test_torch_parallel.py) the port's side of that file."""
    if "jax" in inputs:
        return jax_cases(inputs["jax"])
    from asr_using_robust_nn_tpu_torch.parallel.dryrun import (
        dryrun_multichip)

    return {"mesh": _mesh_case(), "dp_dropout": _dp_dropout_case(),
            "device_resident": _device_resident_case(),
            "runs": _runs_case(), "dryrun": dryrun_multichip(CPU)}


@pytest.fixture(scope="module")
def world2():
    return run_ranks(parallel_world, 2, "gloo", "cpu", args=({},),
                     timeout=TIMEOUT)


# -- tests --------------------------------------------------------------------

def test_maybe_init_distributed_without_environment(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert maybe_init_distributed() is False
    assert not dist.is_initialized()


def test_one_rank_mesh_without_a_group():
    """No process group: data_mesh() and tp_mesh(1, 1) have one rank and
    run no collective (the JAX package's data_mesh() on one chip)."""
    m = data_mesh()
    assert m.shape == {"data": 1} and m.coords == {"data": 0}
    assert m.axis_names == ("data",) and m.group("data") is None
    t = tp_mesh(1, 1)
    assert t.axis_names == ("data", "model")
    assert t.shape == {"data": 1, "model": 1}
    x = torch.ones(3)
    assert pm.all_reduce_sum(m, x) is x
    assert pm.gather_rows(m, x) is x
    with pytest.raises(ValueError, match="whole"):
        data_mesh(2)
    with pytest.raises(ValueError, match="each of the 1 ranks"):
        tp_mesh(2, 2)


def test_rank_local_device(monkeypatch):
    """device=None under a process group is the rank's card, LOCAL_RANK
    modulo the card count; it raises where there is no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert device_mod.resolve_device(None, local_rank=3) == torch.device(
        "cuda", 1)
    assert device_mod.resolve_device(None) == torch.device("cuda")
    assert device_mod.resolve_device("cpu") == CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_mod.resolve_device(None, local_rank=0)


def test_two_processes_come_up(world2):
    """The analog of tests/test_distributed.py: two processes joined
    through maybe_init_distributed (run_ranks calls it) see each other."""
    res = [r["mesh"] for r in world2]
    assert [r["rank"] for r in res] == [0, 1]
    assert all(r["world"] == 2 and r["world_sum"] == 3.0
               and r["backend"] == "gloo" for r in res)


def test_mesh_shapes_and_coordinates(world2):
    for rank, r in enumerate(world2):
        assert r["mesh"]["shape1"] == {"data": 2}
        assert r["mesh"]["coords1"] == {"data": rank}
        assert r["mesh"]["axes2"] == ("data", "model")
        assert r["mesh"]["shape2"] == {"data": 1, "model": 2}
        assert r["mesh"]["coords2"] == {"data": 0, "model": rank}
        np.testing.assert_array_equal(r["mesh"]["sharded"],
                                      np.arange(8)[4 * rank: 4 * rank + 4])
        assert "whole" in r["mesh"]["bad_mesh"]


def test_collectives_and_their_gradients(world2):
    """The sum all-reduce (its backward all-reduces the gradient), the
    Megatron pair (identity / all-reduce and back) and the gather."""
    for rank, r in enumerate(world2):
        m = r["mesh"]
        assert m["sum"] == 3.0 and m["g_sum"] == 3.0  # d(sum_k (k+1) y)/dx
        assert m["copy"] == rank + 1.0 and m["g_copy"] == 4.0  # 2 + 2
        assert m["reduce"] == 3.0 and m["g_reduce"] == 3.0
        np.testing.assert_array_equal(m["gathered"], np.repeat(
            np.arange(2.0), 2)[:, None] * np.ones((1, 3)))


def test_dp_matches_single_device_at_dropout(world2):
    """Dropout 0.1 and BN, two constrained steps on a 13-row batch over 2
    ranks: each rank keeps its rows of the single-device (13, width) mask,
    so the data-parallel step is the single-device step (1e-5)."""
    want = single_dropout_step()
    for r in world2:
        got = r["dp_dropout"]
        assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
        for a, b in zip(got["params"] + got["state"],
                        want["params"] + want["state"]):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_device_resident_dp_fit(world2):
    """A device-resident fit over 2 ranks against the single-device one,
    dropout 0: every epoch's loss, accuracy and validation metrics within
    1e-5; a batch that does not divide raises, the fused epoch is refused
    under a mesh."""
    want = device_resident_fit(Trainer)
    for r in world2:
        got = r["device_resident"]
        for k in ("loss", "acc", "val_loss", "val_acc"):
            np.testing.assert_allclose(got["history"][k], want[k], atol=1e-5,
                                       rtol=0)
        assert "divisible" in got["indivisible"]
        assert got["fused"].startswith("ValueError") and "mesh" in got["fused"]


def test_runs_sharded_equal_unsharded(world2):
    """4 runs over 2 ranks (2 a rank) against the unsharded fit_multi_run,
    one torch thread on both sides: bit for bit, and every rank returns all
    the runs; the runs freeze at different chunks."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = _runs_result(multi_run(None, [3, 7, 11, 13]))
    finally:
        torch.set_num_threads(n)
    assert len(set(want["epochs_run"].tolist())) > 1, want["epochs_run"]
    for r in world2:
        got = r["runs"]["sharded"]
        for k in ("best_val_loss", "epochs_run", "best_epoch"):
            np.testing.assert_array_equal(got[k], want[k])
        for k in want["history"]:
            np.testing.assert_array_equal(got["history"][k],
                                          want["history"][k])
        for a, b in zip(got["best_params"], want["best_params"]):
            np.testing.assert_array_equal(a, b)


def test_runs_that_do_not_divide_raise(world2):
    for r in world2:
        assert "divide across" in r["runs"]["indivisible"]


def test_psum_step_refuses_bn():
    opt = adam_optimizer(1e-3)
    with pytest.raises(ValueError, match="batch_norm"):
        psum_train_step(dataclasses.replace(SMALL, batch_norm=True), opt,
                        data_mesh())


def test_tp_refuses_device_resident_and_axes():
    with pytest.raises(NotImplementedError, match="device_resident"):
        TensorParallelTrainer(SMALL, tp_mesh(1, 1),
                              TrainConfig(batch_size=8, device_resident=True),
                              device=CPU)
    with pytest.raises(ValueError, match="mesh axes"):
        TensorParallelTrainer(SMALL, data_mesh(), TrainConfig(batch_size=8),
                              device=CPU)


def test_dryrun_oracles_at_two_ranks(world2):
    """parallel/dryrun.py's oracles (the JAX package's dry run: toy at 1e-5,
    the digit recipe at batch 512 at 1e-4, bf16 finite, runs-sharded
    multi-run) in a world of 2; every rank holds every one."""
    for r in (w["dryrun"] for w in world2):
        for case in ("toy", "digit"):
            got = r[case]
            for k in ("dp", "tp"):
                assert got[f"{k}_loss_rel"] <= 10 * got["tol"], (case, got)
                assert got[f"{k}_w_abs"] <= got["tol"], (case, got)
        assert np.isfinite(r["bf16_loss"])
        assert r["multi_run"]["params_equal"]
        assert r["multi_run"]["epochs_run_equal"]
        # one projection a train step of each parallel path (the multi-run:
        # the rank's 2 runs x 2 epochs x 4 steps); no K2 launch on the CPU
        assert {k: v["projections"] for k, v in r["k2"].items()} == {
            **{f"{case}/{path}": 1 for case in ("toy", "digit")
               for path in ("dp_step", "dp_fit", "tp_step")},
            "bf16_dp_step": 1, "multi_run_sharded": 16}
        assert all(v["launches"] == 0 for v in r["k2"].values())


# -- the CLI under torchrun ---------------------------------------------------

@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """prepare-data's six files (float64 features, int32 labels) of a
    learnable 3-class 880-wide task."""
    out = tmp_path_factory.mktemp("dist_cli") / "processed"
    out.mkdir()
    rng = np.random.default_rng(5)
    means = 0.2 * rng.standard_normal((3, 880))
    for name, n in zip(("train", "dev", "test"), (48, 16, 16)):
        y = rng.integers(0, 3, n).astype(np.int32)
        np.save(out / f"{name}_data.npy", means[y] + rng.standard_normal(
            (n, 880)))
        np.save(out / f"{name}_label.npy", y)
    return out


def torchrun(argv, nproc=2):
    """The port's CLI under `torchrun --nproc_per_node nproc` on the CPU
    (one torch thread a rank) -> the completed process."""
    port = str(__import__("asr_using_robust_nn_tpu_torch.parallel.launch",
                          fromlist=["free_port"]).free_port())
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         str(nproc), "--master_addr", "127.0.0.1", "--master_port", port,
         "-m", "asr_using_robust_nn_tpu_torch.cli.main", *argv,
         "--device", "cpu"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=TIMEOUT)


TRAIN = ["train", "--task", "digit", "--variant", "constrained", "--epochs",
         "3", "--patience", "10", "--batch-size", "8", "--log-every", "0"]


def test_train_data_parallel_under_torchrun(artifacts, tmp_path):
    """`train --data-parallel` on 2 ranks writes one store, from rank 0, and
    rank 0 alone prints: its test accuracy is the single-process `train`'s
    within one test row, its best val_loss within 1e-4."""
    from asr_using_robust_nn_tpu_torch.cli.main import main

    ck1, ck2 = tmp_path / "single", tmp_path / "dp"
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert main([*TRAIN, "--data", str(artifacts), "--ckpt", str(ck1),
                     "--device", "cpu"]) == 0
    finally:
        torch.set_num_threads(n)
    proc = torchrun([*TRAIN, "--data-parallel", "--data", str(artifacts),
                     "--ckpt", str(ck2)])
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, proc.stdout  # rank 0 alone prints the JSON
    got = json.loads(lines[0])
    assert sorted(os.listdir(ck2)) == ["best.npz", "meta.json"]
    want = json.loads((ck1 / "meta.json").read_text())
    meta = json.loads((ck2 / "meta.json").read_text())
    assert meta["epoch"] == want["epoch"]
    assert abs(meta["val_loss"] - want["val_loss"]) <= 1e-4
    from asr_using_robust_nn_tpu_torch.cli.main import load_model, \
        model_cfg_for
    from asr_using_robust_nn_tpu_torch.train.trainer import Trainer as T

    cfg = model_cfg_for("digit", "constrained")
    te = np.load(artifacts / "test_data.npy")
    accs = []
    for ck in (ck1, ck2):
        p, s = load_model(ck, cfg)
        probs = T(cfg, device=CPU).predict(*params_from_numpy(p, s, CPU), te)
        accs.append(np.argmax(probs, -1))
    assert np.sum(accs[0] != accs[1]) <= 1
    assert got["epochs_run"] == 3


def test_train_multi_runs_mesh_under_torchrun(artifacts, tmp_path):
    """`train-multi --runs-mesh` on 2 ranks (4 seeds, 2 a rank): rank 0
    writes every run's store and prints; each run's best val_loss equals the
    single-process run's within rtol 1e-4; a run count that does not divide
    exits 2."""
    from asr_using_robust_nn_tpu_torch.cli.main import main

    base = ["train-multi", "--task", "digit", "--variant", "constrained",
            "--data", str(artifacts), "--epochs", "3", "--batch-size", "16",
            "--epochs-per-dispatch", "1"]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert main([*base, "--seeds", "0,1,2,3", "--ckpt",
                     str(tmp_path / "one"), "--device", "cpu"]) == 0
    finally:
        torch.set_num_threads(n)
    proc = torchrun([*base, "--seeds", "0,1,2,3", "--runs-mesh", "--ckpt",
                     str(tmp_path / "mesh")])
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, proc.stdout
    got = json.loads(lines[0])["runs"]
    for r in got:
        want = json.loads((tmp_path / "one" / os.path.basename(r["ckpt"])
                           / "meta.json").read_text())
        assert abs(r["best_val_loss"] - want["val_loss"]) <= 1e-4 * abs(
            want["val_loss"])
        assert os.path.exists(os.path.join(r["ckpt"], "best.npz"))
    bad = torchrun([*base, "--seeds", "0,1,2", "--runs-mesh", "--ckpt",
                    str(tmp_path / "bad")])
    assert bad.returncode != 0
    assert "divide across 2 devices" in bad.stderr
