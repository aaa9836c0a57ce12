"""The port's batched multi-run trainer and the `train-multi` command
(asr_using_robust_nn_tpu_torch/train/multi_run.py, cli/main.py) against the
JAX package on the CPU.

- The batched plain epoch (all runs as one program: a `torch.bmm` a Dense)
  against JAX's vmapped `build_multi_run_epoch_fn` on the same stacked
  numpy parameters, shuffle off, dropout 0: 2e-4 on parameters, BN state,
  Adam moments and the loss (two fp32 programs summing in different
  orders), the accuracy to 1e-6, Adam's `count` exactly.
- The batched eval against JAX's `build_multi_run_eval_fn`: 1e-5.
- Run r of a rho sweep with dropout against its solo `Trainer.fit`: bit
  for bit (one torch thread; see `train/multi_run.py`).
- Dropout > 0 between the packages: seed-mean test accuracy
  (`test_dropout_seed_mean_accuracy_vs_jax` states its margin).
- `train-multi` through both packages' CLIs on numpy-written artifacts.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_using_robust_nn_tpu.cli.main import main as jmain
from asr_using_robust_nn_tpu.constraints.engine import (
    make_simple_norm_constraint as jmake)
from asr_using_robust_nn_tpu.models import mlp as jmlp
from asr_using_robust_nn_tpu.train import multi_run as jmr
from asr_using_robust_nn_tpu.train.trainer import (
    TrainConfig as JTrainConfig, adam_optimizer as jadam)
from asr_using_robust_nn_tpu_torch.cli.main import main
from asr_using_robust_nn_tpu_torch.constraints import (
    make_simple_norm_constraint)
from asr_using_robust_nn_tpu_torch.models.convert import (
    adam_state_from_numpy, adam_state_to_numpy, cstate_from_numpy,
    params_from_numpy, params_to_numpy)
from asr_using_robust_nn_tpu_torch.models.mlp import MLPConfig, init_mlp
from asr_using_robust_nn_tpu_torch.parallel.mesh import pad_to_multiple
from asr_using_robust_nn_tpu_torch.train import multi_run as mr
from asr_using_robust_nn_tpu_torch.train.trainer import (
    TrainConfig, Trainer, _tree_leaves, _tree_map, adam_optimizer)

from conftest import blobs_task

CPU = torch.device("cpu")
KW = dict(in_dim=24, n_classes=4, hidden=(16, 8), dropout=(0.0, 0.0),
          nonneg=True)
BS = 64


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: a `torch.bmm` slice is then the `torch.mm` of a solo
    program bit for bit, and the file keeps near its solo time under the
    suite's worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy(n, n_val, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 24)).astype(np.float32)
    y = rng.integers(0, 4, n).astype(np.int64)
    x[np.arange(n), y] += 2.0
    xv = rng.standard_normal((n_val, 24)).astype(np.float32)
    yv = rng.integers(0, 4, n_val).astype(np.int64)
    xv[np.arange(n_val), yv] += 2.0
    return x, y, xv, yv


def _jax_init(jcfg, seeds, cinit):
    """JAX's stacked initial trees as numpy: (params, state, u)."""
    st = jmr.init_multi_run_state(jcfg, jadam(1e-3), seeds, cinit)
    p, s = jax.tree_util.tree_map(np.asarray, (st[0], st[1]))
    return st, p, s, jax.tree_util.tree_map(np.asarray, st[3])


def _port_state(p_np, s_np, u_np, n_runs):
    params, state = params_from_numpy(p_np, s_np, device="cpu")
    zeros = jax.tree_util.tree_map(np.zeros_like, p_np)
    opt = adam_state_from_numpy(np.zeros(n_runs, np.int32), zeros, zeros,
                                device="cpu")
    return params, state, opt, cstate_from_numpy(u_np, device="cpu")


@pytest.mark.parametrize("sweep", ["fixed", "rhos"])
def test_batched_epoch_matches_jax_vmapped_epoch(sweep):
    """Three runs, two epochs a call, a frozen middle run: the batched plain
    epoch against JAX's vmapped epoch (fixed constraint, or one rho a run)."""
    jcfg, cfg = jmlp.MLPConfig(**KW), MLPConfig(**KW)
    x, y, _, _ = _toy(300, 8)
    d, n_true = pad_to_multiple(x, BS)
    lab, _ = pad_to_multiple(y, BS)
    seeds, rhos = [3, 7, 11], np.asarray([0.5, 1.0, 2.0], np.float32)
    jcon = jmake(rho=1.0)
    jst, p_np, s_np, u_np = _jax_init(jcfg, seeds, jcon.init)
    act = np.asarray([True, False, True])
    if sweep == "fixed":
        jkw, kw, r_arg = dict(constraint=jcon.apply), dict(
            constraint=make_simple_norm_constraint(rho=1.0).apply), None
    else:
        jkw = dict(constraint_factory=jmake)
        kw = dict(constraint_factory=make_simple_norm_constraint)
        r_arg = rhos
    jfn = jmr.build_multi_run_epoch_fn(jcfg, jadam(1e-3), batch_size=BS,
                                       shuffle=False, epochs_per_call=2,
                                       **jkw)
    jp, js, jo, jc, jl, ja = jfn(
        *jst[:4], jnp.asarray(d), jnp.asarray(lab, jnp.int32), jst[4],
        jst[5], jnp.asarray(act), None if r_arg is None else
        jnp.asarray(r_arg), n_true)
    fn = mr.build_multi_run_epoch_fn(cfg, adam_optimizer(1e-3),
                                     batch_size=BS, shuffle=False,
                                     epochs_per_call=2, **kw)
    p2, s2, o2, c2, ml, ma = fn(
        *_port_state(p_np, s_np, {"u": u_np["u"]}, 3), torch.from_numpy(d),
        torch.from_numpy(lab), [None] * 3, None, act, r_arg, n_true)
    tol = dict(atol=2e-4, rtol=0)
    got_p, got_s = params_to_numpy(p2, s2)
    for a, b in zip(jax.tree_util.tree_leaves((got_p, got_s)),
                    jax.tree_util.tree_leaves((jp, js))):
        np.testing.assert_allclose(a, np.asarray(b), **tol)
    count, mu, nu = adam_state_to_numpy(o2)
    np.testing.assert_array_equal(count, np.asarray(jo[0].count))
    assert count.tolist() == [10, 0, 10]  # 5 steps x 2 epochs, run 1 frozen
    for a, b in zip(jax.tree_util.tree_leaves((mu, nu)),
                    jax.tree_util.tree_leaves((jo[0].mu, jo[0].nu))):
        np.testing.assert_allclose(a, np.asarray(b), **tol)
    np.testing.assert_allclose(c2["u"].numpy(), np.asarray(jc["u"]), **tol)
    # the frozen run: carried over bit for bit; its metrics read NaN here
    # (JAX computes and discards them)
    np.testing.assert_array_equal(got_p["layers"][0]["w"][1],
                                  p_np["layers"][0]["w"][1])
    assert np.isnan(ml[1].item()) and np.isnan(ma[1].item())
    np.testing.assert_allclose(ml.numpy()[[0, 2]], np.asarray(jl)[[0, 2]],
                               **tol)
    np.testing.assert_allclose(ma.numpy()[[0, 2]], np.asarray(ja)[[0, 2]],
                               atol=1e-6)


def test_batched_eval_matches_jax():
    """Stacked trained-looking parameters (JAX init, moved BN statistics),
    a val split that is not a multiple of the eval batch."""
    jcfg, cfg = jmlp.MLPConfig(**KW), MLPConfig(**KW)
    _, _, xv, yv = _toy(8, 50)
    _, p_np, s_np, _ = _jax_init(jcfg, [1, 2, 3], None)
    rng = np.random.default_rng(4)
    for lay in s_np["layers"]:
        if "mean" in lay:
            lay["mean"] = rng.uniform(0, 1, lay["mean"].shape).astype(
                np.float32)
            lay["var"] = rng.uniform(0.5, 2, lay["var"].shape).astype(
                np.float32)
    d, _ = pad_to_multiple(xv, 16)
    lab, _ = pad_to_multiple(yv, 16)
    jl, ja = jmr.build_multi_run_eval_fn(jcfg, batch_size=16)(
        p_np, s_np, jnp.asarray(d), jnp.asarray(lab, jnp.int32), 50)
    params, state = params_from_numpy(p_np, s_np, device="cpu")
    vl, va = mr.build_multi_run_eval_fn(cfg, batch_size=16)(
        params, state, torch.from_numpy(d), torch.from_numpy(lab), 50)
    np.testing.assert_allclose(vl.numpy(), np.asarray(jl), atol=1e-5)
    np.testing.assert_allclose(va.numpy(), np.asarray(ja), atol=1e-5)


def test_batched_runs_equal_solo_fits_with_dropout():
    """A rho sweep at dropout 0.1 with shuffling and early stopping on: each
    run of the batched plain `fit_multi_run` equals the solo
    `Trainer.fit(device_resident=True)` of its seed and rho, bit for bit."""
    cfg = MLPConfig(**dict(KW, dropout=(0.1, 0.1)))
    x, y, xv, yv = _toy(300, 80)
    seeds, rhos = [5, 5, 9], [0.5, 2.0, 1.0]
    tcfg = TrainConfig(batch_size=BS, epochs=6, patience=2,
                       device_resident=True, epochs_per_dispatch=2,
                       epoch_backend="plain")
    res = mr.fit_multi_run(cfg, tcfg, x, y, xv, yv, seeds, rhos=rhos,
                           constraint_factory=make_simple_norm_constraint,
                           device="cpu")
    p0, _ = init_mlp(cfg, torch.Generator().manual_seed(0), device="cpu")
    for r, (seed, rho) in enumerate(zip(seeds, rhos)):
        con = make_simple_norm_constraint(rho)
        out = Trainer(cfg, dataclasses.replace(tcfg, seed=seed),
                      constraint=con.apply, constraint_state=con.init(p0),
                      device="cpu").fit(x, y, xv, yv)
        assert res["epochs_run"][r] == out["epochs_run"]
        for k in ("loss", "val_loss"):
            np.testing.assert_array_equal(
                res["history"][k][:, r][:len(out["history"][k])].astype(
                    np.float64), np.asarray(out["history"][k]))
        for k in ("params", "best_params", "opt_state"):
            for a, b in zip(_tree_leaves(_tree_map(lambda t: t[r], res[k])),
                            _tree_leaves(out[k])):
                assert torch.equal(a, b), (r, k)


def _fit_both(dropout, seeds, x, y, xv, yv, monkeypatch):
    """Both packages' `fit_multi_run` (JAX xla, the port's plain) from JAX's
    stacked initial parameters, shuffle off -> the best parameters of
    each, as numpy trees."""
    kw = dict(in_dim=x.shape[1], n_classes=4, hidden=(32, 16),
              dropout=(dropout, 0.0), nonneg=True)
    jcfg, cfg = jmlp.MLPConfig(**kw), MLPConfig(**kw)
    tkw = dict(batch_size=BS, epochs=30, patience=30, device_resident=True,
               epochs_per_dispatch=10, shuffle=False)
    jcon = jmake(rho=2.0)
    _, p_np, s_np, u_np = _jax_init(jcfg, seeds, jcon.init)
    jres = jmr.fit_multi_run(jcfg, JTrainConfig(**tkw), x, y, xv, yv, seeds,
                             constraint=jcon.apply, constraint_init=jcon.init,
                             epoch_backend="xla")

    port_init = mr.init_multi_run_state

    def init_from_jax(model_cfg, optimizer, run_seeds, constraint_init=None,
                      mesh=None, device=None):
        keys = port_init(model_cfg, optimizer, run_seeds, constraint_init,
                         device=device)[4:]
        return (*_port_state(p_np, s_np, {"u": u_np["u"]}, len(seeds)),
                *keys)

    monkeypatch.setattr(mr, "init_multi_run_state", init_from_jax)
    con = make_simple_norm_constraint(rho=2.0)
    res = mr.fit_multi_run(cfg, TrainConfig(**tkw), x, y, xv, yv, seeds,
                           constraint=con.apply, constraint_init=con.init,
                           epoch_backend="plain", device="cpu")
    monkeypatch.undo()
    jbest = jax.tree_util.tree_map(np.asarray, (jres["best_params"],
                                                jres["best_state"]))
    return cfg, jbest, params_to_numpy(res["best_params"], res["best_state"])


def _test_accuracy(cfg, best, xt, yt):
    """Per-run test accuracy of stacked numpy trees, by one evaluator."""
    params, state = params_from_numpy(*best, device="cpu")
    d, _ = pad_to_multiple(xt, 64)
    lab, _ = pad_to_multiple(yt, 64)
    _, acc = mr.build_multi_run_eval_fn(cfg, batch_size=64)(
        params, state, torch.from_numpy(d), torch.from_numpy(lab), len(xt))
    return acc.numpy().astype(np.float64)


def test_dropout_seed_mean_accuracy_vs_jax(monkeypatch):
    """Dropout 0.1 on the first hidden block of a small constrained MLP,
    trained by each package's `fit_multi_run` from the same initial
    parameters on the same numpy split (6 seeds, shuffle off, so the
    dropout draws are the one thing the packages do not share: threefry
    against torch's generator). The seed-mean test accuracies must agree
    within a margin derived from the per-seed spread:

        margin = 4 * s * sqrt(2 / n),

    s the pooled standard deviation of the per-seed test accuracies of the
    two packages, n the number of seeds: sqrt(2 / n) * s is the standard
    error of a difference of two n-seed means whose seeds scatter as the
    runs of either package scatter, and 4 of them leave a false alarm
    under 1e-4 for normal scatter. The margin is floored at 2 test rows
    (accuracy moves in steps of 1 / n_test). The same test at dropout 0
    (identical draws: none) must agree within 1 test row on every seed,
    which shows that the margin is about the draws and not the programs."""
    rng = np.random.default_rng(3)
    x, y = blobs_task(rng, n=1400, d=20, k=4, noise=2.4, spread=1.0)
    y = y.astype(np.int64)
    tr, va, te = slice(0, 800), slice(800, 1000), slice(1000, 1400)
    seeds = [0, 1, 2, 3, 4, 5]
    n_test = te.stop - te.start
    accs = {}
    for dropout in (0.1, 0.0):
        cfg, jbest, pbest = _fit_both(dropout, seeds, x[tr], y[tr], x[va],
                                      y[va], monkeypatch)
        accs[dropout] = (_test_accuracy(cfg, jbest, x[te], y[te]),
                         _test_accuracy(cfg, pbest, x[te], y[te]))
    (ja, pa), (j0, p0) = accs[0.1], accs[0.0]
    n = len(seeds)
    s = np.sqrt((ja.var(ddof=1) + pa.var(ddof=1)) / 2)
    margin = max(4 * s * np.sqrt(2 / n), 2 / n_test)
    gap = abs(ja.mean() - pa.mean())
    print(f"dropout 0.1: JAX {ja.round(4).tolist()}, port "
          f"{pa.round(4).tolist()}, mean gap {gap:.4f}, margin {margin:.4f} "
          f"(s {s:.4f}); dropout 0: JAX {j0.round(4).tolist()}, port "
          f"{p0.round(4).tolist()}")
    assert 0.4 < pa.mean() < 0.97  # neither chance nor saturated
    assert gap <= margin, (gap, margin)
    assert np.abs(j0 - p0).max() <= 1 / n_test + 1e-9, (j0, p0)


# -- the train-multi command -------------------------------------------------------

def _write_artifacts(out, sizes=(48, 16, 16), width=880, n_classes=3,
                     seed=5):
    """The six .npy files of `prepare-data`, written with numpy."""
    rng = np.random.default_rng(seed)
    means = 0.3 * rng.standard_normal((n_classes, width))
    out.mkdir()
    for name, n in zip(("train", "dev", "test"), sizes):
        lab = rng.integers(0, n_classes, n).astype(np.int32)
        np.save(out / f"{name}_data.npy", means[lab]
                + rng.standard_normal((n, width)))
        np.save(out / f"{name}_label.npy", lab)
    return out


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    return _write_artifacts(tmp_path_factory.mktemp("tm") / "processed")


def _multi(fn, art, ck, *extra):
    return fn(["train-multi", "--task", "digit", "--variant", "constrained",
               "--constraint", "simple", "--data", str(art), "--ckpt",
               str(ck), "--epochs", "2", "--epochs-per-dispatch", "2",
               "--batch-size", "8", "--patience", "4", *extra])


def test_train_multi_grid_matches_jax_command(artifacts, tmp_path, capsys):
    """A 2 seeds x 2 rhos grid through both packages' `train-multi`: the
    same run directories and JSON keys; every port store loads through the
    port's `evaluate`, and the stronger rho gives the smaller product
    norm."""
    grid = ["--seeds", "0,1", "--rhos", "0.1,5.0"]
    assert _multi(jmain, artifacts, tmp_path / "j", *grid) == 0
    jout = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert _multi(main, artifacts, tmp_path / "p", *grid, "--device",
                  "cpu") == 0
    text = capsys.readouterr().out
    out = json.loads(text.strip().splitlines()[-1])
    assert sorted(out) == sorted(jout) == ["fused_dispatches", "n_runs",
                                           "runs"]
    assert out["n_runs"] == jout["n_runs"] == 4
    assert out["fused_dispatches"] == jout["fused_dispatches"] == 1
    for r, jr in zip(out["runs"], jout["runs"]):
        assert sorted(r) == sorted(jr)
        assert (r["seed"], r["rho"]) == (jr["seed"], jr["rho"])
        assert os.path.basename(r["ckpt"]) == os.path.basename(jr["ckpt"])
        assert r["epochs_run"] == jr["epochs_run"] == 2
    assert [os.path.basename(r["ckpt"]) for r in out["runs"]] == [
        "run0_seed0_rho0.1", "run1_seed0_rho5", "run2_seed1_rho0.1",
        "run3_seed1_rho5"]
    assert "run 3 seed=1 rho=5.0" in text
    from conftest import product_norm_oracle

    from asr_using_robust_nn_tpu_torch.cli.main import (load_model,
                                                        model_cfg_for)

    cfg = model_cfg_for("digit", "constrained")
    norms = []
    for r in out["runs"]:
        assert main(["evaluate", "--task", "digit", "--variant",
                     "constrained", "--data", str(artifacts), "--ckpt",
                     r["ckpt"], "--device", "cpu"]) == 0
        ev = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert abs(ev["test_accuracy"] - r["test_accuracy"]) <= 1e-6
        p, _ = load_model(r["ckpt"], cfg)
        norms.append(product_norm_oracle([lay["w"] for lay in p["layers"]]))
    assert norms[0] < norms[1] and norms[2] < norms[3], norms


def test_train_multi_fused_backend_at_one_rho(artifacts, tmp_path,
                                                       capsys):
    """`--epoch-backend fused` (K3's twin on the CPU) at one rho: one store a
    seed under the JAX command's names, and the fused backend refuses a rho
    sweep with exit 2."""
    assert _multi(main, artifacts, tmp_path / "f", "--seeds", "3,4",
                  "--epoch-backend", "fused", "--batch-size", "64",
                  "--device", "cpu") == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [os.path.basename(r["ckpt"]) for r in out["runs"]] == [
        "run0_seed3_rho0.1", "run1_seed4_rho0.1"]
    assert all(os.path.exists(os.path.join(r["ckpt"], "best.npz"))
               for r in out["runs"])
    assert _multi(main, artifacts, tmp_path / "g", "--seeds", "3",
                  "--rhos", "0.1,0.2", "--epoch-backend", "fused",
                  "--device", "cpu") == 2
    assert "fused" in capsys.readouterr().err


@pytest.mark.parametrize("argv, needle", [
    (["--seeds", "a,b"], "comma-separated ints"),
    (["--seeds", ""], "empty"),
    (["--seeds", "0", "--rhos", "x"], "comma-separated floats"),
    (["--seeds", "0", "--rhos", "0.1", "--variant", "unconstrained"],
     "constrained"),
])
def test_train_multi_argument_errors(argv, needle, artifacts, capsys):
    """The JAX command's exit-2 argument errors (tests/test_cli.py)."""
    base = ["train-multi", "--task", "digit", "--data", str(artifacts),
            "--ckpt", "/nonexistent/x"]
    assert main(base + argv + ["--device", "cpu"]) == 2
    assert needle in capsys.readouterr().err
    assert jmain(base + argv) == 2
    assert needle in capsys.readouterr().err


def test_train_multi_runs_mesh_as_one_process(artifacts, tmp_path, capsys):
    """`--runs-mesh` as one process: a one-rank mesh holding every run, the
    stores and results of the plain command bit for bit; with the fused
    backend it exits 2. tests/test_torch_distributed.py splits the runs
    over 2 ranks."""
    base = ["train-multi", "--task", "digit", "--data", str(artifacts),
            "--seeds", "1,2", "--epochs", "2", "--batch-size", "64",
            "--device", "cpu"]
    assert main(base + ["--ckpt", str(tmp_path / "a")]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert main(base + ["--ckpt", str(tmp_path / "b"), "--runs-mesh"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for g, w in zip(got["runs"], want["runs"]):
        assert {k: v for k, v in g.items() if k != "ckpt"} == {
            k: v for k, v in w.items() if k != "ckpt"}
        assert os.path.basename(g["ckpt"]) == os.path.basename(w["ckpt"])
    assert main(base + ["--ckpt", str(tmp_path / "c"), "--runs-mesh",
                        "--epoch-backend", "fused"]) == 2
    assert "--runs-mesh" in capsys.readouterr().err


def test_train_multi_needs_artifacts(tmp_path, capsys):
    assert main(["train-multi", "--task", "digit", "--data", str(tmp_path),
                 "--ckpt", str(tmp_path / "ck"), "--seeds", "0",
                 "--device", "cpu"]) == 2
    assert "prepare-data" in capsys.readouterr().err
