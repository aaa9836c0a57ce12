"""The port's fused epoch (asr_using_robust_nn_tpu_torch/ops/cuda_train.py)
against the JAX package's Pallas epoch kernel run in interpret mode on the
CPU: the packed state, K3's plain twin `fused_epoch_plain`, the dropout hash,
the parity check and the trainer's backend choice.

States cross between the packages with `models/convert.py`; inputs are
seeded numpy arrays given to both. K3 itself runs only on a card and is held
against the twin by `chip_smoke.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_using_robust_nn_tpu.models import mlp as jmlp
from asr_using_robust_nn_tpu.ops import pallas_train as jpt
from asr_using_robust_nn_tpu_torch.constraints import (
    make_simple_norm_constraint)
from asr_using_robust_nn_tpu_torch.models import mlp
from asr_using_robust_nn_tpu_torch.models.convert import (
    adam_state_to_numpy, fstate_from_numpy, fstate_to_numpy,
    params_from_numpy)
from asr_using_robust_nn_tpu_torch.ops import cuda_train as ct
from asr_using_robust_nn_tpu_torch.parallel.mesh import pad_to_multiple
from asr_using_robust_nn_tpu_torch.train.trainer import (
    TrainConfig, Trainer, adam_optimizer)

from conftest import blobs_task

KW = dict(in_dim=20, n_classes=4, hidden=(32, 16), nonneg=True,
          dropout=(0.0, 0.0))


def _specs(rho=0.5, batch=64, pallas_relu_mask=False, **kw):
    cfg_kw = dict(KW, **kw)
    jspec = jpt.FusedStepSpec(cfg=jmlp.MLPConfig(**cfg_kw), batch=batch,
                              rho=rho, pi_iters=8, interpret=True)
    spec = ct.FusedStepSpec(cfg=mlp.MLPConfig(**cfg_kw), batch=batch,
                            rho=rho, pi_iters=8,
                            pallas_relu_mask=pallas_relu_mask)
    return jspec, spec


def _jax_init(jspec, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jmlp.init_mlp(jspec.cfg, jax.random.PRNGKey(seed)))


def _epoch_inputs(rng, spec, n_batches, ragged=0):
    """(xs, ys, ws, seeds) as numpy: feature-padded batches, the last
    `ragged` rows of the last batch weighted 0 and filled with poison."""
    B, pd0 = spec.batch, spec.pdims[0]
    x, y = blobs_task(rng, n=n_batches * B, d=spec.dims[0],
                      k=spec.dims[-1])
    xs = np.zeros((n_batches, B, pd0), np.float32)
    xs[..., : spec.dims[0]] = x.reshape(n_batches, B, -1)
    ws = np.ones((n_batches, B, 1), np.float32)
    if ragged:
        ws[-1, -ragged:] = 0.0
        xs[-1, -ragged:, : spec.dims[0]] = 1e3
    ys = y.reshape(n_batches, B, 1).astype(np.int32)
    seeds = rng.integers(0, 2 ** 31 - 1, n_batches).astype(np.int32)
    return xs, ys, ws, seeds


def _run_both(jspec, spec, fs_np, xs, ys, ws, seeds):
    jrun = jpt.build_fused_epoch_call(jspec, xs.shape[0])
    jfs, jl, ja = jrun(jax.tree_util.tree_map(jnp.asarray, fs_np),
                       jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(ws),
                       jnp.asarray(seeds))
    run = ct.build_fused_epoch_call(spec, xs.shape[0])
    fs, losses, accs = run(fstate_from_numpy(fs_np, device="cpu"),
                           *(torch.from_numpy(a) for a in (xs, ys, ws, seeds)))
    return (jax.tree_util.tree_map(np.asarray, jfs), np.asarray(jl),
            np.asarray(ja), fs, losses.numpy(), accs.numpy())


def test_pack_unpack_round_trip_matches_jax():
    jspec, spec = _specs()
    jp, js = _jax_init(jspec, seed=1)
    rng = np.random.default_rng(1)
    for p, s in zip(jp["layers"][:-1], js["layers"][:-1]):
        p["gamma"] = (0.5 + rng.random(p["b"].shape)).astype(np.float32)
        p["beta"] = rng.standard_normal(p["b"].shape).astype(np.float32)
        s["mean"] = rng.random(p["b"].shape).astype(np.float32)
    jfs = jax.tree_util.tree_map(np.asarray, jpt.pack_state(jspec, jp, js))
    params, state = params_from_numpy(jp, js, device="cpu")
    fs = ct.pack_state(spec, params, state)
    got = fstate_to_numpy(fs)
    for k in ("masters", "w16", "mw", "vw"):
        for a, b in zip(got[k], jfs[k]):
            np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    for k in jfs["small"]:
        np.testing.assert_array_equal(got["small"][k], jfs["small"][k])
    np.testing.assert_array_equal(got["scales"], jfs["scales"])
    np.testing.assert_array_equal(got["count"], jfs["count"])
    assert got["u"].shape == jfs["u"].shape  # drawn anew; crosses by convert
    # unpack from a JAX-packed state carried across, scales folded
    jfs["scales"] = np.asarray(jfs["scales"]).copy()
    jfs["scales"][0, :3] = (0.5, 2.0, 0.25)
    fs = fstate_from_numpy(jfs, device="cpu")
    pp, ss = ct.unpack_params(spec, fs)
    jpp, jss = jpt.unpack_params(jspec, jax.tree_util.tree_map(jnp.asarray,
                                                               jfs))
    for a, b in zip(jax.tree_util.tree_leaves((pp, ss)),
                    jax.tree_util.tree_leaves((jpp, jss))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_unpack_opt_state_matches_jax():
    jspec, spec = _specs()
    jp, js = _jax_init(jspec, seed=2)
    jfs = jax.tree_util.tree_map(np.asarray, jpt.pack_state(jspec, jp, js))
    rng = np.random.default_rng(2)
    jfs["mw"] = tuple(rng.standard_normal(a.shape).astype(np.float32)
                      for a in jfs["mw"])
    jfs["vw"] = tuple(rng.random(a.shape).astype(np.float32)
                      for a in jfs["vw"])
    jfs["small"] = {k: rng.random(v.shape).astype(np.float32)
                    for k, v in jfs["small"].items()}
    jfs["count"] = np.array([7], np.int32)
    from asr_using_robust_nn_tpu.train.trainer import (
        adam_optimizer as jadam)

    jfs_j = jax.tree_util.tree_map(jnp.asarray, jfs)
    jpp, _ = jpt.unpack_params(jspec, jfs_j)
    jo = jpt.unpack_opt_state(jspec, jfs_j, jadam(1e-3), jpp)[0]
    fs = fstate_from_numpy(jfs, device="cpu")
    pp, _ = ct.unpack_params(spec, fs)
    count, mu, nu = adam_state_to_numpy(
        ct.unpack_opt_state(spec, fs, adam_optimizer(1e-3), pp))
    assert int(count) == int(jo.count) == 7
    for a, b in zip(jax.tree_util.tree_leaves((mu, nu)),
                    jax.tree_util.tree_leaves((jo.mu, jo.nu))):
        np.testing.assert_array_equal(a, np.asarray(b))


def _steady_inputs(rng, spec, n_batches, prototypes=4, noise=1e-3):
    """(xs, ys, ws, seeds) of steady-tone-like rows: a few distinct rows,
    each repeated with small noise (its class its label), so that a unit's
    activations cluster and the ReLU thresholds are hit often."""
    B, pd0, d = spec.batch, spec.pdims[0], spec.dims[0]
    protos = rng.normal(0.0, 1.0, (prototypes, d))
    which = rng.integers(0, prototypes, n_batches * B)
    x = protos[which] + noise * rng.standard_normal((n_batches * B, d))
    xs = np.zeros((n_batches, B, pd0), np.float32)
    xs[..., :d] = x.reshape(n_batches, B, d)
    ys = (which % spec.dims[-1]).reshape(n_batches, B, 1).astype(np.int32)
    ws = np.ones((n_batches, B, 1), np.float32)
    seeds = rng.integers(0, 2 ** 31 - 1, n_batches).astype(np.int32)
    return xs, ys, ws, seeds


@pytest.mark.parametrize("bn, rows", [
    pytest.param(True, "blobs", id="True"),
    pytest.param(False, "blobs", id="False"),
    pytest.param(True, "steady", id="True-steady"),
    pytest.param(False, "steady", id="False-steady")])
def test_fused_epoch_plain_matches_jax_interpret(bn, rows):
    """Two steps at rho 0.5, dropout 0, from one JAX-packed state (u
    included) on identical batches, with the Pallas kernel's ReLU mask, on
    Gaussian blobs and on steady-tone-like rows (a few distinct rows
    repeated with small noise, so that whole clusters of rows sit at a
    unit's ReLU threshold). Bounds are the JAX suite's grid-vs-scan ones:
    two bf16-class programs whose fp32 sums run in different orders, where
    early Adam turns O(1e-7) gradient noise into a full +-lr step wherever
    |g| is near zero. The BN running statistics, mean and variance, are held
    at 1e-4.

    On the steady rows each step starts from the JAX kernel's state after
    the step before (two one-step calls), where both agree to 3e-8. Run as
    one two-step call they agree after the first step to 2e-8 and after the
    second part by 0.13 in a first moment: on clustered rows a last-bit
    difference moves whole clusters across a ReLU threshold. The Pallas
    epoch parts from itself by 0.33 there when its two steps run as two
    calls instead of one (its bf16 weights then start as a fresh cast of
    the masters, not as the rescaled copies), so only each step's
    arithmetic is held on these rows."""
    rng = np.random.default_rng(3)
    jspec, spec = _specs(batch_norm=bn, pallas_relu_mask=True)
    jp, js = _jax_init(jspec, seed=3)
    fs_np = jax.tree_util.tree_map(np.asarray, jpt.pack_state(jspec, jp, js))
    make = _epoch_inputs if rows == "blobs" else _steady_inputs
    xs, ys, ws, seeds = make(rng, spec, 2)
    chunk = 2 if rows == "blobs" else 1
    for k in range(0, 2, chunk):
        part = (a[k:k + chunk] for a in (xs, ys, ws, seeds))
        jfs, jl, ja, fs, losses, accs = _run_both(jspec, spec, fs_np, *part)
        _hold_epoch(fstate_to_numpy(fs), losses, accs, jfs, jl, ja)
        fs_np = jfs
    assert int(fstate_to_numpy(fs)["count"][0]) == 2


def _hold_epoch(got, losses, accs, jfs, jl, ja):
    np.testing.assert_allclose(losses, jl, atol=5e-4)
    np.testing.assert_allclose(accs, ja, atol=1e-6)
    for a, b in zip(got["masters"], jfs["masters"]):
        np.testing.assert_allclose(a, b, atol=2.5e-3)
    for a, b in zip(got["w16"], jfs["w16"]):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), atol=2.5e-3)
    np.testing.assert_allclose(got["small"]["b"], jfs["small"]["b"],
                               atol=2.5e-3)
    for k in ("mw", "vw"):
        for a, b in zip(got[k], jfs[k]):
            np.testing.assert_allclose(a, b, atol=1e-3)
    for k in ("m_b", "v_b", "m_gamma", "v_gamma", "m_beta", "v_beta"):
        np.testing.assert_allclose(got["small"][k], jfs["small"][k],
                                   atol=1e-3)
    for k in ("rmean", "rvar"):
        np.testing.assert_allclose(got["small"][k], jfs["small"][k],
                                   atol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["u"], jfs["u"], atol=5e-3)
    np.testing.assert_array_equal(got["count"], jfs["count"])


def test_relu_mask_blocks_dead_units():
    """The default mask gives a dead unit (a = 0) no gradient; the Pallas
    kernel's mask (x^ in bf16 against the fp32 threshold) lets some through.
    One BN layer: dz must vanish wherever the forward ReLU output is 0."""
    spec = ct.FusedStepSpec(cfg=mlp.MLPConfig(**dict(KW, hidden=(32,))),
                            batch=64)
    ops = ct._PlainOps(spec)
    rng = np.random.default_rng(8)
    a = torch.from_numpy(np.maximum(rng.standard_normal((64, 128)), 0.0)
                         .astype(np.float32))
    a[:, 32:] = 0.0
    w = torch.ones(64)
    denom = torch.tensor([64.0 + 1e-9])
    sm = {k: torch.zeros((2, 128)) for k in ct._SMALL_KEYS}
    sm["gamma"][0] = 1.0
    muvec, sdvec = torch.zeros(128), torch.zeros(128)
    xhat = torch.empty((64, 128), dtype=torch.bfloat16)
    act = torch.empty((64, 128), dtype=torch.bfloat16)
    seeds = torch.zeros(1, dtype=torch.int32)
    ops.bn_fwd(0, a, w, denom, sm, muvec, sdvec, xhat, act, seeds, 0)
    dD = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))
    dead = (a[:, :32] == 0)
    leaks = []
    for pallas in (False, True):
        spec_k = ct.FusedStepSpec(cfg=spec.cfg, batch=64,
                                  pallas_relu_mask=pallas)
        dzb = torch.empty((64, 128), dtype=torch.bfloat16)
        ct._PlainOps(spec_k).bn_bwd(
            0, dD, xhat, w, denom, {k: v.clone() for k, v in sm.items()},
            muvec, sdvec, dzb, seeds, 0, torch.zeros(1, dtype=torch.int32))
        leaks.append(int((dzb[:, :32].float()[dead] != 0).sum()))
    assert dead.sum() > 100
    assert leaks[0] == 0
    assert leaks[1] > 0  # the reference kernel's leak this default avoids


def test_ragged_rows_are_masked():
    """A batch whose last 16 rows carry weight 0 and poison values gives the
    same loss and update as the same batch with harmless weight-0 rows."""
    rng = np.random.default_rng(4)
    _, spec = _specs(rho=None)
    xs, ys, ws, seeds = _epoch_inputs(rng, spec, 1, ragged=16)
    params, state = mlp.init_mlp(spec.cfg, torch.Generator().manual_seed(4),
            device="cpu")
    fs0 = ct.pack_state(spec, params, state)
    run = ct.build_fused_epoch_call(spec, 1)
    clean = xs.copy()
    clean[0, -16:] = clean[0, :16]
    outs = [run(fs0, *(torch.from_numpy(a) for a in (x, ys, ws, seeds)))
            for x in (xs, clean)]
    assert abs(float(outs[0][1][0, 0]) - float(outs[1][1][0, 0])) < 1e-5
    for a, b in zip(outs[0][0]["masters"], outs[1][0]["masters"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
    assert torch.isfinite(outs[0][0]["masters"][0]).all()


def test_fused_epoch_fn_pads_batches_to_whole_tiles():
    """A batch of 40 rows runs as 64 rows, 24 of weight 0 (K3 works on
    64-row tiles): the epoch equals the twin's at 40 rows on the same
    batches and dropout seeds, dropout on."""
    rng = np.random.default_rng(9)
    _, spec = _specs(batch=40, dropout=(0.2, 0.2))
    x, y = blobs_task(rng, n=80, d=20, k=4)
    params, state = mlp.init_mlp(spec.cfg, torch.Generator().manual_seed(9),
            device="cpu")
    fs0 = ct.pack_state(spec, params, state)
    data = ct.pad_features(spec, torch.from_numpy(x))
    labels = torch.from_numpy(y.astype(np.int64))
    ep = ct.build_fused_epoch_fn(spec, shuffle=False)
    fs, loss, acc = ep(fs0, data, labels, None,
                       torch.Generator().manual_seed(1), 80)
    seeds = torch.randint(0, 2 ** 31 - 1, (2,), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(1))
    fs2, l2, a2 = ct.fused_epoch_plain(
        spec, fs0, data.reshape(2, 40, -1), labels.reshape(2, 40, 1),
        torch.ones((2, 40, 1)), seeds)
    assert abs(float(loss) - float(l2.mean())) < 1e-6
    assert abs(float(acc) - float(a2.mean())) < 1e-6
    for k in ("masters", "mw", "vw"):
        for a, b in zip(fs[k], fs2[k]):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    for k in ct._SMALL_KEYS:
        torch.testing.assert_close(fs["small"][k], fs2["small"][k],
                                   atol=1e-6, rtol=0)
    assert int(fs["count"][0]) == 2


def test_k3_refuses_the_pallas_relu_mask():
    """The reference's leaky mask runs only in the twin; K3's operations
    refuse it before touching the card."""
    _, spec = _specs(pallas_relu_mask=True)
    with pytest.raises(ValueError, match="pallas_relu_mask"):
        ct._CudaOps(spec)


def test_dropout_hash_deterministic_and_at_rate():
    seed = torch.tensor(123456789, dtype=torch.int32)
    a = ct.dropout_keep(seed, 1, 1000, 1000, 0.9)
    b = ct.dropout_keep(seed.reshape(1), 1, 1000, 1000, 0.9)
    assert torch.equal(a, b)
    assert abs(a.float().mean().item() - 0.9) < 0.01
    # another layer or seed draws another mask, at the same rate
    c = ct.dropout_keep(seed, 2, 1000, 1000, 0.9)
    assert (a != c).float().mean().item() > 0.1
    d = ct.dropout_keep(torch.tensor(2 ** 31 - 1, dtype=torch.int32), 0,
                        1000, 1000, 0.5)
    assert abs(d.float().mean().item() - 0.5) < 0.01


def test_dropout_in_the_twin_is_seeded():
    """With dropout on, the twin is a function of the seeds: equal seeds
    give equal states, other seeds another one."""
    rng = np.random.default_rng(5)
    _, spec = _specs(dropout=(0.3, 0.3))
    xs, ys, ws, seeds = _epoch_inputs(rng, spec, 2)
    params, state = mlp.init_mlp(spec.cfg, torch.Generator().manual_seed(5),
            device="cpu")
    fs0 = ct.pack_state(spec, params, state)
    run = ct.build_fused_epoch_call(spec, 2)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    r1 = run(fs0, t(xs), t(ys), t(ws), t(seeds))
    r2 = run(fs0, t(xs), t(ys), t(ws), t(seeds))
    r3 = run(fs0, t(xs), t(ys), t(ws), t(seeds + 1))
    assert torch.equal(r1[0]["masters"][0], r2[0]["masters"][0])
    assert not torch.equal(r1[0]["masters"][0], r3[0]["masters"][0])


def test_epoch_parity_vs_plain_ok_on_cpu():
    rng = np.random.default_rng(6)
    x, y = blobs_task(rng, n=150, d=20, k=4)
    cfg = mlp.MLPConfig(**KW)
    d, n_true = pad_to_multiple(x, 64)
    lab, _ = pad_to_multiple(y.astype(np.int64), 64)
    out = ct.epoch_parity_vs_plain(cfg, 64, torch.from_numpy(d),
                                   torch.from_numpy(lab), n_true)
    assert out["ok"], out
    assert out["max_dw"] < out["tol_param"]


def test_resolve_epoch_backend():
    cfg = mlp.MLPConfig(**KW)
    tcfg = dict(batch_size=64, device_resident=True)
    # 'auto' stays plain off a CUDA device
    tr = Trainer(cfg, TrainConfig(epoch_backend="auto", **tcfg),
                 constraint=make_simple_norm_constraint(0.5).apply,
                         device="cpu")
    assert tr._resolve_epoch_backend(fresh_opt=True) is False
    # ... and is 'fused' on a CUDA device, whatever the batch (the fused
    # epoch pads batches to whole tiles); no tensor is made here
    for bs in (64, 40):
        tr = Trainer(cfg, TrainConfig(epoch_backend="auto", batch_size=bs,
                                      device_resident=True),
                     constraint=make_simple_norm_constraint(0.5).apply,
                     device="cuda")
        assert tr._resolve_epoch_backend(fresh_opt=True) is True
        assert tr._resolve_epoch_backend(fresh_opt=False) is False
    # 'fused' refuses a projection it does not implement ...
    part = make_simple_norm_constraint(0.5, affected_layers_indices=(0,))
    tr = Trainer(cfg, TrainConfig(epoch_backend="fused", **tcfg),
                 constraint=part.apply, device="cpu")
    with pytest.raises(ValueError, match="simple_norm"):
        tr._resolve_epoch_backend(fresh_opt=True)
    # ... and a resumed Adam trajectory, which cannot pack into zero moments
    tr = Trainer(cfg, TrainConfig(epoch_backend="fused", **tcfg),
                 constraint=make_simple_norm_constraint(0.5).apply,
                         device="cpu")
    with pytest.raises(ValueError, match="fresh"):
        tr._resolve_epoch_backend(fresh_opt=False)
    assert tr._resolve_epoch_backend(fresh_opt=True) is True
    with pytest.raises(ValueError, match="epoch_backend"):
        Trainer(cfg, TrainConfig(epoch_backend="xla", **tcfg),
                device="cpu")._resolve_epoch_backend(fresh_opt=True)


def test_fused_fit_on_cpu_trains():
    """A device-resident fit with epoch_backend='fused' on the CPU runs the
    twin end to end (parity check included) and learns the blobs task."""
    rng = np.random.default_rng(7)
    x, y = blobs_task(rng, n=128, d=20, k=4)
    cfg = mlp.MLPConfig(**KW)
    con = make_simple_norm_constraint(0.5, n_iter=8)
    params, _ = mlp.init_mlp(cfg, torch.Generator().manual_seed(0),
            device="cpu")
    tr = Trainer(cfg, TrainConfig(batch_size=64, epochs=8, patience=8,
                                  device_resident=True,
                                  epoch_backend="fused"),
                 constraint=con.apply, constraint_state=con.init(params),
                         device="cpu")
    res = tr.fit(x, y, x[:64], y[:64])
    h = res["history"]
    assert h["loss"][-1] < h["loss"][0]
    assert res["opt_state"]["count"].item() == 16
    assert res["constraint_state"]["u"].shape == (4,)


# -- the launch plan of the kernels (pure Python, no card) ----------------------

PRESETS = ("digit_unconstrained", "digit_constrained",
           "speaker_unconstrained", "speaker_constrained")


@pytest.mark.parametrize("batch", [64, 512, 1024])
@pytest.mark.parametrize("preset", PRESETS)
def test_launch_plan_fits_and_covers(preset, batch):
    """Every launch of a step fits a block's shared memory and the portable
    cluster; the GEMM grids (block (x, y) computes tile row y, tile column x)
    cover each padded matrix exactly once; a batch cluster holds all the
    rows of its column tile; the depth ranks of a dW tile own disjoint,
    complete row and depth slices; K3 updates the weights in one grouped
    launch after the dX chain, K6 one launch a layer; `dims()` hands the C
    entry that launch."""
    spec = ct.FusedStepSpec(cfg=getattr(mlp.MLPConfig, preset)(), batch=batch,
                            rho=0.1)
    plan = ct.launch_plan(spec)
    assert plan["bn_in_epilogue"] == (batch <= 512)
    launches = ct.plan_launches(plan)
    m, pd = spec.n_layers, spec.pdims
    n_hidden_extra = 0 if plan["bn_in_epilogue"] else 2 * (m - 1)
    assert len(launches) == m + 1 + (m - 1) + 1 + n_hidden_extra
    assert launches[-1] is plan["dw_group"]
    per_layer = ct.plan_launches(plan, grouped=False)
    assert len(per_layer) == m + 1 + (m - 1) + m + n_hidden_extra
    assert per_layer[-m:] == plan["dw"][::-1]
    for L in per_layer + [plan["dw_group"]]:
        assert L.smem_bytes <= ct.SMEM_LIMIT == 232448
        assert 1 <= L.cluster_size <= 8
        assert all(g % c == 0 for g, c in zip(L.grid, L.cluster))
        assert list(L.dims()) == [*L.grid, *L.cluster, L.smem_bytes]
        if L.kernel == "dw_adam_group":
            assert L.grid == (min(4 * 132, L.n_tiles), 1, 1)
            continue
        if L.kernel in ("bn_fwd", "bn_bwd"):
            assert L.grid[0] * L.tile[1] == L.cols  # every column once
            continue
        if L.kernel == "ce":
            assert L.grid[0] * L.tile[0] == batch   # every row once
            continue
        assert L.tile == (64, 64, 64) and L.stages >= 3
        assert (L.grid[1] * L.tile[0], L.grid[0] * L.tile[1]) == (L.rows,
                                                                  L.cols)
        assert L.smem_bytes >= 1024 + L.stages * 2 * 64 * 128  # the ring
        assert L.bn_in_epilogue == (L.kernel in ("fwd_bn", "dx_bn"))
        if L.cluster_axis == "batch":
            assert L.cluster == (1, batch // 64, 1) and L.rows == batch
    for i, L in enumerate(plan["dw"]):
        assert (L.rows, L.cols, L.depth) == (pd[i], pd[i + 1], batch)
        assert L.cluster == (1, 1, L.grid[2]) and L.cluster_axis == "depth"
        rows = [r for a, b in L.rank_rows() for r in range(a, b)]
        assert rows == list(range(64))              # disjoint and complete
        depth = [k for a, b in L.rank_depth() for k in range(a, b)]
        assert depth == list(range(batch))
        assert all((b - a) % 64 == 0 for a, b in L.rank_depth())
    # narrow products are spread over the depth, wide ones are not
    blocks = [L.grid[0] * L.grid[1] * L.grid[2] for L in plan["dw"]]
    assert all(b >= min(128, (pd[i] // 64) * (pd[i + 1] // 64) * min(8, batch // 64))
               for i, b in enumerate(blocks))
    # a dW block holds the ring and its rows of master and moments, twice an SM
    assert all(2 * (L.smem_bytes + 1024) <= 233472 for L in plan["dw"])


@pytest.mark.parametrize("kw, match", [
    (dict(batch=40), "multiple of 64"),
    (dict(batch=0), "multiple of 64"),
    (dict(pallas_relu_mask=True), "pallas_relu_mask"),
    (dict(n_classes=600), "padded classes"),
])
def test_launch_plan_refuses_what_the_kernels_do_not_take(kw, match):
    """The refusals come from the plan, before any kernel is built."""
    _, spec = _specs(**kw)
    with pytest.raises(ValueError, match=match):
        ct.launch_plan(spec)
    with pytest.raises(ValueError, match=match):
        ct._CudaOps(spec)


class _RankOrderOps(ct._PlainOps):
    """The twin with the kernels' summation orders: column sums add 64-row
    blocks in rank order, dW adds the depth slices of the plan in rank
    order."""

    def __init__(self, spec):
        super().__init__(spec)
        self.plan = ct.launch_plan(spec)

    def colsum(self, t):
        total = torch.zeros(t.shape[1])
        for block in t.split(64):
            total = total + block.sum(0)
        return total

    def dw_product(self, i, acts, dzb):
        total = torch.zeros((acts.shape[1], dzb.shape[1]))
        for k0, k1 in self.plan["dw"][i].rank_depth():
            total = total + acts[k0:k1].float().T @ dzb[k0:k1].float()
        return total


def test_relu_mask_is_exact():
    """The twin's BN forward stores x^ so that the backward's ReLU mask (x^
    above the bf16-rounded threshold -mu * sdinv) is exactly a > 0: a live
    unit whose x^ rounds onto the threshold is stored one bf16 step above
    it (csrc/fused_epoch.cu::xhat_store); a dead unit's x^ is the
    threshold."""
    _, spec = _specs(batch=64)
    params, state = mlp.init_mlp(spec.cfg, torch.Generator().manual_seed(3),
                                 device="cpu")
    sm = ct.pack_state(spec, params, state)["small"]
    sc = ct._scratch(spec, "cpu")
    B, d = spec.batch, spec.pdims[1]
    rng = np.random.default_rng(5)
    a = np.maximum(rng.normal(0.5, 1.0, (B, d)), 0.0).astype(np.float32)
    a[:8] = 1e-6  # live, but x^ within rounding of the threshold
    a = torch.from_numpy(a)
    w = torch.ones(B)
    sc["denom"].fill_(float(B))
    xhat = torch.empty((B, d), dtype=torch.bfloat16)
    act = torch.empty((B, d), dtype=torch.bfloat16)
    ct._PlainOps(spec).bn_fwd(0, a, w, sc["denom"], sm, sc["muvec"][0],
                              sc["sdvec"][0], xhat, act,
                              torch.zeros(1, dtype=torch.int32), 0)
    mu, sd = sc["muvec"][0, :d], sc["sdvec"][0, :d]
    thr = (-mu * sd).to(torch.bfloat16).float()
    rounded = ((a - mu) * sd).to(torch.bfloat16).float()
    assert bool(((a > 0) & (rounded <= thr)).any())  # the case is exercised
    assert torch.equal(xhat.float() > thr, a > 0)
    assert torch.equal(xhat.float()[a == 0], thr.expand(B, d)[a == 0])


class _DzRecordOps(ct._PlainOps):
    """The twin in torch's order, keeping each step's bf16 dZ per layer."""

    def __init__(self, spec, dzs):
        super().__init__(spec)
        self.dzs = dzs

    def bn_bwd(self, i, dD, xhat, w, denom, sm, muvec, sdvec, dzb, seeds, s,
               count):
        super().bn_bwd(i, dD, xhat, w, denom, sm, muvec, sdvec, dzb, seeds,
                       s, count)
        self.dzs[(i, s)] = dzb.clone()


class _RankOrderTieOps(_RankOrderOps):
    """The rank-ordered twin. Where its bf16 dZ rounds differently from the
    other order's (an fp32 value near a bf16 rounding boundary), it takes
    the other order's dZ, so that one such rounding does not move every
    later sum; `ties` counts them."""

    def __init__(self, spec, dzs):
        super().__init__(spec)
        self.dzs, self.ties = dzs, 0

    def bn_bwd(self, i, dD, xhat, w, denom, sm, muvec, sdvec, dzb, seeds, s,
               count):
        super().bn_bwd(i, dD, xhat, w, denom, sm, muvec, sdvec, dzb, seeds,
                       s, count)
        ref = self.dzs[(i, s)]
        self.ties += int((dzb != ref).sum())
        dzb.copy_(ref)


@pytest.mark.parametrize("dropout", [0.0, 0.2])
def test_rank_ordered_reductions_match_the_twin(dropout):
    """Two steps of the twin with the cluster-ordered sums against the twin
    with torch's own order, batch 256 (four ranks along the batch and, for
    these one-tile layers, four along the depth). fp32 sums in another
    order differ by ~1e-7 relative; Adam turns that into at most a few
    1e-6 of a parameter, and into a +-lr step only for a gradient within
    rounding of zero, which the zero-padded entries never are. A dZ whose
    fp32 value lies near a bf16 rounding boundary may round the other way:
    such dZ must be rare (at most 1e-3 of them; a wrong reduction moves
    most), and the rank-ordered arm takes the other arm's dZ there
    (`_RankOrderTieOps`), so that one rounding does not move every later
    sum and the bars below hold the fp32 reductions."""
    rng = np.random.default_rng(11)
    _, spec = _specs(batch=256, dropout=(dropout, dropout))
    plan = ct.launch_plan(spec)
    assert [L.cluster[2] for L in plan["dw"]] == [4, 4, 4]
    assert plan["fwd"][0].cluster == (1, 4, 1)
    xs, ys, ws, seeds = _epoch_inputs(rng, spec, 2, ragged=16)
    params, state = mlp.init_mlp(spec.cfg, torch.Generator().manual_seed(11),
                                 device="cpu")
    fs0 = ct.pack_state(spec, params, state)
    args = [torch.from_numpy(a) for a in (xs, ys, ws, seeds)]
    dzs = {}
    f1, l1, a1 = ct.fused_epoch_plain(spec, fs0, *args,
                                      ops=_DzRecordOps(spec, dzs))
    rank_ops = _RankOrderTieOps(spec, dzs)
    f2, l2, a2 = ct.fused_epoch_plain(spec, fs0, *args, ops=rank_ops)
    n_dz = sum(int(v.numel()) for v in dzs.values())
    assert rank_ops.ties <= 1e-3 * n_dz, (rank_ops.ties, n_dz)
    torch.testing.assert_close(l1, l2, atol=1e-6, rtol=0)
    torch.testing.assert_close(a1, a2, atol=1e-6, rtol=0)
    for k in ("mw", "vw"):
        for a, b in zip(f1[k], f2[k]):
            torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-4)
    for a, b in zip(f1["masters"], f2["masters"]):
        # a weight whose gradient is within rounding of zero may take its
        # +-lr step the other way; no more than a handful do
        off = (a - b).abs() > 1e-5
        assert off.float().mean() < 1e-3
        assert float((a - b).abs().max()) <= 2.5 * spec.lr
    for k in ("rmean", "rvar"):
        torch.testing.assert_close(f1["small"][k], f2["small"][k], atol=1e-6,
                                   rtol=0)
