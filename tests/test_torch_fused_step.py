"""The port's per-step fused path, K6 (asr_using_robust_nn_tpu_torch/ops/
cuda_step.py), against the JAX package's Pallas step kernel run in interpret
mode on the CPU, and the semantics of its deferred constraint scales.

States cross between the packages with `models/convert.py`; inputs are
seeded numpy arrays given to both. On the CPU `build_fused_step`'s `step`
runs the plain twin; the kernels run only on a card and are held against the
twin by `chip_smoke.py`.

Tolerances (those of the JAX suite's tests of the same kernel): two
bf16-class programs whose fp32 sums run in different orders; at the first
Adam steps the update is ~lr * sign(g), so O(1e-7) gradient noise moves a
weight by up to 2 lr wherever |g| is near zero. Hence after one step: loss
5e-3, accuracy 1e-6, weights 2.5e-3, BN running mean 1e-4, `scales` 1e-5
relative (sigma comes from the bf16 copies, whose few flipped entries move it
by far less than that).
"""

import dataclasses

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
    fstate_from_numpy, fstate_to_numpy)
from asr_using_robust_nn_tpu_torch.ops import cuda_step as k6
from asr_using_robust_nn_tpu_torch.ops import cuda_train as ct
from asr_using_robust_nn_tpu_torch.train.trainer import TrainConfig, Trainer

from conftest import blobs_task, product_norm_oracle

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


def _jax_packed(jspec, seed=0):
    jp, js = jax.tree_util.tree_map(
        np.asarray, jmlp.init_mlp(jspec.cfg, jax.random.PRNGKey(seed)))
    return jax.tree_util.tree_map(np.asarray, jpt.pack_state(jspec, jp, js))


def _init(spec, seed=0):
    params, state = mlp.init_mlp(spec.cfg,
                                 torch.Generator().manual_seed(seed),
                                 device="cpu")
    return params, state, ct.pack_state(spec, params, state)


def _norm(spec, fs):
    pp, _ = ct.unpack_params(spec, fs)
    return float(product_norm_oracle([p["w"].numpy() for p in pp["layers"]]))


def _norm16(fs):
    """The product norm of the stored bf16 copies, which the forward uses."""
    return float(product_norm_oracle([w.float().numpy() for w in fs["w16"]]))


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("bn,rho", [(True, 0.5), (False, None)],
                         ids=["bn_constrained", "no_bn_unconstrained"])
def test_step_twin_matches_jax_interpret(bn, rho):
    """One step from one JAX-packed state (u included) on the same batch,
    with the Pallas kernel's ReLU mask."""
    rng = np.random.default_rng(3)
    jspec, spec = _specs(rho=rho, batch_norm=bn, pallas_relu_mask=True)
    fs_np = _jax_packed(jspec, seed=3)
    x, y = blobs_task(rng, n=64, d=20, k=4)
    jstep = jpt.build_fused_step(jspec)
    jfs, jl, ja = jstep(jax.tree_util.tree_map(jnp.asarray, fs_np),
                        jpt.pad_features(jspec, x), jnp.asarray(y),
                        jnp.ones((64,), jnp.float32), jnp.int32(7))
    jfs = jax.tree_util.tree_map(np.asarray, jfs)
    step = k6.build_fused_step(spec)
    fs, loss, acc = step(fstate_from_numpy(fs_np, device="cpu"),
                         ct.pad_features(spec, _t(x)), _t(y), torch.ones(64),
                         7)
    assert abs(float(loss) - float(jl)) < 5e-3
    assert abs(float(acc) - float(ja)) < 1e-6
    got = fstate_to_numpy(fs)
    for a, b in zip(got["masters"], jfs["masters"]):
        np.testing.assert_allclose(a, b, atol=2.5e-3)
    for a, b in zip(got["w16"], jfs["w16"]):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), atol=2.5e-3)
    np.testing.assert_allclose(got["small"]["rmean"], jfs["small"]["rmean"],
                               atol=1e-4)
    np.testing.assert_allclose(got["scales"], jfs["scales"], rtol=1e-5)
    np.testing.assert_allclose(got["u"], jfs["u"], atol=5e-3)
    assert int(got["count"][0]) == int(jfs["count"][0]) == 1
    if rho is None:
        np.testing.assert_array_equal(got["scales"], 1.0)
        np.testing.assert_array_equal(got["u"], fs_np["u"])
        # BN off: the gamma/beta rows and their moments are left alone
        for k in ("gamma", "m_gamma", "v_gamma", "beta", "m_beta", "v_beta"):
            np.testing.assert_array_equal(got["small"][k],
                                          fs_np["small"][k])
    else:
        assert np.all(got["scales"][0, :3] != 1.0)
        np.testing.assert_array_equal(got["scales"][0, 3:], 1.0)


def test_scan_steps_epoch_matches_jax_interpret():
    """The epoch as a chain of K6 steps in both packages: shuffle off,
    dropout 0, two steps, the Pallas ReLU mask; the folded parameters and the
    epoch's loss and accuracy agree at the one-step bounds."""
    rng = np.random.default_rng(4)
    jspec, spec = _specs(pallas_relu_mask=True)
    fs_np = _jax_packed(jspec, seed=4)
    x, y = blobs_task(rng, n=128, d=20, k=4)
    jep = jpt.build_fused_epoch_fn(jspec, shuffle=False, scan_steps=True)
    jfs, jl, ja = jep(jax.tree_util.tree_map(jnp.asarray, fs_np),
                      jpt.pad_features(jspec, x), jnp.asarray(y),
                      jax.random.PRNGKey(1), jax.random.PRNGKey(2),
                      n_true=128)
    jpp, jss = jpt.unpack_params(jspec, jfs)
    ep = ct.build_fused_epoch_fn(spec, shuffle=False, scan_steps=True)
    fs, loss, acc = ep(fstate_from_numpy(fs_np, device="cpu"),
                       ct.pad_features(spec, _t(x)), _t(y).long(), None, None,
                       128)
    pp, ss = ct.unpack_params(spec, fs)
    assert abs(float(loss) - float(jl)) < 5e-3
    assert abs(float(acc) - float(ja)) < 1e-6
    for a, b in zip(pp["layers"], jpp["layers"]):
        np.testing.assert_allclose(a["w"].numpy(), np.asarray(b["w"]),
                                   atol=2.5e-3)
        np.testing.assert_allclose(a["b"].numpy(), np.asarray(b["b"]),
                                   atol=2.5e-3)
    np.testing.assert_allclose(ss["layers"][0]["mean"].numpy(),
                               np.asarray(jss["layers"][0]["mean"]),
                               atol=1e-4)
    np.testing.assert_allclose(fs["scales"].numpy(), np.asarray(jfs["scales"]),
                               rtol=1e-5)
    assert int(fs["count"][0]) == int(jfs["count"][0]) == 2


# -- counterparts of the JAX suite's TestFusedStep ---------------------------

def _plain_trainer(spec):
    con = (make_simple_norm_constraint(spec.rho, n_iter=spec.pi_iters)
           if spec.rho is not None else None)
    params, state, fs = _init(spec)
    # the bf16 model config: the fused step's class (bf16 GEMM operands)
    tr = Trainer(spec.cfg.with_bf16(), TrainConfig(batch_size=spec.batch),
                 constraint=con.apply if con else None,
                 constraint_state=con.init(params) if con else None,
                 device="cpu")
    return tr, con, params, state, fs


def test_one_step_matches_plain_train_step():
    """Oracle: the port's autograd `Trainer.train_step` (bf16 GEMMs) with
    the same recipe, as the JAX suite holds its kernel to the XLA step."""
    rng = np.random.default_rng(0)
    _, spec = _specs()
    tr, con, params, state, fs = _plain_trainer(spec)
    x, y = blobs_task(rng, n=64, d=20, k=4)
    step = k6.build_fused_step(spec)
    fs2, loss_k, acc_k = step(fs, ct.pad_features(spec, _t(x)), _t(y),
                              torch.ones(64), 7)
    p2, s2, _, _, loss_x, acc_x = tr.train_step(
        params, state, tr.optimizer.init(params), con.init(params), _t(x),
        _t(y).long(), None)
    assert abs(float(loss_k) - float(loss_x)) < 5e-3
    assert abs(float(acc_k) - float(acc_x)) < 1e-6
    pp, ss = ct.unpack_params(spec, fs2)
    for a, b in zip(pp["layers"], p2["layers"]):
        torch.testing.assert_close(a["w"], b["w"], atol=2.5e-3, rtol=0)
    torch.testing.assert_close(ss["layers"][0]["mean"],
                               s2["layers"][0]["mean"], atol=1e-4, rtol=0)
    # `fstate` itself is never modified
    assert int(fs["count"][0]) == 0 and int(fs2["count"][0]) == 1


def test_row_weights_mask_padded_rows():
    """16 weight-0 rows of poison give the same loss and update as the same
    batch with harmless weight-0 rows."""
    rng = np.random.default_rng(1)
    _, spec = _specs()
    _, _, fs = _init(spec)
    step = k6.build_fused_step(spec)
    x, y = blobs_task(rng, n=64, d=20, k=4)
    w = np.ones(64, np.float32)
    w[48:] = 0.0
    clean = x.copy()
    clean[48:] = clean[:16]
    x[48:] = 1e3
    outs = [step(fs, ct.pad_features(spec, _t(a)), _t(y), _t(w), 3)
            for a in (x, clean)]
    assert abs(float(outs[0][1]) - float(outs[1][1])) < 1e-5
    for a, b in zip(ct.unpack_params(spec, outs[0][0])[0]["layers"],
                    ct.unpack_params(spec, outs[1][0])[0]["layers"]):
        torch.testing.assert_close(a["w"], b["w"], atol=1e-4, rtol=0)
    assert torch.isfinite(outs[0][0]["masters"][0]).all()


def test_trajectory_and_constraint():
    """30 steps: the loss falls, the product norm of the unpacked parameters
    lands at rho from BOTH sides (a factor folded twice would land it near
    rho^2 / sigma, below rho), and the loss tracks the plain trainer's."""
    rng = np.random.default_rng(0)
    x, y = blobs_task(rng, n=256, d=20, k=4)
    _, spec = _specs()
    tr, con, p2, s2, fs = _plain_trainer(spec)
    step = k6.build_fused_step(spec)
    o, c2 = tr.optimizer.init(p2), con.init(p2)
    losses = []
    for it in range(30):
        i0 = (it * 64) % 192
        xb, yb = _t(x[i0:i0 + 64]), _t(y[i0:i0 + 64])
        fs, lk, _ = step(fs, ct.pad_features(spec, xb), yb, torch.ones(64), it)
        p2, s2, o, c2, lx, _ = tr.train_step(p2, s2, o, c2, xb, yb.long(),
                                             None)
        losses.append((float(lk), float(lx)))
    assert losses[-1][0] < losses[0][0] * 0.7
    sigma = _norm(spec, fs)
    assert spec.rho / 1.06 <= sigma <= spec.rho * 1.06
    assert abs(losses[-1][0] - losses[-1][1]) < 0.15
    assert int(fs["count"][0]) == 30


def test_unconstrained_no_bn():
    """No BN, no constraint: the loss falls, `scales` stay 1, u passes
    through."""
    rng = np.random.default_rng(0)
    _, spec = _specs(rho=None, batch_norm=False)
    _, _, fs = _init(spec)
    u0 = fs["u"].clone()
    step = k6.build_fused_step(spec)
    x, y = blobs_task(rng, n=64, d=20, k=4)
    losses = []
    for it in range(20):
        fs, loss, _ = step(fs, ct.pad_features(spec, _t(x)), _t(y),
                           torch.ones(64), it)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    assert torch.equal(fs["scales"], torch.ones_like(fs["scales"]))
    assert torch.equal(fs["u"], u0)


def test_scan_steps_epoch_fn_trains():
    """The epoch wrapper as a chain of K6 steps learns the blobs task."""
    rng = np.random.default_rng(0)
    x, y = blobs_task(rng, n=256, d=20, k=4)
    _, spec = _specs(rho=None)
    _, _, fs = _init(spec)
    epoch = ct.build_fused_epoch_fn(spec, epochs_per_call=2, scan_steps=True)
    data, lab = ct.pad_features(spec, _t(x)), _t(y).long()
    for e in range(12):
        fs, loss, acc = epoch(fs, data, lab, torch.Generator().manual_seed(1),
                              torch.Generator().manual_seed(100 + e), 256)
    assert float(acc) > 0.9
    assert int(fs["count"][0]) == 12 * 2 * 4


@pytest.mark.parametrize("drop", [0.0, 0.2])
def test_grid_equals_scan_steps(drop):
    """The grid epoch (eager rescale of the masters) and the chain of K6
    steps (deferred scales) compute the same math: one epoch of two steps
    from the same state, shuffle and seeds. Both run the twin's fp32
    operations in one order here, so the bounds are tight: the eager and the
    deferred multiply round the same product."""
    rng = np.random.default_rng(5)
    x, y = blobs_task(rng, n=128, d=20, k=4)
    _, spec = _specs(dropout=(drop, drop))
    _, _, fs0 = _init(spec)
    data, lab = ct.pad_features(spec, _t(x)), _t(y).long()
    outs = {}
    for name, scan in (("grid", False), ("steps", True)):
        ep = ct.build_fused_epoch_fn(spec, scan_steps=scan)
        fs, loss, acc = ep(fs0, data, lab, torch.Generator().manual_seed(1),
                           torch.Generator().manual_seed(2), 128)
        outs[name] = (fs, float(loss), float(acc), ct.unpack_params(spec, fs))
    g, s = outs["grid"], outs["steps"]
    assert abs(g[1] - s[1]) < 1e-6 and abs(g[2] - s[2]) < 1e-6
    for a, b in zip(g[3][0]["layers"], s[3][0]["layers"]):
        for k in a:
            torch.testing.assert_close(a[k], b[k], atol=1e-6, rtol=0)
    for k in ("mw", "vw"):
        for a, b in zip(g[0][k], s[0][k]):
            torch.testing.assert_close(a, b, atol=1e-7, rtol=0)
    torch.testing.assert_close(g[3][1]["layers"][0]["mean"],
                               s[3][1]["layers"][0]["mean"], atol=1e-6,
                               rtol=0)
    assert torch.equal(g[0]["count"], s[0]["count"])
    # the grid path leaves no deferred factor, the chain exactly one step's
    assert torch.equal(g[0]["scales"], torch.ones_like(g[0]["scales"]))
    assert not torch.equal(s[0]["scales"], torch.ones_like(s[0]["scales"]))


# -- the deferred scales -------------------------------------------------------

def test_scales_are_folded_exactly_once():
    """After a constrained step the masters are unscaled and `scales` holds
    that step's factors; `unpack_params` folds them once; the next step's
    Adam load folds them once and the new `scales` replace them; an
    unconstrained step from such a state folds them and leaves `scales` = 1."""
    rng = np.random.default_rng(6)
    _, spec = _specs()
    _, _, fs0 = _init(spec)
    x, y = blobs_task(rng, n=64, d=20, k=4)
    args = (ct.pad_features(spec, _t(x)), _t(y), torch.ones(64), 0)
    fs1, _, _ = k6.build_fused_step(spec)(fs0, *args)
    sc = fs1["scales"][0, :3]
    assert bool((sc != 1.0).all())
    pp, _ = ct.unpack_params(spec, fs1)
    for i, p in enumerate(pp["layers"]):
        d_in, d_out = p["w"].shape
        assert torch.equal(p["w"], (fs1["masters"][i] * sc[i])[:d_in, :d_out])
        # the bf16 copy was rescaled in bf16, not recast from the master
        want = (fs0_w16_after_adam(spec, fs0, args)[i].float()
                * sc[i]).to(torch.bfloat16)
        assert torch.equal(fs1["w16"][i], want)
    # the folded masters are the stored bf16 copies, up to bf16 rounding
    assert abs(_norm(spec, fs1) / _norm16(fs1) - 1.0) < 0.02
    # an unconstrained step from fs1: folds at load, scales back to 1
    free = dataclasses.replace(spec, rho=None)
    fs2, _, _ = k6.build_fused_step(free)(fs1, *args)
    assert torch.equal(fs2["scales"], torch.ones_like(fs2["scales"]))
    lr = spec.lr
    for i in range(3):
        moved = (fs2["masters"][i] - fs1["masters"][i] * sc[i]).abs().max()
        assert float(moved) <= 4 * lr  # one Adam step from the FOLDED master


def fs0_w16_after_adam(spec, fs0, args):
    """The bf16 copies right after the step's Adam and NonNeg, before the
    projection: the same step with rho=None."""
    free = dataclasses.replace(spec, rho=None)
    return k6.build_fused_step(free)(fs0, *args)[0]["w16"]


def test_grid_path_folds_deferred_scales():
    """A K6 epoch followed by a grid epoch keeps the product norm at rho from
    both sides, and equals a grid epoch from the folded state."""
    rng = np.random.default_rng(7)
    x, y = blobs_task(rng, n=256, d=20, k=4)
    _, spec = _specs()
    _, _, fs = _init(spec)
    data, lab = ct.pad_features(spec, _t(x)), _t(y).long()
    gens = lambda s: (torch.Generator().manual_seed(s),  # noqa: E731
                      torch.Generator().manual_seed(s + 50))
    scan = ct.build_fused_epoch_fn(spec, scan_steps=True)
    grid = ct.build_fused_epoch_fn(spec)
    for e in range(6):
        fs, _, _ = scan(fs, data, lab, *gens(e), 256)
    assert not torch.equal(fs["scales"], torch.ones_like(fs["scales"]))
    assert spec.rho / 1.1 <= _norm(spec, fs) <= spec.rho * 1.1
    after, _, _ = grid(fs, data, lab, *gens(9), 256)
    assert spec.rho / 1.1 <= _norm(spec, after) <= spec.rho * 1.1
    folded = {**fs, "scales": torch.ones_like(fs["scales"]),
              "masters": tuple(w * fs["scales"][0, i]
                               for i, w in enumerate(fs["masters"]))}
    same, _, _ = grid(folded, data, lab, *gens(9), 256)
    for a, b in zip(after["masters"], same["masters"]):
        assert torch.equal(a, b)


def test_a_double_fold_is_caught_from_below():
    """A planted fault: the rescale also multiplies the masters (eager AND
    deferred), so the folded weights shrink by rho / sigma twice. The
    projection renormalizes the bf16 copies every step, so after some steps
    the fault hides (its factors near 1); it shows at the first steps, where
    the folded masters fall below the stored bf16 copies. An upper bound
    alone passes it; holding the norm from both sides does not."""
    class DoubleFold(k6._PlainStepOps):
        def rescale(self, fs, i, f):
            super().rescale(fs, i, f)
            fs["masters"][i].mul_(f)

    rng = np.random.default_rng(8)
    x, y = blobs_task(rng, n=64 * 9, d=20, k=4)
    _, spec = _specs()
    _, _, fs0 = _init(spec)
    xs = ct.pad_features(spec, _t(x)).reshape(9, 64, -1)
    ys, ws = _t(y).reshape(9, 64), torch.ones((9, 64))
    seeds = torch.zeros(9, dtype=torch.int32)
    good, _, _ = k6.fused_steps_plain(spec, fs0, xs, ys, ws, seeds)
    assert spec.rho / 1.1 <= _norm(spec, good) <= spec.rho * 1.1
    for n in (1, 2, 9):
        ok, _, _ = k6.fused_steps_plain(spec, fs0, xs[:n], ys[:n], ws[:n],
                                        seeds[:n])
        assert abs(_norm(spec, ok) / _norm16(ok) - 1.0) < 0.02
    bad, _, _ = k6.fused_steps_plain(spec, fs0, xs[:1], ys[:1], ws[:1],
                                     seeds[:1], ops=DoubleFold(spec))
    sigma_bad = _norm(spec, bad)
    assert sigma_bad <= 1.5 * spec.rho        # the one-sided check passes it
    assert not spec.rho / 1.5 <= sigma_bad    # the two-sided one does not
    assert sigma_bad / _norm16(bad) < 1 / 1.5


def test_dropout_step_is_seeded():
    rng = np.random.default_rng(9)
    _, spec = _specs(dropout=(0.3, 0.3))
    _, _, fs = _init(spec)
    step = k6.build_fused_step(spec)
    x, y = blobs_task(rng, n=64, d=20, k=4)
    a = (ct.pad_features(spec, _t(x)), _t(y), torch.ones(64))
    r1, r2 = step(fs, *a, 5), step(fs, *a, torch.tensor(5, dtype=torch.int32))
    r3 = step(fs, *a, 6)
    assert torch.equal(r1[0]["masters"][0], r2[0]["masters"][0])
    assert not torch.equal(r1[0]["masters"][0], r3[0]["masters"][0])


def test_step_refuses_what_the_kernels_do_not_take():
    """Refusals that need no card: the Pallas ReLU mask is twin-only, the
    kernels work on whole 64-row tiles, and a batch of another shape than
    the spec's is an error on every device."""
    _, spec = _specs(pallas_relu_mask=True)
    with pytest.raises(ValueError, match="pallas_relu_mask"):
        k6._CudaStepOps(spec)
    _, spec40 = _specs(batch=40)
    with pytest.raises(ValueError, match="multiple of 64"):
        k6._StepGraph(spec40, torch.device("cuda", 0))
    _, spec = _specs()
    _, _, fs = _init(spec)
    with pytest.raises(ValueError, match="fused step"):
        k6.build_fused_step(spec)(fs, torch.zeros((32, 128)),
                                  torch.zeros(32), torch.ones(32), 0)


# -- K6's launch plan (pure Python, no card) -------------------------------------

PRESETS = ("digit_unconstrained", "digit_constrained",
           "speaker_unconstrained", "speaker_constrained")


@pytest.mark.parametrize("batch", [64, 512, 1024])
@pytest.mark.parametrize("preset", PRESETS)
def test_step_plan_adam_slices_partition_every_kernel(preset, batch):
    """Every dW launch fits a block; over all tiles and depth ranks the rows
    a rank fetches and updates cover each padded kernel exactly once (so
    Adam runs once per weight), and the ranks' depth slices cover the batch
    exactly once."""
    from asr_using_robust_nn_tpu_torch.models.mlp import MLPConfig

    spec = ct.FusedStepSpec(cfg=getattr(MLPConfig, preset)(), batch=batch,
                            rho=0.1)
    plan = ct.launch_plan(spec)
    for i, L in enumerate(plan["dw"]):
        assert L.smem_bytes <= ct.SMEM_LIMIT and L.cluster_size <= 8
        assert L.cluster_size == L.cluster[2] == L.grid[2]
        updated = np.zeros((spec.pdims[i], spec.pdims[i + 1]), int)
        for by in range(L.grid[1]):
            for bx in range(L.grid[0]):
                for r0, r1 in L.rank_rows():
                    updated[by * 64 + r0: by * 64 + r1,
                            bx * 64: (bx + 1) * 64] += 1
        assert (updated == 1).all()
        summed = np.zeros(batch, int)
        for k0, k1 in L.rank_depth():
            summed[k0:k1] += 1
        assert (summed == 1).all()
        # the ring and a whole tile of master and both moments
        assert L.smem_bytes == 1024 + L.stages * 2 * 64 * 128 + 3 * 64 * 64 * 4


def test_step_ops_refuse_more_layers_than_the_rescale_takes():
    cfg = _specs()[1].cfg
    import dataclasses
    deep = dataclasses.replace(cfg, hidden=(16,) * 17, dropout=(0.0,) * 17)
    spec = ct.FusedStepSpec(cfg=deep, batch=64, rho=0.5)
    with pytest.raises(ValueError, match="at most 16 layers"):
        k6._CudaStepOps(spec)
