"""The multi-rank equivalence oracles, run inside every rank of a world.

Counterpart of the JAX package's driver-side `_dryrun_case` and
`dryrun_multichip` (`__graft_entry__.py`): the same cases at the same
tolerances, each against the single-device program on the same init, batch
and generator, computed in the same rank:

  1. the data-parallel step (`DataParallelTrainer`, constrained: Adam ->
     NonNeg -> simple_norm rho 0.1, 4 power-iteration rounds): loss within
     rtol 10 * tol, every Dense kernel within atol tol;
  2. a device-resident data-parallel fit of one epoch: finite, and its loss
     within rtol 10 * tol of the single-device plain epoch's;
  3. the tensor-parallel step on a (W/2, 2) mesh: as 1;

for the toy MLPConfig(in_dim=40, hidden=(32, 16), dropout=(0.1, 0.0), BN,
NonNeg) at batch 4 W with tol 1e-5 and for `MLPConfig.digit_constrained()`
at batch 512 with tol 1e-4; then the bf16 data-parallel step (finite), and
the runs-sharded `fit_multi_run` (2 W runs) against the unsharded one
(best_val_loss rtol 1e-4, epochs_run equal).

    run_ranks(dryrun_multichip, world, "gloo", device)   # parallel/launch.py

Each rank returns the report: every error beside its tolerance, and for
each parallel path the launches of K2's wrapper in the rank during that
path's call alone (not during the single-device references) beside the
projections the path makes (one a train step). A miss raises; the launch
counts are the caller's to hold (on the card they must equal the
projections; on the CPU the wrapper runs its plain twin and counts none).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..constraints import make_simple_norm_constraint
from ..models.mlp import MLPConfig, init_mlp
from ..ops.cuda_spectral import product_spectral_norm_cuda
from ..train.multi_run import fit_multi_run
from ..train.trainer import TrainConfig, Trainer, _tree_leaves
from .data_parallel import DataParallelTrainer
from .mesh import data_mesh
from .tensor_parallel import TensorParallelTrainer, tp_mesh

__all__ = ["TOY", "dryrun_case", "dryrun_multichip"]

TOY = MLPConfig(in_dim=40, n_classes=10, hidden=(32, 16), dropout=(0.1, 0.0),
                batch_norm=True, nonneg=True)


def _launched(k2: dict, path: str, projections: int, fn, *args, **kw):
    """fn(*args, **kw), recording in `k2[path]` K2's launches in this rank
    during the call beside the `projections` the call makes."""
    before = product_spectral_norm_cuda.launches
    out = fn(*args, **kw)
    k2[path] = {"launches": product_spectral_norm_cuda.launches - before,
                "projections": projections}
    return out


def _hold(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dry run: {what}")


def _step(trainer, state_fn, x, y, device, seed=1):
    """One train step of `trainer` from `state_fn()`'s state."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return trainer.train_step(*state_fn(), torch.as_tensor(x, device=device),
                              torch.as_tensor(y, device=device), gen)


def _errors(got, want):
    """(loss error, worst Dense kernel error) of step outputs."""
    loss_err = abs(float(got[4]) - float(want[4])) / abs(float(want[4]))
    w_err = max(float(torch.max(torch.abs(a["w"] - b["w"])))
                for a, b in zip(got[0]["layers"], want[0]["layers"]))
    return loss_err, w_err


def dryrun_case(m_cfg: MLPConfig, batch_size: int, tol: float = 1e-5,
                device="cpu") -> dict:
    """The data-parallel step, the device-resident data-parallel fit and
    the tensor-parallel step of `m_cfg` against the single-device ones;
    -> {oracle: error} beside "tol", and "k2": each parallel path's K2
    launches (`_launched`). Raises on a miss."""
    dev = torch.device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    con = make_simple_norm_constraint(0.1, n_iter=4)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((batch_size, m_cfg.in_dim)).astype(np.float32)
    y = rng.integers(0, m_cfg.n_classes, batch_size)

    def fresh(trainer):
        def state():
            p, s = init_mlp(m_cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
            return p, s, trainer.optimizer.init(p), con.init(p)
        return state

    tcfg = TrainConfig(batch_size=batch_size, epochs=1)
    kw = dict(constraint=con.apply, device=dev)
    single = Trainer(m_cfg, tcfg, **kw)
    want = _step(single, fresh(single), x, y, dev)
    dp = DataParallelTrainer(m_cfg, data_mesh(), tcfg, **kw)
    k2 = {}
    got = _launched(k2, "dp_step", 1, _step, dp, fresh(dp), x, y, dev)
    out = {"tol": tol}
    out["dp_loss_rel"], out["dp_w_abs"] = _errors(got, want)
    _hold(out["dp_loss_rel"] <= 10 * tol and out["dp_w_abs"] <= tol,
          f"data-parallel step vs single-device: {out}")

    # the device-resident fit: one plain epoch on each side
    n_val = max(2 * world, batch_size // 2)
    p0, _ = init_mlp(m_cfg, torch.Generator(device=dev).manual_seed(0),
                     device=dev)
    dr_cfg = TrainConfig(batch_size=batch_size, epochs=1, patience=10,
                         device_resident=True, epoch_backend="plain")
    def fit(cls, *args):
        return cls(*args, dr_cfg, constraint=con.apply,
                   constraint_state=con.init(p0), device=dev).fit(
                       x, y, x[:n_val], y[:n_val])

    # one epoch of one batch: one projection
    fit_dp = _launched(k2, "dp_fit", 1, fit, DataParallelTrainer, m_cfg,
                       data_mesh())
    fit_1 = fit(Trainer, m_cfg)
    loss_dp, loss_1 = (f["history"]["loss"][0] for f in (fit_dp, fit_1))
    out["fit_loss_rel"] = abs(loss_dp - loss_1) / abs(loss_1)
    _hold(np.isfinite(loss_dp) and out["fit_loss_rel"] <= 10 * tol,
          f"device-resident data-parallel fit: {loss_dp} vs {loss_1}")

    if world >= 2 and world % 2 == 0:
        tp = TensorParallelTrainer(m_cfg, tp_mesh(world // 2, 2), tcfg, **kw)

        def tp_state():
            p, s = init_mlp(m_cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
            return (*tp._adopt_train_state(p, s)[:3], con.init(p))

        t_out = list(_launched(k2, "tp_step", 1, _step, tp, tp_state, x, y,
                               dev))
        t_out[0] = tp._full_trees(t_out[0], t_out[1])[0]
        out["tp_loss_rel"], out["tp_w_abs"] = _errors(t_out, want)
        _hold(out["tp_loss_rel"] <= 10 * tol and out["tp_w_abs"] <= tol,
              f"tensor-parallel step vs single-device: {out}")
    out["k2"] = k2
    return out


def dryrun_multichip(device="cpu") -> dict:
    """Every oracle of the JAX package's dry run in this rank -> the report
    (errors beside tolerances; "k2": each parallel path's K2 launches in
    the rank beside its projections, by case and path)."""
    dev = torch.device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    report = {"world": world, "rank": dist.get_rank() if world > 1 else 0,
              "toy": dryrun_case(TOY, 4 * world, 1e-5, dev),
              "digit": dryrun_case(MLPConfig.digit_constrained(), 512, 1e-4,
                                   dev)}

    # bf16 operands in every GEMM under the data-parallel step: finite
    bcfg = MLPConfig.digit_constrained().with_bf16()
    con = make_simple_norm_constraint(0.1, n_iter=4)
    btr = DataParallelTrainer(bcfg, data_mesh(),
                              TrainConfig(batch_size=512, epochs=1),
                              constraint=con.apply, device=dev)
    rng = np.random.default_rng(1)
    xb = rng.standard_normal((512, 880)).astype(np.float32)
    yb = rng.integers(0, 10, 512)

    def bf16_state():
        p, s = init_mlp(bcfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
        return p, s, btr.optimizer.init(p), con.init(p)

    k2 = {}
    b_loss = float(_launched(k2, "bf16_dp_step", 1, _step, btr, bf16_state,
                             xb, yb, dev)[4])
    report["bf16_loss"] = b_loss
    _hold(np.isfinite(b_loss), f"bf16 data-parallel step loss {b_loss}")

    # the runs axis over the ranks against the unsharded multi-run
    rng = np.random.default_rng(2)
    n = 32 * world
    mx = rng.standard_normal((n, TOY.in_dim)).astype(np.float32)
    my = rng.integers(0, TOY.n_classes, n)
    mr_cfg = TrainConfig(batch_size=16, epochs=2, patience=4,
                         device_resident=True, epochs_per_dispatch=2)
    kw = dict(constraint=con.apply, constraint_init=con.init, device=dev)
    seeds = list(range(2 * world))
    mesh = data_mesh()
    res_sh = _launched(k2, "multi_run_sharded", None, fit_multi_run, TOY,
                       mr_cfg, mx, my, mx[:16], my[:16], seeds, mesh=mesh,
                       **kw)
    # one projection a run a step: this rank's runs, each for the epochs it
    # ran, n / 16 steps an epoch
    lo = 2 * mesh.coords["data"]
    k2["multi_run_sharded"]["projections"] = int(
        np.sum(res_sh["epochs_run"][lo: lo + 2])) * (n // 16)
    res_un = fit_multi_run(TOY, mr_cfg, mx, my, mx[:16], my[:16], seeds,
                           **kw)
    rel = float(np.max(np.abs(res_sh["best_val_loss"]
                              - res_un["best_val_loss"])
                       / np.abs(res_un["best_val_loss"])))
    same_epochs = bool((res_sh["epochs_run"] == res_un["epochs_run"]).all())
    report["multi_run"] = {"runs": len(seeds), "best_val_loss_rel": rel,
                           "rtol": 1e-4, "epochs_run_equal": same_epochs,
                           "params_equal": all(
                               torch.equal(a, b) for a, b in zip(
                                   _tree_leaves(res_sh["best_params"]),
                                   _tree_leaves(res_un["best_params"])))}
    _hold(rel <= 1e-4 and same_epochs,
          f"runs-sharded multi-run vs unsharded: {report['multi_run']}")
    report["k2"] = {**{f"{case}/{path}": v for case in ("toy", "digit")
                       for path, v in report[case].pop("k2").items()}, **k2}
    return report
