"""The FISTA cell on the CPU at a tiny size: its plain reference against the
port's plain epoch under make_fista_constraint, and a traced run of
digit_fista.train through the harness (the program's twins underneath, the
fused epoch's parity gate passed by hand as in test_h100bench_faults.py)
that comes out correct and reads its per-layer metrics."""

import json
import time
import types

import numpy as np
import pytest
import torch

from asr_using_robust_nn_tpu_torch.constraints import make_fista_constraint
from asr_using_robust_nn_tpu_torch.models.mlp import MLPConfig
from asr_using_robust_nn_tpu_torch.ops import cuda_train
from asr_using_robust_nn_tpu_torch.train import TrainConfig, Trainer
from h100bench import gen, harness
from h100bench.reference import fista as ref_fista
from h100bench.reference import mlp as ref
from h100bench.tests import tiny

SMALL = dict(dims=[40, 32, 16, 8], nonneg=True, batch_norm=True,
             dropout=[0.0, 0.0], bn_eps=1e-3, bn_momentum=0.99)


def test_h100bench_fista_training_matches_the_ports_plain_epoch():
    """Two epochs of the FISTA recipe (dropout 0, a ragged last batch) on
    the port's plain fp32 epoch against the reference."""
    model = ref.Model(SMALL)
    params, state = gen.init_params(SMALL["dims"], True, 4, "cpu")
    x, y = torch.randn(150, 40), torch.randint(0, 8, (150,))
    vx, vy = torch.randn(30, 40), torch.randint(0, 8, (30,))
    con = make_fista_constraint(0.5, nit=2)
    cfg = MLPConfig(in_dim=40, n_classes=8, hidden=(32, 16), nonneg=True,
                    dropout=(0.0, 0.0))
    trainer = Trainer(cfg, TrainConfig(batch_size=32, epochs=2, patience=2,
                                       seed=99, device_resident=True,
                                       epoch_backend="plain"),
                      constraint=con.apply, constraint_state=(),
                      device="cpu")
    res = trainer.fit(x.numpy(), y.numpy(), vx.numpy(), vy.numpy(),
                      params={"layers": [dict(p) for p in params]},
                      state={"layers": [dict(s) for s in state]})
    want = ref_fista.train_epochs(model, params, state, x, y, vx, vy,
                                  batch=32, epochs=2, lr=1e-3, rho=0.5,
                                  nit=2, alpha=2.1, seed=99)
    np.testing.assert_allclose(res["history"]["loss"], want["loss"],
                               rtol=1e-5)
    for got, exp in zip(res["params"]["layers"], want["params"]):
        torch.testing.assert_close(got["w"], exp["w"], rtol=1e-4, atol=1e-5)


def _tweak(run):
    c, tr = run.config, run.traffic
    c["corpus"] = {"train": 300, "val": 70}
    c["frontend"]["width"] = 2205
    c["batch_size"] = 64
    c["epochs"] = c["patience"] = 2
    tr["warm_epochs"] = 1
    tr["epoch_backend"] = "fused"


def test_h100bench_fista_tiny_traced_run(monkeypatch):
    torch.set_num_threads(2)
    monkeypatch.setattr(cuda_train, "epoch_parity_vs_plain",
                        lambda *a, **k: {"ok": True,
                                         "seconds": {"total": 0.0}})
    lines = []
    monkeypatch.setattr("builtins.print", lambda *a, **k: lines.append(a)
                        if k.get("file") is None else None)
    cell = "digit_fista.train"
    args = types.SimpleNamespace(workload=cell, seed=2 ** 31 + 23,
                                 seconds=0.3, trace=1)
    run = harness.Run(args, harness.cell_entries(tiny.manifest(), cell),
                      torch.device("cpu"), time.perf_counter())
    _tweak(run)
    assert harness.execute(run) == 0
    res = json.loads(lines[-1][0])
    assert res["correct"] is True and res["failed"] == 0
    iters = res["metrics"]["fista_iters_per_layer"]["value"]
    assert 1.0 <= iters <= 2.0
    assert "k7_roofline_pct" not in res["metrics"]  # no card, no K7 kernel
    assert res["metrics"]["host_reads_per_epoch"]["value"] >= 4.0


@pytest.mark.parametrize("proj_prec", ["fp32", "bf16"])
def test_h100bench_fista_reference_projection(proj_prec):
    """The reference's projection in float32 is the port's; its bf16
    control parts from it by more than float32 rounding."""
    g = torch.Generator().manual_seed(2)
    ws = [torch.rand((a, b), generator=g) * 0.3 for a, b in
          ((40, 32), (32, 16), (16, 8))]
    want = make_fista_constraint(0.5, nit=2).apply(
        {"layers": [{"w": w, "b": torch.zeros(w.shape[1])} for w in ws]},
        ())[0]["layers"]
    got = ref_fista.fista_project(ws, 0.5, 2, 2.1, proj_prec)
    gap = max(float((a - b["w"]).norm() / b["w"].norm())
              for a, b in zip(got, want))
    assert (gap < 1e-5) == (proj_prec == "fp32"), gap


@pytest.mark.parametrize("f", [0.95, 1.05])
def test_h100bench_fista_near_rho_start(f):
    """The lr-0 check fits near rho start NonNeg, with the product's 2-norm
    at f * rho, from every layer scaled alike."""
    from h100bench.generators.fit_resident_fista import near_rho

    init = gen.init_params(SMALL["dims"], True, 5, "cpu")
    params, state = near_rho(init, 5.0, f)
    assert state is init[1]
    prod = params[0]["w"].double()
    for p in params[1:]:
        prod = prod @ p["w"].double()
    assert abs(float(torch.linalg.matrix_norm(prod, ord=2)) - f * 5.0) < 1e-5
    ratios = [p["w"].double() / torch.clamp_min(q["w"].double(), 1e-30)
              for p, q in zip(params, init[0])]
    assert all(bool((p["w"] >= 0).all()) for p in params)
    scale = [float(r[q["w"] > 0].mean()) for r, q in zip(ratios, init[0])]
    assert max(scale) - min(scale) < 1e-5


def test_h100bench_fista_k7_work_is_an_exit_step():
    """K7's least work at the digit widths: the masters read once, the
    suffix chain and layer 0's chain at 10 rows, 2 flop a multiply-add."""
    from h100bench.work import counts, fista_counts

    dims = [880, 1024, 512, 256, 128, 64, 10]
    n_bytes, ops = fista_counts.k7_work(dims)
    assert n_bytes == 4 * sum(counts.links(dims)) == 6_392_320
    assert ops == {"fp32": 2 * 10 * sum(counts.links(dims))}
    assert abs(counts.bound_ms(n_bytes, ops)[0] - 1.908e-3) < 1e-6
