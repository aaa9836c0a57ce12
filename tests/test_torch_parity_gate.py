"""The fused epoch's parity gate (ops/cuda_train.py::epoch_parity_vs_plain)
on the CPU: its lockstep part (ops/k3_lockstep.py) and its drift part, whose
layer-0 BN bar is max(6e-3, GATE_SPREAD_FACTOR * s), s the spread summation
order alone gives on the gate's rows.

On the CPU K3 is its twin, so the lockstep runs here only for a candidate:
the twin itself, which the gate must pass, and each fault planted by
tools/gate_faults.py, which it must refuse. The JAX package's Pallas epoch,
run in interpret mode as tests/test_torch_fused_epoch.py runs it, must pass
the new BN bar on the small steady case: the port no longer holds a right
kernel to the JAX gate's constant bar.
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
    fstate_from_numpy, params_from_numpy)
from asr_using_robust_nn_tpu_torch.ops import cuda_train as ct
from asr_using_robust_nn_tpu_torch.ops import k3_lockstep as ls
from asr_using_robust_nn_tpu_torch.parallel.mesh import pad_to_multiple
from asr_using_robust_nn_tpu_torch.tools import gate_faults as gf
from asr_using_robust_nn_tpu_torch.train.epoch_scan import build_epoch_fn
from asr_using_robust_nn_tpu_torch.train.trainer import adam_optimizer

from conftest import blobs_task

KW = dict(in_dim=20, n_classes=4, hidden=(32, 16), nonneg=True,
          dropout=(0.0, 0.0))
B = 64


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several test workers share a few cores; one torch thread each keeps
    this file near its solo time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _steady_rows(rng, n, d=20, k=4, prototypes=4, noise=1e-3):
    """Steady-tone-like rows: a few distinct rows, each repeated with small
    noise (its class its label), so a unit's activations cluster."""
    protos = rng.normal(0.0, 1.0, (prototypes, d))
    which = rng.integers(0, prototypes, n)
    x = protos[which] + noise * rng.standard_normal((n, d))
    return x.astype(np.float32), (which % k).astype(np.int64)


def _gate(x, y, n_rows, cfg=None, candidate=None):
    """The gate on the first n_rows of (x, y), zero-padded to whole
    batches as the trainer pads a split."""
    d, n_true = pad_to_multiple(x[:n_rows], B)
    lab, _ = pad_to_multiple(np.asarray(y[:n_rows], np.int64), B)
    return ct.epoch_parity_vs_plain(cfg or mlp.MLPConfig(**KW), B,
                                    torch.from_numpy(d),
                                    torch.from_numpy(lab), n_true,
                                    candidate=candidate)


@pytest.mark.parametrize("rows, steps, bn", [
    ("blobs", 2, True), ("blobs", 4, True), ("blobs", 8, True),
    ("steady", 2, True), ("steady", 4, True), ("steady", 8, True),
    ("blobs", 4, False)])
def test_gate_passes_the_twin(rows, steps, bn):
    """The twin as the candidate: in lockstep with itself, over the first
    8 steps and the last, no reading parts by more than the fp32 rounding
    of reading a gradient back through Adam's first moment ((1 - b1) g /
    (1 - b1)); against the plain epoch every drift reading is under its
    bar. The last batch is ragged."""
    rng = np.random.default_rng(steps)
    n = steps * B - 10
    x, y = (blobs_task(rng, n=n, d=20, k=4) if rows == "blobs"
            else _steady_rows(rng, n))
    cfg = mlp.MLPConfig(**dict(KW, batch_norm=bn))
    g = _gate(x, y, n, cfg, candidate=ct._PlainOps)
    assert g["ok"] and g["failed"] == [] and g["why"] is None, g
    assert g["lockstep_steps"] == list(range(steps))
    assert g["lockstep_first"] is None
    assert g["lockstep_worst"]["ulps"] < 2.0 ** -8
    assert g["max_dmu"] < g["tol_bn_mean"] == ct.bn_bar(steps, g["s"])
    assert g["max_dw"] < g["tol_param"] and g["dloss"] < 3e-2
    if not bn:
        assert g["max_dmu"] == g["s"] == 0.0
    # without a candidate the CPU's K3 is the twin: no lockstep runs
    plain = _gate(x, y, n, cfg)
    assert plain["ok"] and plain["lockstep_steps"] == []
    assert plain["max_dmu"] == g["max_dmu"] and plain["s"] == g["s"]


# where each fault first shows: (operation, quantity, step)
FIRST = {"a": ("backward", "dz (bf16)", 0),
         "b": ("forward 0", "running mean", 0),
         "c": ("forward 0", "mu", 2),
         "d": ("projection", "rescale f", 0),
         "e": ("CE", "CE dz (bf16)", 0),
         "f": ("dW + Adam 0", "master < 0 (NonNeg)", 0)}


@pytest.mark.parametrize("fault", sorted(gf.FAULTS))
def test_gate_refuses_each_fault(fault):
    """Each planted fault is refused by the lockstep at the operation that
    holds it (fault c in the last, ragged, batch: the only one with padded
    rows), and the trainer's message names it."""
    rng = np.random.default_rng(11)
    n = 3 * B - 37
    x, y = blobs_task(rng, n=n, d=20, k=4)
    g = _gate(x, y, n, candidate=gf.candidate(fault, "cpu"))
    assert not g["ok"] and "lockstep" in g["failed"], g
    op, q, step = FIRST[fault]
    first = g["lockstep_first"]
    assert first["op"].startswith(op) and first["q"] == q, first
    assert first["step"] == step and first["ulps"] > 1.0
    assert g["why"].startswith(f"lockstep: step {step}, {first['op']}, {q}")


def test_fault_c_is_no_fault_without_padded_rows():
    """On whole batches the padded rows' weight never enters: fault (c)
    computes what the twin does, and the gate passes it."""
    rng = np.random.default_rng(12)
    x, y = blobs_task(rng, n=2 * B, d=20, k=4)
    g = _gate(x, y, 2 * B, candidate=gf.candidate("c", "cpu"))
    assert g["ok"] and g["lockstep_worst"]["ulps"] < 2.0 ** -8, g


def test_reordered_ops_is_the_twins_arithmetic():
    """The reordered twin sums in another order and nothing else: in
    float64 its chained GEMM and its 8-row column sum are a @ b and
    t.sum(0) to 1e-12."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(64, 200, generator=g, dtype=torch.float64)
    b = torch.randn(200, 48, generator=g, dtype=torch.float64)
    t = torch.randn(64, 37, generator=g, dtype=torch.float64)
    ops = ls.reordered_ops(ct.FusedStepSpec(cfg=mlp.MLPConfig(**KW),
                                            batch=B))
    np.testing.assert_allclose(ls._chained(a, b).numpy(), (a @ b).numpy(),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(ops.colsum(t).numpy(), t.sum(0).numpy(),
                               rtol=0, atol=1e-12)
    # in fp32 the order shows
    a32, b32 = a.float(), b.float()
    assert not torch.equal(ls._chained(a32, b32), a32 @ b32)


def test_bf16_reading():
    """One bf16 ulp at a scale s is 2^(floor(log2 s) - 7)."""
    k3 = torch.tensor([1.0, 2.0, -3.0])
    twin = torch.tensor([1.0, 2.0, -3.0 + 2.0 ** -6])
    r = ls._bf16_reading(k3, twin)
    assert r["scale"] == pytest.approx(3.0 - 2.0 ** -6)
    assert r["ulp"] == 2.0 ** -6 and r["ulps"] == 1.0
    assert r["n_over"] == 0 and r["n"] == 3
    assert r["bias_ulps"] == pytest.approx(-1.0 / 3.0)
    r = ls._bf16_reading(k3, twin, scale=0.5)  # a sum's largest term
    assert r["ulp"] == 2.0 ** -8 and r["ulps"] == 4.0 and r["n_over"] == 1
    r = ls._bf16_reading(torch.zeros(2), torch.zeros(2))
    assert r["ulp"] == 2.0 ** -133 and r["ulps"] == 0.0
    r = ls._bf16_reading(torch.tensor([float("nan"), 1.0]), twin[:2])
    assert r["max_abs"] == float("inf")


@pytest.mark.parametrize("steps", [8, 16])
def test_bn_bar_admits_the_jax_pallas_epoch(steps):
    """The JAX package's Pallas epoch (interpret mode), its end state
    carried across with models/convert.py, against the port's plain bf16
    epoch from the same init on the same steady batches (dropout 0, rho
    0.1, 4 rounds, no shuffle): its layer-0 BN running-mean gap is under
    the new bar, whose order spread comes from the port's twin and
    reordered twin from that init on those batches."""
    rng = np.random.default_rng(0)
    x, y = _steady_rows(rng, steps * B)
    jspec = jpt.FusedStepSpec(cfg=jmlp.MLPConfig(**KW), batch=B, rho=0.1,
                              pi_iters=4, interpret=True)
    spec = ct.FusedStepSpec(cfg=mlp.MLPConfig(**KW), batch=B, rho=0.1,
                            pi_iters=4)
    jp, js = jax.tree_util.tree_map(
        np.asarray, jmlp.init_mlp(jspec.cfg, jax.random.PRNGKey(0)))
    fs_np = jax.tree_util.tree_map(np.asarray,
                                   jpt.pack_state(jspec, jp, js))
    xs = np.zeros((steps, B, spec.pdims[0]), np.float32)
    xs[..., :20] = x.reshape(steps, B, 20)
    ys = y.reshape(steps, B, 1).astype(np.int32)
    ws = np.ones((steps, B, 1), np.float32)
    seeds = np.zeros(steps, np.int32)
    jfs, _, _ = jpt.build_fused_epoch_call(jspec, steps)(
        jax.tree_util.tree_map(jnp.asarray, fs_np),
        *(jnp.asarray(a) for a in (xs, ys, ws, seeds)))
    carried = fstate_from_numpy(jax.tree_util.tree_map(np.asarray, jfs),
                                device="cpu")
    mu_pallas = ct.unpack_params(spec, carried)[1]["layers"][0]["mean"]

    params, state = params_from_numpy(jp, js, device="cpu")
    con = make_simple_norm_constraint(0.1, n_iter=4, pi_backend="plain")
    opt = adam_optimizer(1e-3, "float32")
    ep = build_epoch_fn(spec.cfg.with_bf16(), opt, constraint=con.apply,
                        batch_size=B, shuffle=False, reshuffle_inner=False)
    plain = ep(params, state, opt.init(params), con.init(params),
               torch.from_numpy(x), torch.from_numpy(y), None, None,
               steps * B)[1]
    gap = float((mu_pallas - plain["layers"][0]["mean"]).abs().max())
    s = ct.order_spread(spec, fstate_from_numpy(fs_np, device="cpu"),
                        *(torch.from_numpy(a) for a in (xs, ys, ws, seeds)))
    assert gap < ct.bn_bar(steps, s), (gap, s)


# -- a refused gate stops the fit under `auto` and `fused` alike ----------

@pytest.fixture(scope="module")
def refused_verdict():
    """A real refusal: the gate's verdict on fault (b), the running mean
    written wrong."""
    rng = np.random.default_rng(13)
    x, y = blobs_task(rng, n=2 * B, d=20, k=4)
    g = _gate(x, y, 2 * B, candidate=gf.candidate("b", "cpu"))
    assert not g["ok"] and g["why"]
    return g


def _auto_on_card(monkeypatch):
    """`auto` resolves as on a CUDA device: to the fused epoch."""
    from asr_using_robust_nn_tpu_torch.train import trainer as tm

    resolve = tm.Trainer._resolve_epoch_backend
    monkeypatch.setattr(
        tm.Trainer, "_resolve_epoch_backend",
        lambda self, fresh_opt: self.cfg.epoch_backend == "auto"
        or resolve(self, fresh_opt))


def _fit(backend, monkeypatch, verdict=None, on_card=False):
    """A device-resident fit on the CPU. `on_card` stands in for the card:
    `auto` then resolves to the fused epoch, as it does on a CUDA device.
    `verdict` is planted in the trainer's gate cache under the fit's key,
    so the gate answers with it."""
    from asr_using_robust_nn_tpu_torch.train import trainer as tm

    rng = np.random.default_rng(14)
    x, y = blobs_task(rng, n=3 * B + 40, d=20, k=4)
    cfg = mlp.MLPConfig(**KW)
    tr = tm.Trainer(cfg, tm.TrainConfig(
        batch_size=B, epochs=3, patience=10, seed=2, device_resident=True,
        epoch_backend=backend), device="cpu")
    if on_card:
        _auto_on_card(monkeypatch)
    if verdict is not None:
        monkeypatch.setitem(tm._FUSED_EPOCH_GATE,
                            (cfg, B, None, 4, "cpu"), verdict)
    return tr.fit(x[:3 * B], y[:3 * B], x[3 * B:], y[3 * B:])


@pytest.mark.parametrize("backend", ["auto", "fused"])
def test_refused_gate_raises(backend, refused_verdict, monkeypatch):
    """A refusal stops the fit before its first epoch under `auto` as under
    `fused`: `auto` chooses before any launch, never from a kernel's
    failure. The error carries the verdict and names the way on: the plain
    epoch, which then trains the same task and runs no gate."""
    from asr_using_robust_nn_tpu_torch.train.trainer import FusedEpochRefused

    with pytest.raises(FusedEpochRefused) as e:
        _fit(backend, monkeypatch, refused_verdict, on_card=True)
    assert e.value.gate is refused_verdict
    assert refused_verdict["why"] in str(e.value)
    assert "--epoch-backend plain" in str(e.value)
    res = _fit("plain", monkeypatch)
    assert res["epoch_backend"] == "plain" and res["epoch_gate"] is None


def test_passing_gate_keeps_auto_on_the_fused_epoch(monkeypatch):
    """A verdict that passes leaves `auto` on the fused epoch (its twin on
    the CPU) and is returned."""
    verdict = {"ok": True, "why": None}
    res = _fit("auto", monkeypatch, verdict, on_card=True)
    assert res["epoch_backend"] == "fused" and res["epoch_gate"] is verdict


def test_cmd_train_reports_the_refusal(refused_verdict, monkeypatch,
                                       tmp_path, capsys):
    """`train --device-resident` under `auto` stops on a refused gate: exit
    1, the error line names `--epoch-backend plain`, and the JSON line
    carries the reason as `epoch_gate_why`."""
    import json

    from asr_using_robust_nn_tpu_torch.cli.main import main, model_cfg_for
    from asr_using_robust_nn_tpu_torch.train import trainer as tm

    rng = np.random.default_rng(15)
    for name, n in (("train", 24), ("dev", 8), ("test", 8)):
        np.save(tmp_path / f"{name}_data.npy", rng.standard_normal((n, 880)))
        np.save(tmp_path / f"{name}_label.npy",
                rng.integers(0, 10, n).astype(np.int32))
    _auto_on_card(monkeypatch)
    monkeypatch.setitem(
        tm._FUSED_EPOCH_GATE,
        (model_cfg_for("digit", "constrained"), 8, None, 4, "cpu"),
        refused_verdict)
    assert main(["train", "--task", "digit", "--variant", "constrained",
                 "--constraint", "none", "--data", str(tmp_path), "--ckpt",
                 str(tmp_path / "ck"), "--epochs", "1", "--batch-size", "8",
                 "--log-every", "0", "--device-resident", "--device",
                 "cpu"]) == 1
    cap = capsys.readouterr()
    line = json.loads(cap.out.strip().splitlines()[-1])
    assert line["epoch_backend"] is None
    assert line["epoch_gate_why"] == refused_verdict["why"]
    assert cap.err.startswith("error: fused epoch parity check failed")
    assert "--epoch-backend plain" in cap.err
