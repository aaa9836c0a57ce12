"""The FISTA projection on the fused epoch: K7's plain twin
(`ops/cuda_fista.py::fista_project_twin`) against the port's
`make_fista_constraint` and the benchmark's plain reference
(`h100bench/reference/fista.py`), the fused epoch's twin under FISTA against
the plain epoch at the parity gate's bars, the trainer's choice of backend
and the gate's cache key. On the CPU at small widths (and the digit widths
for ||B_i||_2); the last test needs the card and skips without one:

    python -m pytest --noconftest -m cuda tests/test_torch_fista_epoch.py
"""

import numpy as np
import pytest
import torch

from asr_using_robust_nn_tpu_torch.constraints import make_fista_constraint
from asr_using_robust_nn_tpu_torch.models import mlp
from asr_using_robust_nn_tpu_torch.ops import cuda_fista as cf
from asr_using_robust_nn_tpu_torch.ops import cuda_train as ct
from asr_using_robust_nn_tpu_torch.parallel.mesh import pad_to_multiple
from asr_using_robust_nn_tpu_torch.tools import gate_faults as gf
from asr_using_robust_nn_tpu_torch.train import trainer as tm
from h100bench.reference import fista as ref_fista

DIMS = (40, 32, 24, 16, 10)
DIGIT = (880, 1024, 512, 256, 128, 64, 10)


def _stack(dims, seed, dtype=torch.float64, nonneg=True):
    """Glorot-uniform kernels, clamped at 0 where `nonneg`."""
    g = torch.Generator().manual_seed(seed)
    ws = []
    for a, b in zip(dims[:-1], dims[1:]):
        lim = (6.0 / (a + b)) ** 0.5
        w = (torch.rand((a, b), generator=g, dtype=torch.float64) * 2 - 1) * lim
        ws.append((w.clamp_min(0.0) if nonneg else w).to(dtype))
    return ws


def _padded(ws, dims):
    """K3's layout: each kernel in a buffer padded to multiples of 128."""
    pd = [-(-d // 128) * 128 for d in dims]
    out = []
    for i, w in enumerate(ws):
        m = torch.zeros((pd[i], pd[i + 1]), dtype=w.dtype)
        m[:dims[i], :dims[i + 1]] = w
        out.append(m)
    return out


def _twin(ws, dims, rho, nonneg=True, **kw):
    """The twin on padded copies of `ws` -> (kernels, counters)."""
    masters = _padded(ws, dims)
    w16 = [m.to(torch.bfloat16) for m in masters]
    state = cf.fista_state(dims, "cpu")
    cf.fista_project_twin(masters, w16, state, dims, rho, 2, 2.1, nonneg,
                          **kw)
    for m, h in zip(masters, w16):
        assert torch.equal(h, m.to(torch.bfloat16))
    return ([m[:dims[i], :dims[i + 1]] for i, m in enumerate(masters)],
            state["n"].tolist())


def _port(ws, rho):
    params = {"layers": [{"w": w.clone(), "b": torch.zeros(w.shape[1],
                                                           dtype=w.dtype)}
                         for w in ws]}
    out, _ = make_fista_constraint(rho, nit=2).apply(params, ())
    return [layer["w"] for layer in out["layers"]]


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


@pytest.mark.parametrize("rho, nonneg, iters", [
    (0.5, True, 2),     # every layer runs to nit
    (1e6, True, 1),     # the exit fires at iteration 0 (the first ends it)
    (0.5, False, 2),    # mixed signs: relu moves w, no exit
    (1e6, False, 1),    # mixed signs, small enough to exit on relu(w)
])
def test_twin_is_the_reference_fista_in_float64(rho, nonneg, iters):
    """In float64, with the power iteration run to a residual of 1e-12, the
    twin's chains, Gram eigenpairs and y = gamma C t are the reference's
    FISTA exactly (to 1e-10): the port's make_fista_constraint and the
    benchmark's reference, which form B and take SVDs."""
    ws = _stack(DIMS, 3, nonneg=nonneg)
    if not nonneg and rho > 1:
        ws = [w * 0.3 for w in ws]  # ||relu(w) - w|| < 30
    got, n = _twin(ws, DIMS, rho, nonneg=nonneg, tol=1e-12)
    want = _port(ws, rho)
    bench = ref_fista.fista_project(ws, rho, 2, 2.1)
    for a, b, c in zip(got, want, bench):
        assert _rel(a, b) < 1e-10 and _rel(c, b) < 1e-10
    m = len(ws)
    assert n[0] == m and n[1] == iters * m
    if iters == 1:
        assert n[2] == 0  # no power iteration: gamma is never needed
    changed = [not torch.equal(a, w) for a, w in zip(got, ws)]
    assert any(changed) == (iters == 2 or not nonneg)


def test_twin_fp32_agrees_with_the_float64_reference():
    """K7's precision (fp32 chains, fp64 Grams) at its default residual: the
    projected kernels within 1e-6 of the float64 reference's where the power
    iteration is run out, and within 2 SIGMA_AGREE (gamma's error where
    ||B_i||_2 is) at SIGMA_TOL."""
    ws = _stack(DIMS, 5)
    want = _port(ws, 0.5)
    for tol, bar in ((1e-12, 1e-6), (cf.SIGMA_TOL, 2 * cf.SIGMA_AGREE)):
        got, _ = _twin([w.float() for w in ws], DIMS, 0.5, tol=tol)
        for a, b in zip(got, want):
            assert _rel(a.double(), b) < bar


def test_sigma_b_agrees_with_the_float64_svd_at_the_digit_widths():
    """||B_i||_2 from the warm power iteration (one round riding in the
    chains, more where the residual is over SIGMA_TOL) within SIGMA_AGREE
    of the float64 SVD, at the published digit widths, over steps that each
    move every kernel as far as an Adam step does."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # beside the suite's other workers
    try:
        worst, seen = _sigma_b_worst(steps=4)
    finally:
        torch.set_num_threads(threads)
    assert seen >= 10 and worst < cf.SIGMA_AGREE


def _sigma_b_worst(steps):
    g = torch.Generator().manual_seed(9)
    ws = [w.float() for w in _stack(DIGIT, 7)]
    masters = _padded(ws, DIGIT)
    w16 = [m.to(torch.bfloat16) for m in masters]
    state = cf.fista_state(DIGIT, "cpu")
    worst, seen = 0.0, 0
    for _ in range(steps):
        for i, m in enumerate(masters):
            w = m[:DIGIT[i], :DIGIT[i + 1]]
            w.add_(1e-3 * torch.randn(w.shape, generator=g).sign()
                   * (w > 0)).clamp_min_(0.0)
        sig = []
        cf.fista_project_twin(masters, w16, state, DIGIT, 5.0, 2, 2.1,
                              True, sigmas=sig)
        for i, (_, sb) in enumerate(sig, start=1):
            b = torch.linalg.multi_dot([m[:DIGIT[j], :DIGIT[j + 1]].double()
                                        for j, m in enumerate(masters[:i])]
                                       ) if i > 1 else masters[0][
                :DIGIT[0], :DIGIT[1]].double()
            exact = float(torch.linalg.matrix_norm(b, 2))
            worst = max(worst, abs(sb - exact) / exact)
            seen += 1
    return worst, seen


def _data(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 40)).astype(np.float32)
    y = rng.integers(0, 8, n)
    d, n_true = pad_to_multiple(x, 64)
    lab, _ = pad_to_multiple(y.astype(np.int64), 64)
    return torch.from_numpy(d), torch.from_numpy(lab), n_true


CFG = mlp.MLPConfig(in_dim=40, n_classes=8, hidden=(32, 16), nonneg=True,
                    dropout=(0.0, 0.0))


@pytest.mark.parametrize("candidate", [None, "twin"])
def test_fused_fista_epoch_passes_the_gate_against_the_plain_epoch(
        candidate):
    """The fused epoch's twin with K7's arithmetic against the plain bf16
    epoch with make_fista_constraint, at the gate's bars (and, with the
    twin as candidate, the lockstep of every operation, K7's too)."""
    data, labels, n_true = _data(3 * 64 - 37, 3)
    g = ct.epoch_parity_vs_plain(
        CFG, 64, data, labels, n_true,
        candidate=ct._PlainOps if candidate else None,
        projection=("fista", 0.5, 2, 2.1))
    assert g["ok"], g
    assert g["max_dw"] < g["tol_param"] and g["max_dmu"] < g["tol_bn_mean"]
    if candidate:
        assert g["lockstep_steps"] and g["lockstep_worst"]["ulps"] <= 1.0


def test_gate_refuses_a_wrong_gamma_in_k7():
    """Fault g (gamma doubled) is refused by the lockstep at the step's
    projection."""
    data, labels, n_true = _data(3 * 64 - 37, 4)
    g = ct.epoch_parity_vs_plain(CFG, 64, data, labels, n_true,
                                 candidate=gf.candidate("g", "cpu"),
                                 projection=("fista", 0.5, 2, 2.1))
    assert not g["ok"] and "lockstep" in g["failed"]
    first = g["lockstep_first"]
    assert first["op"] == "projection" and first["step"] == 0
    assert first["q"].startswith("projected W")


def test_resolve_epoch_backend_admits_fista():
    """`auto` takes the fused epoch for FISTA at nit 1 or 2 on widths K7
    takes, on a CUDA device; nit 3 or the speaker widths stay plain, and
    `fused` refuses them. No tensor is made."""
    tcfg = tm.TrainConfig(batch_size=512, device_resident=True,
                          epoch_backend="auto")
    digit = mlp.MLPConfig.digit_constrained()
    for nit in (1, 2):
        tr = tm.Trainer(digit, tcfg, device="cuda",
                        constraint=make_fista_constraint(5.0, nit=nit).apply)
        assert tr._resolve_epoch_backend(fresh_opt=True) is True
    for cfg_, nit in ((digit, 3), (mlp.MLPConfig.speaker_constrained(), 2)):
        con = make_fista_constraint(5.0, nit=nit).apply
        tr = tm.Trainer(cfg_, tcfg, device="cuda", constraint=con)
        assert tr._resolve_epoch_backend(fresh_opt=True) is False
        tr = tm.Trainer(cfg_, tm.TrainConfig(
            batch_size=512, device_resident=True, epoch_backend="fused"),
            device="cuda", constraint=con)
        with pytest.raises(ValueError, match="FISTA"):
            tr._resolve_epoch_backend(fresh_opt=True)
    assert make_fista_constraint(5.0).apply._asrtpu_meta == {
        "rho": 5.0, "nit": 2, "alpha": 2.1}


def test_gate_key_separates_fista_from_simple_norm():
    """A FISTA fit and a simple_norm fit of the same rho never share a
    verdict; the simple_norm key is as it was."""
    cfg = mlp.MLPConfig.digit_constrained()
    sn = ct.FusedStepSpec(cfg=cfg, batch=512, rho=5.0, pi_iters=16)
    fi = ct.FusedStepSpec(cfg=cfg, batch=512, rho=5.0, pi_iters=16,
                          projection="fista")
    assert tm._gate_key(cfg, sn, "cpu") == (cfg, 512, 5.0, 16, "cpu")
    assert tm._gate_key(cfg, fi, "cpu") != tm._gate_key(cfg, sn, "cpu")
    assert tm._gate_key(cfg, ct.FusedStepSpec(
        cfg=cfg, batch=512, rho=5.0, pi_iters=16, projection="fista",
        nit=1), "cpu") != tm._gate_key(cfg, fi, "cpu")
    with pytest.raises(ValueError, match="projection"):
        ct.FusedStepSpec(cfg=cfg, batch=512, rho=5.0, projection="norm")


def test_fista_state_rides_in_the_packed_state():
    """pack_state adds K7's state under FISTA only; the simple_norm state is
    as it was."""
    params, state = mlp.init_mlp(CFG, torch.Generator().manual_seed(1),
                                 device="cpu")
    fi = ct.FusedStepSpec(cfg=CFG, batch=64, rho=0.5, projection="fista")
    sn = ct.FusedStepSpec(cfg=CFG, batch=64, rho=0.5)
    fs = ct.pack_state(fi, params, state)
    assert set(ct._FISTA_KEYS) <= set(fs)
    assert not set(ct._FISTA_KEYS) & set(ct.pack_state(sn, params, state))
    assert fs["fista_n"].tolist() == [0] * 4
    with pytest.raises(ValueError, match="K6"):
        from asr_using_robust_nn_tpu_torch.ops.cuda_step import \
            build_fused_step
        build_fused_step(fi)


@pytest.mark.cuda
def test_k7_matches_its_twin_on_the_card():
    """K7 against its twin, launch by launch from the same state, at the
    digit widths: projected kernels within 1e-6 relative (fp32 sums in
    another order), bf16 copies the cast of the masters, the same counters
    of projections and iterations."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    ws = [w.float() for w in _stack(DIGIT, 11)]
    masters = [m.to(dev) for m in _padded(ws, DIGIT)]
    w16 = [m.to(torch.bfloat16) for m in masters]
    state = cf.fista_state(DIGIT, dev)
    scratch = cf.fista_scratch(DIGIT, dev)
    cf.fista_preload(DIGIT)
    for _ in range(5):
        tm_ = [m.clone() for m in masters]
        t16 = [w.clone() for w in w16]
        ts = {k: v.clone() for k, v in state.items()}
        cf.fista_launch(masters, w16, state, scratch, DIGIT, 5.0, 2, 2.1,
                        True)
        torch.cuda.synchronize()
        cf.fista_project_twin(tm_, t16, ts, DIGIT, 5.0, 2, 2.1, True)
        for a, b in zip(masters, tm_):
            assert _rel(a.double(), b.double()) < 1e-6
        for a, m in zip(w16, masters):
            assert torch.equal(a, m.to(torch.bfloat16))
        assert state["n"][:2].tolist() == ts["n"][:2].tolist()
