"""The port's small surface pieces on the CPU: the stateless spectral norms
(ops/spectral.py) against the JAX package's and the SVD, `python -m
asr_using_robust_nn_tpu_torch`, and the `profile` command.

Tolerances: the power iteration against the SVD 1e-3 relative (the JAX
suite's bar, tests/test_constraints.py); against the JAX function 1e-4
relative (the same iteration from different random starts; both have
converged at these n_iter).
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_using_robust_nn_tpu.ops import spectral as jspec
from asr_using_robust_nn_tpu_torch.cli.main import main
from asr_using_robust_nn_tpu_torch.ops import spectral

from conftest import product_norm_oracle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread keeps the file near its solo time under the suite's
    worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stack(rng, dims):
    return [(rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32)
            for a, b in zip(dims[:-1], dims[1:])]


def test_exported():
    assert {"spectral_norm", "product_spectral_norm"} <= set(spectral.__all__)
    assert {"spectral_norm", "product_spectral_norm"} <= set(jspec.__all__)


@pytest.mark.parametrize("shape", [(24, 16), (64, 10), (7, 33)])
def test_spectral_norm_vs_jax_and_svd(shape):
    rng = np.random.default_rng(shape[0])
    w = rng.standard_normal(shape).astype(np.float32)
    want = np.linalg.norm(w.astype(np.float64), ord=2)
    got = float(spectral.spectral_norm(torch.from_numpy(w), n_iter=64))
    jgot = float(jspec.spectral_norm(jnp.asarray(w), n_iter=64))
    assert abs(got / want - 1) < 1e-3
    assert abs(got / jgot - 1) < 1e-4
    # a given start vector is used
    u0 = torch.from_numpy(rng.standard_normal(shape[0]).astype(np.float32))
    warm = float(spectral.spectral_norm(torch.from_numpy(w), n_iter=64,
                                        u0=u0))
    assert abs(warm / want - 1) < 1e-3
    # zero rounds: the Rayleigh quotient of the start, below sigma
    assert float(spectral.spectral_norm(torch.from_numpy(w), n_iter=0,
                                        u0=u0)) <= want * (1 + 1e-6)


@pytest.mark.parametrize("dims", [(24, 16, 8, 4), (40, 32, 32, 10)])
def test_product_spectral_norm_vs_jax_and_svd(dims):
    rng = np.random.default_rng(len(dims) + dims[0])
    ws = _stack(rng, dims)
    want = product_norm_oracle(ws)
    got = spectral.product_spectral_norm([torch.from_numpy(w) for w in ws],
                                         n_iter=64)
    jgot = float(jspec.product_spectral_norm([jnp.asarray(w) for w in ws],
                                             n_iter=64))
    assert got.dim() == 0
    assert abs(float(got) / want - 1) < 1e-3
    assert abs(float(got) / jgot - 1) < 1e-4
    # the same cold start every call: a pure function of the kernels
    again = spectral.product_spectral_norm([torch.from_numpy(w) for w in ws],
                                           n_iter=64)
    assert torch.equal(got, again)


def test_python_m_runs_the_cli():
    env = dict(os.environ, PYTHONPATH=REPO)
    run = subprocess.run(
        [sys.executable, "-m", "asr_using_robust_nn_tpu_torch", "--help"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert run.returncode == 0, run.stderr
    for cmd in ("train-multi", "profile", "prepare-data", "attack"):
        assert cmd in run.stdout
    assert "bench" not in run.stdout


@pytest.mark.parametrize("variant", ["constrained", "unconstrained"])
def test_profile_writes_a_trace(variant, tmp_path, capsys):
    out = tmp_path / "trace"
    assert main(["profile", "--task", "digit", "--variant", variant,
                 "--out", str(out), "--steps", "2", "--batch-size", "16",
                 "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(line) == ["final_loss", "steps", "trace_dir"]
    assert line["trace_dir"] == str(out) and line["steps"] == 2
    assert np.isfinite(line["final_loss"])
    with open(out / "trace.json") as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any("mm" in n for n in names)  # the traced steps' GEMMs


def test_profile_refuses_zero_steps(tmp_path, capsys):
    assert main(["profile", "--out", str(tmp_path), "--steps", "0",
                 "--device", "cpu"]) == 2
    assert "--steps" in capsys.readouterr().err
