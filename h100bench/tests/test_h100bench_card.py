"""The benchmark on the card: each cell runs briefly, traced and untraced,
and comes out correct with every metric it must report. Needs an NVIDIA
GPU; skips without one:

    python -m pytest -m cuda h100bench/tests/test_h100bench_card.py
"""

import json
import subprocess
import sys

import pytest

from h100bench import harness

pytestmark = pytest.mark.cuda
M = harness.load_manifest()


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_h100bench_cell_runs_correct(card, cell, trace):
    res = subprocess.run(
        [sys.executable, "h100bench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 99), "--seconds", "3", "--trace", str(trace)],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=360)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["failed"] == 0
    entries = harness.cell_entries(M, cell)
    want = entries["per_layer" if trace else "end_to_end"]
    assert {m["name"] for m in want} <= set(out["metrics"])
    assert out["device"]["platform"] == "gpu"
