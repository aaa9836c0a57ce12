"""The check catches a broken timed path: each run drives a cell end to end
on the CPU at a tiny size (past the look for a card) with one fault planted
underneath, and `correct` must come out false on a number that the same run
without the fault passes. The fused epoch's parity gate is passed by hand
here, so that the benchmark's own check, and not the program's gate, is what
refuses the run. (On the CPU the program's plain twins run, whose readings
are not the card's: a tiny run is not held to pass every limit.)"""

import json

import pytest
import torch

from asr_using_robust_nn_tpu_torch.ops import cuda_train
from asr_using_robust_nn_tpu_torch.serve import engine as serve_engine
from h100bench import harness
from h100bench.tests.tiny import make_run


def _result(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


def _pass_gate(monkeypatch):
    monkeypatch.setattr(cuda_train, "epoch_parity_vs_plain",
                        lambda *a, **k: {"ok": True,
                                         "seconds": {"total": 0.0}})


def _break_epoch(monkeypatch, fault):
    orig = cuda_train.build_fused_epoch_call

    def build(spec, n_batches):
        run = orig(spec, n_batches)

        def broken(fstate, xs, ys, ws, seeds):
            if fault == "half_batch":
                ws = ws.clone()
                ws[:, ws.shape[1] // 2:] = 0.0
                return run(fstate, xs, ys, ws, seeds)
            _, losses, accs = run(fstate, xs, ys, ws, seeds)
            return fstate, losses, accs

        return broken

    monkeypatch.setattr(cuda_train, "build_fused_epoch_call", build)


def _failing(res):
    return {k for k, c in res["checks"].items()
            if not (c["value"] < c["limit"]
                    or c["limit"] == c["value"] == 0)}


@pytest.fixture(scope="module")
def unbroken():
    """The tiny runs without a fault, traced: {cell: result line}."""
    out = {}
    for cell in ("digit_constrained.train", "digit_constrained.serve"):
        with pytest.MonkeyPatch.context() as mp:
            _pass_gate(mp)
            lines = []
            mp.setattr("builtins.print", lambda *a, **k: lines.append(a)
                       if k.get("file") is None else None)
            assert harness.execute(make_run(cell, trace=1)) == 0
        out[cell] = json.loads(lines[-1][0])
    return out


def test_h100bench_unbroken_tiny_run_prints_its_checks(unbroken):
    for res in unbroken.values():
        assert set(res) == {"correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "checks"}
        assert list(res)[-1] == "checks" and res["failed"] == 0
        assert res["device"]["platform"] == "cpu"


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_h100bench_train_fault_is_not_correct(monkeypatch, capsys, unbroken,
                                              fault):
    _pass_gate(monkeypatch)
    _break_epoch(monkeypatch, fault)
    assert harness.execute(make_run("digit_constrained.train")) == 0
    res = _result(capsys)
    assert res["correct"] is False
    assert _failing(res) - _failing(unbroken["digit_constrained.train"])


def test_h100bench_served_answer_altered_is_not_correct(monkeypatch, capsys,
                                                        unbroken):
    orig = serve_engine.InferenceEngine._run_bucket

    def altered(self, waves, lengths):
        probs = orig(self, waves, lengths).clone()
        probs[0] = torch.roll(probs[0], 1)
        return probs

    monkeypatch.setattr(serve_engine.InferenceEngine, "_run_bucket", altered)
    assert harness.execute(make_run("digit_constrained.serve")) == 0
    res = _result(capsys)
    assert res["correct"] is False
    assert _failing(res) - _failing(unbroken["digit_constrained.serve"])
