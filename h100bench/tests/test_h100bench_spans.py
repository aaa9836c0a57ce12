"""The per-layer metrics that read the program's own spans and counters
(`h100bench/spans.py`; `fit_setup_ms`, `epoch_idle_ms`,
`host_reads_per_epoch`): each reads a number in the tiny CPU traced runs
of both train cells, and the two that need a trace read nothing without
one; `epoch_idle_ms` reads nothing where the trace's list of idle owners
may have cut a loop span off. The fused epoch's parity gate is passed by hand, as in
test_h100bench_faults.py, to keep the runs short."""

import json
import types

import pytest
from torch.profiler import ProfilerActivity, profile

from asr_using_robust_nn_tpu_torch.ops import cuda_train
from asr_using_robust_nn_tpu_torch.utils import profiling
from h100bench import harness
from h100bench.trace import summarize
from h100bench.tests.tiny import make_run

CELLS = ("digit_constrained.train", "speaker_constrained.train")
READERS = ("fit_setup_ms", "epoch_idle_ms", "host_reads_per_epoch")


@pytest.fixture(scope="module")
def traced():
    """{cell: result line} of one tiny traced run a cell."""
    out = {}
    for cell in CELLS:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(cuda_train, "epoch_parity_vs_plain",
                       lambda *a, **k: {"ok": True,
                                        "seconds": {"total": 0.0}})
            lines = []
            mp.setattr("builtins.print", lambda *a, **k: lines.append(a)
                       if k.get("file") is None else None)
            assert harness.execute(make_run(cell, trace=1)) == 0
        out[cell] = json.loads(lines[-1][0])
    return out


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("cell", CELLS)
def test_h100bench_span_metric_reads_a_number(traced, cell, name):
    v = traced[cell]["metrics"][name]["value"]
    assert isinstance(v, float) and v >= 0.0
    if name == "host_reads_per_epoch":
        assert v >= 4.0  # loss, accuracy, val loss, val accuracy
    if name == "fit_setup_ms":
        assert v > 0.0


@pytest.mark.parametrize("name", ["fit_setup_ms", "epoch_idle_ms"])
@pytest.mark.parametrize("cell", CELLS)
def test_h100bench_span_metric_needs_a_trace(cell, name):
    run = make_run(cell)
    assert run.trace is None
    assert harness.load_metric_reader(name)(run) is None


def _idle_run(owners):
    """A run whose traced fit opened every loop span and whose trace holds
    one idle gap under each of `owners` (name, µs), a kernel between
    gaps, as `summarize` reduces it."""
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("trainer.fit", new_fit=True):
            for name in LOOP[1:]:
                with profiling.span(name):
                    pass
    events, t = [], 0.0
    for name, us in owners:
        events.append({"ph": "X", "cat": "user_annotation", "name": name,
                       "ts": t, "dur": us + 1.0})
        events.append({"ph": "X", "cat": "kernel", "name": "k",
                       "ts": t + us, "dur": 1.0})
        t += us + 1.0
    events.append({"ph": "X", "cat": "user_annotation", "name": "window",
                   "ts": 0.0, "dur": t})
    return types.SimpleNamespace(trace=summarize(events), facts={
        "traced": {"fits": [{"epochs": 2}]}})


LOOP = ("trainer.fit", "trainer.dispatch", "trainer.read",
        "trainer.validate", "trainer.snapshot")


@pytest.mark.parametrize("planted", [5, 6])
def test_h100bench_epoch_idle_ms_refuses_a_cut_list(planted):
    """Ten owners: every one is listed and the loop's idle is read. An
    eleventh (a planted span name) pushes the smallest, a loop span, off
    the summary's top ten: the reading is None, not a smaller number."""
    read = harness.load_metric_reader("epoch_idle_ms")
    loop = [(name, 100.0 * (k + 1)) for k, name in enumerate(LOOP)]
    planted = [(f"planted.{k}", 1000.0) for k in range(planted)]
    run = _idle_run(loop + planted)
    gaps = run.trace["breakdown"]["idle_gaps"]
    if len(loop + planted) <= 10:
        assert len(gaps) == 10
        assert read(run) == pytest.approx(1e3 * 1500e-6 / 2)
    else:
        assert len(gaps) == 10 and "trainer.fit" not in dict(gaps)
        assert read(run) is None
