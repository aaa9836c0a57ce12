"""The port's program spans and counters (asr_using_robust_nn_tpu_torch/
utils/profiling.py) in `Trainer.fit`, K3's capture and
`InferenceEngine.classify`: off, nothing is recorded and no
`record_function` is entered; on, under any torch profiler, each span has
its parent and its fit, the counters count what was done by fit, and the
spans are in the profiler's trace.

No JAX here, so that the `cuda`-marked test runs on a card alone:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py
"""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from asr_using_robust_nn_tpu_torch.models import mlp
from asr_using_robust_nn_tpu_torch.train import trainer as trainer_mod
from asr_using_robust_nn_tpu_torch.train.trainer import TrainConfig, Trainer
from asr_using_robust_nn_tpu_torch.utils import profiling

KW = dict(in_dim=20, n_classes=4, hidden=(32, 16), nonneg=True,
          dropout=(0.0, 0.0))
FIT_EPOCH = ["trainer.dispatch", "trainer.read", "trainer.validate"]


def _blobs(n=160, d=20, k=4, seed=7):
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((k, d)) * 3.0
    y = rng.integers(0, k, n)
    return (means[y] + rng.standard_normal((n, d))).astype(np.float32), y


def _trainer(device="cpu", epochs=2):
    return Trainer(mlp.MLPConfig(**KW), TrainConfig(
        batch_size=64, epochs=epochs, patience=epochs, device_resident=True,
        epoch_backend="fused"), device=device)


def _children(spans, i):
    return [s.name for s in spans if s.parent == i]


@pytest.fixture
def fresh_gate(monkeypatch):
    """No parity verdict cached in the process: the next fused fit gates."""
    monkeypatch.setattr(trainer_mod, "_FUSED_EPOCH_GATE", {})


def test_span_off_records_nothing_and_enters_no_record_function(
        monkeypatch, fresh_gate):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered while off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    profiling.clear()
    assert profiling.span("a") is profiling.span("b", new_fit=True)
    x, y = _blobs()
    _trainer().fit(x[:128], y[:128], x[128:], y[128:])
    profiling.count("trainer.epochs")
    assert profiling.recorded() == {"spans": [], "counters": {}}


def test_fused_fit_records_its_span_tree(tmp_path, fresh_gate):
    """Two 2-epoch fused fits (the twin, on the CPU) under the profiler:
    one root and one fit id a fit, a set-up with no span of its own (the
    first fit's holds the parity gate, timed by its `seconds`), per epoch
    a dispatch, a read and a validation, a snapshot per improvement; the
    counters match, by fit; the trace holds every span."""
    x, y = _blobs()
    tr = _trainer()
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = [tr.fit(x[:128], y[:128], x[128:], y[128:]) for _ in range(2)]
    rec = profiling.recorded()
    spans = rec["spans"]
    roots = [i for i, s in enumerate(spans) if s.parent is None]
    assert [spans[i].name for i in roots] == ["trainer.fit"] * 2
    fits = [spans[i].fit for i in roots]
    assert fits[1] == fits[0] + 1
    for k, (i, r) in enumerate(zip(roots, res)):
        want, best, snaps = ["trainer.setup"], np.inf, 0
        for v in r["history"]["val_loss"]:
            want += FIT_EPOCH
            if v < best:
                best, snaps = v, snaps + 1
                want.append("trainer.snapshot")
        assert _children(spans, i) == want
        setup = next(j for j, s in enumerate(spans)
                     if s.parent == i and s.name == "trainer.setup")
        assert _children(spans, setup) == []
        mine = [s for s in spans if s.fit == fits[k]]
        end = roots[k + 1] if k + 1 < len(roots) else len(spans)
        assert len(mine) == end - i
        assert all(s.start_ns <= s.end_ns for s in mine)
        leaves = sum(len(layer) for tree in ("best_params", "best_state")
                     for layer in r[tree]["layers"])
        assert rec["counters"][fits[k]] == {
            "trainer.epochs": 2,
            "trainer.host_reads": 2 * 4 + snaps * leaves}
    assert rec["counters"].keys() == set(fits)
    assert "k3.capture" not in {s.name for s in spans}  # the twin's epoch
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    annotated = {e["name"] for e in events
                 if e.get("cat") == "user_annotation"}
    assert {s.name for s in spans} <= annotated


def test_counters_are_kept_by_fit():
    """A count goes to the fit of the innermost open span, None outside any
    fit; a span still open has no end."""
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("c")
        with profiling.span("outer"):
            profiling.count("c", 2)
            with profiling.span("f", new_fit=True):
                with profiling.span("inner"):
                    profiling.count("c", 3)
                    assert profiling.recorded()["spans"][-1].end_ns is None
                profiling.count("d")
            with profiling.span("g", new_fit=True):
                profiling.count("c", 5)
    rec = profiling.recorded()
    spans = rec["spans"]
    assert [(s.name, s.parent) for s in spans] == [
        ("outer", None), ("f", 0), ("inner", 1), ("g", 0)]
    f, g = spans[1].fit, spans[3].fit
    assert spans[0].fit is None and spans[2].fit == f and g == f + 1
    assert rec["counters"] == {None: {"c": 3}, f: {"c": 3, "d": 1},
                               g: {"c": 5}}
    assert all(s.start_ns <= s.end_ns for s in spans)


def test_profiling_trace_clears_the_table(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("old"):
            profiling.count("old")
    with profiling.trace(str(tmp_path)):
        with profiling.span("new", new_fit=True):
            profiling.count("new", 3)
    rec = profiling.recorded()
    assert [s.name for s in rec["spans"]] == ["new"]
    assert rec["counters"] == {rec["spans"][0].fit: {"new": 3}}


def test_engine_latency_covers_pack_and_its_spans(monkeypatch):
    """`latency_s` (and `latencies_s`) time what the caller waits for,
    `_pack` included; traced, the call is `engine.classify` holding
    `engine.pack` and per chunk `engine.bucket`, `engine.read`."""
    from asr_using_robust_nn_tpu_torch.ops.mfcc_torch import FrontendConfig
    from asr_using_robust_nn_tpu_torch.serve.engine import InferenceEngine

    cfg = mlp.MLPConfig.digit_constrained()
    params, state = mlp.init_mlp(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    eng = InferenceEngine(cfg, FrontendConfig.digit(), params, state,
                          buckets=(4,), device="cpu", backend="plain")
    waves = np.zeros((6, eng.wave_width), np.float32)
    eng.classify(waves)  # cold: bucket 4 warms
    pack = eng._pack

    def slow_pack(w, lengths):
        time.sleep(0.2)
        return pack(w, lengths)

    monkeypatch.setattr(eng, "_pack", slow_pack)
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        out = eng.classify(waves)
    assert out["latency_s"] >= 0.2 and eng.latencies_s == [out["latency_s"]]
    spans = profiling.recorded()["spans"]
    assert spans[0].name == "engine.classify" and spans[0].parent is None
    assert _children(spans, 0) == ["engine.pack"] + [
        "engine.bucket", "engine.read"] * 2


@pytest.mark.cuda
def test_k3_captures_once_a_fit_on_the_card():
    """On the card each fused fit builds K3's graph once: one `k3.capture`
    span a fit, under its first dispatch (the gate, which captures its
    own, ran in an untraced first fit)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    x, y = _blobs()
    tr = _trainer(device=dev, epochs=3)
    tr.fit(x[:128], y[:128], x[128:], y[128:])
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(2):
            assert tr.fit(x[:128], y[:128], x[128:], y[128:])[
                "epoch_backend"] == "fused"
    rec = profiling.recorded()
    spans = rec["spans"]
    fits = [s.fit for s in spans if s.name == "trainer.fit"]
    caps = [s for s in spans if s.name == "k3.capture"]
    assert len(fits) == 2 and [s.fit for s in caps] == fits
    for s in caps:
        assert spans[s.parent].name == "trainer.dispatch"
        assert spans[s.parent] == next(
            d for d in spans if d.fit == s.fit and d.name == "trainer.dispatch")
        assert rec["counters"][s.fit]["trainer.epochs"] == 3
