"""Tracing, program spans and counters, and metric logging.

Counterpart of the JAX package's `utils/profiling.py`:

  trace(dir)     context manager around torch.profiler (CPU and, where a
                 card is present, CUDA activity); writes a Chrome trace
                 `trace.json` into `dir` (open it in Perfetto or
                 chrome://tracing)
  span(name)     a program span: while any torch profiler records (`trace`,
                 a benchmark's own, a user's), a `record_function` of that
                 name, so the span lands on the trace's timeline beside the
                 device's kernels, and a row in the span table; else a
                 shared no-op context after one check
  count(name, n) a program counter in the same table, while recording
  recorded()     the table: {"spans": [Span], "counters": {fit: {name: n}}}
                 (fit None: counts outside any fit)
  MetricWriter   scalar logger: JSONL events {"tag", "value", "step",
                 "time"} in `metrics.jsonl` always, mirrored to TensorBoard
                 through torch.utils.tensorboard where that imports

A span opened with `new_fit=True` (`Trainer.fit`) starts a fit: it and
every span and count under it carry its fit id. The table is the process's
own (one trainer thread); `trace` clears it on entry.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import NamedTuple

import torch
from torch._C._autograd import _profiler_enabled

__all__ = ["trace", "span", "count", "recorded", "clear", "Span",
           "MetricWriter"]


class Span(NamedTuple):
    """One recorded span: `parent` is the index of the span that held it
    in `recorded()["spans"]` (None at a root), `fit` the fit it belongs to
    (None outside any fit); times are `time.perf_counter_ns()`, `end_ns`
    None while the span is open."""

    name: str
    start_ns: int
    end_ns: int | None
    parent: int | None
    fit: int | None


class _Table:
    def __init__(self):
        self.fits = 0  # fit ids stay unique across clear()
        self.clear()

    def clear(self):
        self.spans: list[Span] = []
        self.open: list[int] = []  # indices into `spans`, innermost last
        self.counters: dict[int | None, dict[str, int]] = {}


_TABLE = _Table()


class _On:
    """A span while a profiler records."""

    __slots__ = ("name", "new_fit", "rf", "i")

    def __init__(self, name: str, new_fit: bool):
        self.name = name
        self.new_fit = new_fit

    def __enter__(self):
        t = _TABLE
        parent = t.open[-1] if t.open else None
        if self.new_fit:
            t.fits += 1
            fit = t.fits
        else:
            fit = None if parent is None else t.spans[parent].fit
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.i = len(t.spans)
        t.spans.append(Span(self.name, time.perf_counter_ns(), None, parent,
                            fit))
        t.open.append(self.i)
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        t = _TABLE
        if t.open and t.open[-1] == self.i:  # not cleared while open
            t.open.pop()
            t.spans[self.i] = t.spans[self.i]._replace(end_ns=end)
        return self.rf.__exit__(*exc)


_OFF = contextlib.nullcontext()


def span(name: str, new_fit: bool = False):
    """A program span named `name` (see the module's docstring)."""
    if not _profiler_enabled():
        return _OFF
    return _On(name, new_fit)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` of the open fit (None outside any
    fit), while a profiler records."""
    if not _profiler_enabled():
        return
    t = _TABLE
    mine = t.counters.setdefault(
        t.spans[t.open[-1]].fit if t.open else None, {})
    mine[name] = mine.get(name, 0) + n


def recorded() -> dict:
    """A copy of the span and counter table."""
    t = _TABLE
    return {"spans": list(t.spans),
            "counters": {k: dict(v) for k, v in t.counters.items()}}


def clear() -> None:
    """Empty the span and counter table."""
    _TABLE.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler scope; on exit the trace is written to
    `<log_dir>/trace.json`. The span table is cleared on entry, so that
    `recorded()` afterwards holds this trace's spans."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    clear()
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class MetricWriter:
    """Scalar metric logger: JSONL always; TensorBoard when available."""

    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        self.log_dir = str(log_dir)
        os.makedirs(self.log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(self.log_dir)
            except Exception:
                self._tb = None

    def scalar(self, tag: str, value: float, step: int):
        self._jsonl.write(
            json.dumps({"tag": tag, "value": float(value), "step": int(step),
                        "time": time.time()}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), global_step=int(step))

    def scalars(self, values: dict, step: int):
        for tag, v in values.items():
            self.scalar(tag, v, step)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
