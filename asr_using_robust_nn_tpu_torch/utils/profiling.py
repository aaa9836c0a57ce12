"""Tracing, step timing and metric logging.

Counterpart of the JAX package's `utils/profiling.py`:

  trace(dir)     context manager around torch.profiler (CPU and, where a
                 card is present, CUDA activity); writes a Chrome trace
                 `trace.json` into `dir` (open it in Perfetto or
                 chrome://tracing)
  StepTimer      wall-clock steps/s and utterances/s counters
  MetricWriter   scalar logger: JSONL events {"tag", "value", "step",
                 "time"} in `metrics.jsonl` always, mirrored to TensorBoard
                 through torch.utils.tensorboard where that imports
"""

from __future__ import annotations

import contextlib
import json
import os
import time

__all__ = ["trace", "StepTimer", "MetricWriter"]


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler scope; on exit the trace is written to
    `<log_dir>/trace.json`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Throughput accounting: call tick(n_examples) once per step."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.t0 = time.perf_counter()
        self.steps = 0
        self.examples = 0

    def tick(self, n_examples: int):
        self.steps += 1
        self.examples += n_examples

    @property
    def seconds(self) -> float:
        return time.perf_counter() - self.t0

    @property
    def steps_per_sec(self) -> float:
        return self.steps / max(self.seconds, 1e-9)

    @property
    def examples_per_sec(self) -> float:
        return self.examples / max(self.seconds, 1e-9)

    def summary(self) -> dict:
        return {
            "steps": self.steps,
            "examples": self.examples,
            "seconds": self.seconds,
            "steps_per_sec": self.steps_per_sec,
            "utterances_per_sec": self.examples_per_sec,
        }


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
