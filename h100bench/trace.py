"""The traced part of a run: the traffic's traced work under torch.profiler
(CPU and CUDA activities), reduced to what the per-layer metrics read.

The profiler's chrome trace is written to a temporary file (under TMPDIR),
read back and deleted. Device activity is every kernel, copy and memset; the
traced window is the benchmark's own `window` span. Idle time is the part of
the window in which the device runs none of them, and each idle gap is named
by the innermost span of the benchmark's own that holds its middle.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def traced(fn):
    """-> (fn's result, the trace's summary) with `fn` run under the
    profiler inside the span `window`."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function("window"):
            result = fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return result, summarize(events)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events: list) -> dict:
    """{"window_s", "busy_s", "ops": {name: [count, seconds]}, "breakdown":
    {"device_ops", "idle_gaps"}} from chrome-trace events."""
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    win = [e for e in spans if e["name"] == "window"]
    if not win:
        raise RuntimeError("the trace holds no `window` span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    ops = collections.defaultdict(lambda: [0, 0.0])
    busy = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if b <= a:
            continue
        ops[e["name"]][0] += 1
        ops[e["name"]][1] += (b - a) * 1e-6
        busy.append((a, b))
    merged = _merge(busy)
    busy_s = sum(b - a for a, b in merged) * 1e-6
    inner = sorted((e for e in spans if e["name"] != "window"),
                   key=lambda e: float(e["dur"]))
    idle = collections.Counter()
    t = w0
    for a, b in merged + [[w1, w1]]:
        if a > t:
            mid = 0.5 * (t + a)
            owner = next((e["name"] for e in inner
                          if float(e["ts"]) <= mid
                          <= float(e["ts"]) + float(e["dur"])), "window")
            idle[owner] += (a - t) * 1e-6
        t = max(t, b)
    top = sorted(ops.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_s,
        "ops": {k: list(v) for k, v in ops.items()},
        "breakdown": {
            "device_ops": [[k[:200], v[1]] for k, v in top],
            "idle_gaps": [[k, s] for k, s in idle.most_common(10)],
        },
    }


def kernel_time(summary: dict, table: dict) -> tuple[int, float]:
    """(launches, seconds) of the device kernels a kernel table names: a
    name holding one of its `match` fragments and none of its `exclude`."""
    n, s = 0, 0.0
    for name, (count, secs) in summary["ops"].items():
        if any(f in name for f in table["match"]) and not any(
                f in name for f in table.get("exclude", ())):
            n += count
            s += secs
    return n, s
