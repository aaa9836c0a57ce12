"""The control at a size a test run can hold: the reference put in the
program's place one precision below what the configuration states (a float32
frontend, fp8 GEMM operands) fails a number of the cell's limits that the
program, on the same tiny corpus, passes. (The card's readings, from which
the limits were set, are in `limits/<cell>.json`.)"""

import json

import torch

from h100bench import control, harness
from h100bench.tests import tiny


def _failing(numbers, limits):
    return {k for k, lim in limits.items()
            if not (numbers[k] < lim or lim == numbers[k] == 0)}


def test_h100bench_control_is_not_correct():
    cell = "digit_constrained.train"
    limits = json.loads((harness.HERE / "limits" / f"{cell}.json")
                        .read_text())["limits"]
    rs = control.readings(cell, [2 ** 31 + 5], [2 ** 31 + 5], 0.3,
                          torch.device("cpu"), tweak=tiny.tweak,
                          emit=lambda r: None)
    got = {r["kind"]: r["numbers"] for r in rs}
    assert set(got) == {"program", "control", "control_mfcc",
                        "control_gemm", "half_batch", "unchanged"}
    assert _failing(got["control"], limits) - _failing(got["program"],
                                                      limits)
    for fault in ("half_batch", "unchanged"):
        assert _failing(got[fault], limits) - _failing(got["program"], limits)
