"""The comparison rule of `tools/compare_study_arms.py`, which holds the thesis
studies' arms (the archive, the JAX package on a CPU, the port's plain and K3
epochs) to one another scalar by scalar: the F3 rule of
`tests/test_torch_train_multi.py::test_dropout_seed_mean_accuracy_vs_jax`,
`|mean_a - mean_b| < max(4 s sqrt(2/n), 2/n_test)` at equal seed counts, with
an arm of one run adding no spread and the Lipschitz-type scalars compared on
log10 with a floor of log10(1.5)."""

import math
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import compare_study_arms as arms  # noqa: E402


def test_equal_seed_counts_give_the_f3_rule():
    a, b = [0.90, 0.92, 0.94], [0.80, 0.83, 0.86]
    s = math.sqrt((np.var(a, ddof=1) + np.var(b, ddof=1)) / 2)
    gap, bar, ok = arms.within(a, b, log=False, n_test=100)
    assert gap == pytest.approx(0.09)
    assert bar == pytest.approx(max(4 * s * math.sqrt(2 / 3), 0.02))
    assert ok == (0.09 < bar)


def test_floor_and_single_runs():
    # no spread at all: the floor 2 / n_test decides
    assert arms.within([0.5], [0.5 + 0.019], False, 100)[2]
    assert not arms.within([0.5], [0.5 + 0.021], False, 100)[2]
    # an arm of one run adds no spread; the other arm's spread counts with
    # sqrt(1/1 + 1/3)
    gap, bar, _ = arms.within([1.0], [0.9, 1.0, 1.1], False, 1000)
    assert gap == pytest.approx(0.0, abs=1e-12)
    assert bar == pytest.approx(4 * 0.1 * math.sqrt(1 + 1 / 3))


def test_log_scalars_compare_orders_of_magnitude():
    # a factor 1.4 passes the log10(1.5) floor, 1.6 does not, whatever the
    # size of the values
    for base in (1e-3, 1.0, 1e6):
        assert arms.within([base], [1.4 * base], True, 100)[2]
        assert not arms.within([base], [1.6 * base], True, 100)[2]


def test_scalars_of_a_study_record():
    res = {"clean": {"unconstrained": 1.0, "constrained": 0.9},
           "lipschitz": {"unconstrained": 3.0, "constrained": 0.3},
           "median_margin": {"unconstrained": 9.0, "constrained": 5.0},
           "curves": {"fgsm": {"strengths": [0.1, 0.2],
                               "accuracy_constrained": [0.8, 0.5],
                               "accuracy_unconstrained": [0.9, 0.7]}}}
    got = arms._study_scalars(res)
    assert got["clean c"] == 0.9 and got["lipschitz u"] == 3.0
    assert got["fgsm 0.2 c"] == 0.5 and got["fgsm 0.1 u"] == 0.9
    assert len(got) == 10
