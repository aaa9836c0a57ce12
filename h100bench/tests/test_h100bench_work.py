"""The frozen counts, pinned by hand."""

import pytest

from asr_using_robust_nn_tpu_torch.ops import cuda_mfcc
from h100bench.work import counts

DIGIT = (880, 1024, 512, 256, 128, 64, 10)
SPEAKER = (2020, 1024, 512, 256, 128, 64, 20)
FE_DIGIT = {"sr": 22050, "width": 22050, "n_fft": 2048, "hop_length": 512,
            "win_length": 2048, "n_mels": 128}


def test_h100bench_row_flop():
    assert counts.step_flop(1, DIGIT) == 7_786_240
    assert counts.step_flop(1, SPEAKER) == 12_459_520
    assert counts.forward_flop(DIGIT) == 2 * 1_598_080


def test_h100bench_k3_epoch_bound():
    ms, by = counts.bound_ms(*counts.k3_epoch_work(DIGIT, 512, 33))
    assert by == "operations"
    assert ms == pytest.approx(0.1330, abs=5e-5)
    assert counts.k3_epoch_work(DIGIT, 512, 33)[1]["bf16"] == \
        33 * 512 * 7_786_240


def test_h100bench_k2_bound():
    n_bytes, ops = counts.k2_work(DIGIT, 16)
    assert n_bytes == 1_598_080 * 12
    assert ops == {"fp32": 34 * 2 * 1_598_080}
    ms, by = counts.bound_ms(n_bytes, ops)
    assert by == "bytes" and ms == pytest.approx(1_598_080 * 12 / 3.35e9)


@pytest.mark.parametrize("body", ["fft", "mixed", "dense"])
def test_h100bench_k1_work_is_one_per_preset(monkeypatch, body):
    """The same work whatever body `kernel_body` would launch."""
    want = counts.frontend_work(FE_DIGIT, 1024)
    monkeypatch.setattr(cuda_mfcc, "kernel_body", lambda cfg: body)
    assert counts.frontend_work(FE_DIGIT, 1024) == want
    n_bytes, ops = want
    assert n_bytes == 1024 * 22050 * 4 + 1024 * 44 * 128 * 4
    assert ops["fp64"] == 1024 * 44 * (2048 + 2.5 * 2048 * 11 + 3 * 1025)


def test_h100bench_bounds_take_the_larger():
    assert counts.bound_s(3.35e12, {}) == pytest.approx(1.0)
    assert counts.bound_s(0, {"bf16": 989e12, "fp32": 67e12}) == \
        pytest.approx(2.0)
