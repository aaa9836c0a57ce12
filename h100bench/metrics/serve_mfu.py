"""serve_mfu: the least time the chip's peaks allow for the window's work,
over the window: per real row the frontend's fixed work (fp64 real FFT and
|X|^2, fp32 mel product, the waves read and the mel written once) and the
MLP forward at fp32 (the engine's precision, TF32 off)."""

from h100bench.work import counts


def read(run):
    c, rows = run.config, run.facts["rows"]
    n_bytes, ops = counts.frontend_work(c["frontend"], rows)
    ops = dict(ops, fp32=ops["fp32"] + rows * counts.forward_flop(c["dims"]))
    return 100.0 * counts.bound_s(n_bytes, ops) / run.facts["window_s"]
