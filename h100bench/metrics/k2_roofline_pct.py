"""k2_roofline_pct: one projection's bound (the chained matvecs of n_iter
rounds; the kernels read once, and in the fused epoch the masters read and
written by the rescale in the same launch) over K2's device time per launch,
in the traced part."""

from h100bench.trace import kernel_time
from h100bench.work import counts


def read(run):
    if run.trace is None:
        return None
    n, secs = kernel_time(run.trace, run.kernels("k2"))
    if not n:
        return None
    c = run.config
    fused = run.traffic["epoch_backend"] != "plain"
    work = counts.k2_work(c["dims"], c["n_iter"], fused)
    return 100.0 * n * counts.bound_s(*work) / secs
