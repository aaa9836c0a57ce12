"""k7_roofline_pct: one FISTA projection's least work (work/fista_counts.py:
a step that exits at its first layer's first iteration, the fp32 masters
read once, the suffix chain and the first layer's n-row chain) times K7's
launches over K7's device time, in the traced part; nothing where the trace
holds no K7 kernel."""

from h100bench.trace import kernel_time
from h100bench.work import counts, fista_counts


def read(run):
    if run.trace is None:
        return None
    n, secs = kernel_time(run.trace, run.kernels("k7"))
    if not n:
        return None
    work = fista_counts.k7_work(run.config["dims"])
    return 100.0 * n * counts.bound_s(*work) / secs
