"""k1_roofline_pct: K1's bound per launch (one fixed work per preset, at the
rows of the bucket it ran) over its device time, in the traced part. Each
traced request launches K1 once (requests never exceed the largest bucket);
where the trace holds another count the metric is left out."""

from h100bench.trace import kernel_time
from h100bench.work import counts


def read(run):
    if run.trace is None:
        return None
    reqs = run.facts["traced"]["requests"]
    n, secs = kernel_time(run.trace, run.kernels("k1"))
    if not n or n != len(reqs):
        return None
    buckets = run.traffic["buckets"]
    fe = run.config["frontend"]
    bound = sum(counts.bound_s(*counts.frontend_work(
        fe, next(b for b in buckets if b >= r["rows"]))) for r in reqs)
    return 100.0 * bound / secs
