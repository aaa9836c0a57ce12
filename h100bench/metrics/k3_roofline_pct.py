"""k3_roofline_pct: the fused epoch's bound (the model operations of its
padded rows at bf16, or its inputs read once and outputs written once) over
the device time of K3's kernels per epoch, in the traced fit."""

from h100bench.trace import kernel_time
from h100bench.work import counts


def read(run):
    if run.trace is None:
        return None
    epochs = sum(f["epochs"] for f in run.facts["traced"]["fits"])
    n, secs = kernel_time(run.trace, run.kernels("k3"))
    if not n or not epochs:
        return None
    c = run.config
    n_batches = -(-c["corpus"]["train"] // c["batch_size"])
    b = counts.bound_s(*counts.k3_epoch_work(c["dims"], c["batch_size"],
                                             n_batches))
    return 100.0 * epochs * b / secs
