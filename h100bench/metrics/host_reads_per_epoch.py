"""host_reads_per_epoch: the program's counters `trainer.host_reads` (each
blocking device-to-host read of the fit loop: a scalar, or a best
snapshot's leaf) over `trainer.epochs`, of the traced fits."""

from h100bench.spans import traced_fits


def read(run):
    got = traced_fits(run)
    if got is None:
        return None
    _, counters, fits = got
    reads = sum(counters.get(f, {}).get("trainer.host_reads", 0)
                for f in fits)
    epochs = sum(counters.get(f, {}).get("trainer.epochs", 0) for f in fits)
    return reads / epochs if epochs else None
