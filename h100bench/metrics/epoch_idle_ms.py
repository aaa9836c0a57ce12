"""epoch_idle_ms: the device's idle time in the traced window that the
trace names by the fit loop's spans (the innermost span holding each idle
gap's middle: `trainer.fit`'s own time, `trainer.dispatch`, `trainer.read`,
`trainer.validate`, `trainer.snapshot`), per epoch of the traced fits, in
ms. Set-up (`trainer.setup`, `k3.capture`) is `fit_setup_ms`'s.

The trace's summary keeps only its `IDLE_GAPS` largest owners. Where the
list is full and a loop span that the traced fits opened is not on it,
that span's idle may have been cut off, so the reading is None."""

from h100bench.spans import traced_fits

LOOP = ("trainer.fit", "trainer.dispatch", "trainer.read",
        "trainer.validate", "trainer.snapshot")
IDLE_GAPS = 10  # h100bench/trace.py::summarize's most_common(10)


def read(run):
    got = traced_fits(run)
    if got is None:
        return None
    spans, _, fits = got
    epochs = sum(f["epochs"] for f in run.facts["traced"]["fits"])
    if not epochs:
        return None
    gaps = dict(run.trace["breakdown"]["idle_gaps"])
    opened = {s.name for s in spans if s.fit in fits} & set(LOOP)
    if len(gaps) >= IDLE_GAPS and not opened <= gaps.keys():
        return None
    return 1e3 * sum(gaps.get(name, 0.0) for name in LOOP) / epochs
