"""fit_setup_ms: a traced fit's once-per-fit set-up, in ms: the program's
span `trainer.setup` (the split and validation set placed on the card, the
backend choice, the gate where it runs, the packed state, the eval program)
plus each `k3.capture` outside it (K3's buffers, kernel preload and graph
capture, at the fit's first dispatch), over the traced fits."""

from h100bench.spans import traced_fits

NAMES = ("trainer.setup", "k3.capture")


def _in_setup(spans, i) -> bool:
    p = spans[i].parent
    while p is not None:
        if spans[p].name == "trainer.setup":
            return True
        p = spans[p].parent
    return False


def read(run):
    got = traced_fits(run)
    if got is None:
        return None
    spans, _, fits = got
    ns = sum(s.end_ns - s.start_ns for i, s in enumerate(spans)
             if s.fit in fits and s.name in NAMES
             and not _in_setup(spans, i))
    return 1e-6 * ns / len(fits)
