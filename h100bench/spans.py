"""The program's own spans and counters of a run's traced part, for the
per-layer metrics that read them: the port records them while a torch
profiler records (`asr_using_robust_nn_tpu_torch/utils/profiling.py`), so
the traced part's fits are the table's last fits. A program without that
table (an older port) gives None."""

from __future__ import annotations


def traced_fits(run):
    """-> (spans, counters by fit id, [fit id of each traced fit]) or None
    where the run has no trace or the program recorded none of its fits."""
    if run.trace is None:
        return None
    from asr_using_robust_nn_tpu_torch.utils import profiling

    recorded = getattr(profiling, "recorded", None)
    if recorded is None:
        return None
    rec = recorded()
    fits = [s.fit for s in rec["spans"]
            if s.name == "trainer.fit" and s.parent is None]
    n = len(run.facts["traced"]["fits"])
    if not n or len(fits) < n:
        return None
    return rec["spans"], rec["counters"], fits[-n:]
