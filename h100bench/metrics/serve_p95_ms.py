"""serve_p95_ms: the 95th percentile of every request's latency in the
measured window, timed on the client's side around `classify` (the window
of the traced run, which is measured untraced before its traced part)."""

import numpy as np


def read(run):
    lat = run.facts.get("latencies_s")
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
