"""fista_iters_per_layer: the program's counters `fista.iterations` over
`fista.projections` of the traced fits (K7's, read once at each fit's end):
1 where every layer's projection exits at its first iteration, `nit` where
none does. Nothing where the program keeps no such counters."""

from h100bench.spans import traced_fits


def read(run):
    got = traced_fits(run)
    if got is None:
        return None
    _, counters, fits = got
    its = sum(counters.get(f, {}).get("fista.iterations", 0) for f in fits)
    proj = sum(counters.get(f, {}).get("fista.projections", 0) for f in fits)
    return its / proj if proj else None
