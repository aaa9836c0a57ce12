"""h2d_ms.serve: the device time of the host-to-device copies per request
in the traced part. The engine's copy is from pageable memory, so its span
includes the CUDA runtime's staging through a pinned buffer."""


def read(run):
    if run.trace is None:
        return None
    reqs = len(run.facts["traced"]["requests"])
    copies = [s for name, (n, s) in run.trace["ops"].items()
              if "HtoD" in name]
    return 1e3 * sum(copies) / reqs if reqs and copies else None
