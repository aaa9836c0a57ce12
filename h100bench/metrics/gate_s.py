"""gate_s: the seconds of the fused epoch's parity gate in set-up, summed
over its parts (the program's `epoch_gate["seconds"]["total"]` of the fit
that ran it)."""


def read(run):
    return run.facts.get("gate_s")
