"""fit_epoch_ms: the window's fits' own seconds (each fit's `seconds`: its
epoch loop, without its set-up) over their epochs, in ms."""


def read(run):
    fits = [f for f in run.facts["fits"] if f["ok"]]
    epochs = sum(f["epochs"] for f in fits)
    return 1e3 * sum(f["seconds"] for f in fits) / epochs if epochs else None
