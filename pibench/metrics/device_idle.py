"""Share of the traced window in which the card ran nothing: 1 - (the
union of the window's device activity intervals) / (its wall time),
in %."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
