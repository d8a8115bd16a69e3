"""K1's share of its bound: the least time of every K1 launch in the
traced window (``pibench/bounds.py``), summed, over K1's device time in
the trace, in %."""


def read(run):
    t = run.trace
    if not t or not run.k1_launches or t["k1_device_s"] <= 0:
        return None
    return 100.0 * run.k1_bound_s / t["k1_device_s"]
