"""K3's share of its bound: the least time of every K3 launch in the
traced window (``pibench/bounds.py``), summed, over K3's device time in
the trace, in %."""


def read(run):
    t = run.trace
    if not t or not run.k3_launches or t["k3_device_s"] <= 0:
        return None
    return 100.0 * run.k3_bound_s / t["k3_device_s"]
