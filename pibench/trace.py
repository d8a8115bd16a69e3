"""Readings of a ``torch.profiler`` trace of the measured window.

* Device busy time: the union of the window's device activity
  intervals (kernels, copies, sets), clipped to the window -- the
  method of the repository's chip smoke test (``device_busy_us``).
* Device time by operation name, and by kernel (K1, K3).
* The device's idle time, named by what the host was doing meanwhile:
  the harness's span of the call the runner was in (``tuning_cycle``,
  ``execute_batch``, ``execute``; ``runner`` outside them), summed by
  name.

The trace records the device's activity alone: its time stamps are
nanoseconds on the wall clock, which the harness's spans and the
window's marks (``time.time_ns()``) share.  The raw kineto events are
read directly.
"""

from collections import defaultdict

import numpy as np

K1_KERNEL = "stream_filter_agg_kernel"
K3_KERNEL = "masked_filter_agg_kernel"


def _blocks(a, b):
    """The union of intervals [a, b) as sorted disjoint (starts, ends)."""
    if not len(a):
        return a, b
    order = np.argsort(a, kind="stable")
    a, b = a[order], b[order]
    reach = np.maximum.accumulate(b)
    new = np.ones(len(a), bool)
    new[1:] = a[1:] > reach[:-1]
    starts = a[new]
    ends = reach[np.r_[np.flatnonzero(new)[1:] - 1, len(a) - 1]]
    return starts, ends


def _label(x, starts, ends, labels, none):
    """The label of the interval holding each time in ``x`` (sorted
    disjoint intervals), ``none`` outside them."""
    if not len(starts):
        return np.full(len(x), none)
    i = np.searchsorted(starts, x, side="right") - 1
    ok = (i >= 0) & (x < ends[np.maximum(i, 0)])
    out = np.full(len(x), none)
    out[ok] = labels[i[ok]]
    return out


def summarize(prof, t0_ns: int, t1_ns: int, spans, top: int = 10) -> dict:
    """``spans``: the harness's (start ns, end ns, call) host spans,
    which do not overlap (the runner fires due cycles between its
    calls, never inside one)."""
    from torch.autograd import DeviceType

    cuda = DeviceType.CUDA
    dev, by_op = [], defaultdict(int)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        a = e.start_ns()
        b = a + e.duration_ns()
        if b <= t0_ns or a >= t1_ns:
            continue
        name = e.name()
        if e.is_user_annotation() or name.startswith("aten::"):
            continue
        a, b = max(a, t0_ns), min(b, t1_ns)
        dev.append((a, b))
        by_op[name] += b - a
    dev = np.array(dev, np.int64).reshape(-1, 2)
    starts, ends = _blocks(dev[:, 0], dev[:, 1])
    busy = int((ends - starts).sum())
    # Idle time, cut at the spans' boundaries.
    gap_a = np.r_[t0_ns, ends]
    gap_b = np.r_[starts, t1_ns]
    keep = gap_b > gap_a
    gap_a, gap_b = gap_a[keep], gap_b[keep]
    names = sorted({n for _, _, n in spans}) + ["runner"]
    sp = np.array([(a, b, names.index(n)) for a, b, n in sorted(spans)],
                  np.int64).reshape(-1, 3)
    cuts = np.unique(np.r_[gap_a, gap_b, sp[:, 0], sp[:, 1]])
    cuts = cuts[(cuts >= t0_ns) & (cuts <= t1_ns)]
    x, w = cuts[:-1], np.diff(cuts)
    idle = _label(x, gap_a, gap_b, np.ones(len(gap_a), np.int64), 0) > 0
    lab = _label(x[idle], sp[:, 0], sp[:, 1], sp[:, 2], len(names) - 1)
    sums = np.bincount(lab, weights=w[idle], minlength=len(names))
    idle_by = {n: int(v) for n, v in zip(names, sums) if v > 0}

    def ranked(d):
        return [[k[:96], v / 1e9] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:top]]

    def kernel_s(key):
        return sum(v for k, v in by_op.items() if key in k) / 1e9

    return dict(
        busy_s=busy / 1e9,
        window_s=(t1_ns - t0_ns) / 1e9,
        device_ops=ranked(by_op),
        idle_gaps=ranked(idle_by),
        k1_device_s=kernel_s(K1_KERNEL),
        k3_device_s=kernel_s(K3_KERNEL),
        device_events=len(dev),
    )
