"""The program's own spans and counters, read beside the device trace.

``repro_torch.telemetry`` records the program's spans (name, start and
end on ``time.time_ns()``, parent) and counters.  A ``torch.profiler``
trace of the same window, even one that records the device's activity
alone, also holds the CUDA runtime's calls on the host: kernel
launches, synchronisations, copies, each with the correlation id that
the device activity it started carries.  ``summarize`` puts each such
call under the innermost program span open when it was made, each
device activity under the span of the call that started it, and each
stretch of the card's idle time under the innermost span the host was
in, and sums by span name:

* ``wall_s``: the spans' wall time;
* ``launches``: kernel launches (``cudaLaunchKernel``,
  ``cuLaunchKernel``, ...);
* ``syncs``: host waits on the device: a stream, device or event
  synchronise, a synchronous copy, or an asynchronous copy to the host
  that no synchronise follows (PyTorch's reads to the host are a copy
  and a synchronise, counted once);
* ``device_s``: device time of the activity those calls started;
* ``idle_s``: the card's idle time while the host was in the span.

Each comes twice: ``self`` (the span's own, its children's left out)
and ``total`` (its children's included; a name nested in itself counts
once).  ``metrics`` turns a summary into the per-layer metrics that read
the program's spans and counters.  The runtime calls and device activity
are read by the program's own ``telemetry.read_events``, which
``telemetry.kernels_under`` (the port's smoke script's reader) uses too.
"""

from __future__ import annotations

from collections import Counter, defaultdict

import numpy as np

from pibench.trace import _blocks, _label
from repro_torch.telemetry import read_events

SYNC_CALLS = frozenset({
    "cudaStreamSynchronize", "cudaDeviceSynchronize",
    "cudaEventSynchronize", "cuStreamSynchronize", "cuCtxSynchronize",
    "cuEventSynchronize"})
SYNC_COPIES = frozenset({"cudaMemcpy", "cuMemcpyDtoH", "cuMemcpyDtoH_v2"})
FIELDS = ("wall_s", "launches", "syncs", "device_s", "idle_s")


def is_launch(name: str) -> bool:
    return ("LaunchKernel" in name or "LaunchCooperativeKernel" in name
            or name.startswith(("cudaGraphLaunch", "cuGraphLaunch")))


def _segments(spans):
    """Disjoint (start, end, span index) pieces of time, each under the
    innermost span open then; spans nest on one thread.  A span still
    open, or of no length, takes no time."""
    marks = []
    for i, s in enumerate(spans):
        if s.end_ns is not None and s.end_ns > s.start_ns:
            # At one instant: ends before starts, inner ends first,
            # outer starts first.
            marks.append((s.start_ns, 1, i))
            marks.append((s.end_ns, 0, -i))
    marks.sort()
    out, stack, prev = [], [], None
    for t, opening, i in marks:
        if stack and t > prev:
            out.append((prev, t, stack[-1]))
        if opening:
            stack.append(i)
        elif stack and stack[-1] == -i:
            stack.pop()
        elif -i in stack:
            stack.remove(-i)
        prev = t
    seg = np.array(out, np.int64).reshape(-1, 3)
    return seg[:, 0], seg[:, 1], seg[:, 2]


def _syncs(rt, dtoh_corr):
    """Which runtime calls are host waits (see the module's note)."""
    out = np.zeros(len(rt), bool)
    for k, (_, name, corr) in enumerate(rt):
        if name in SYNC_CALLS or name in SYNC_COPIES:
            out[k] = True
        elif "Memcpy" in name and "Async" in name and corr in dtoh_corr:
            nxt = rt[k + 1][1] if k + 1 < len(rt) else ""
            out[k] = nxt not in SYNC_CALLS
    return out


def summarize(program, events, t0_ns: int, t1_ns: int, outer=()) -> dict:
    """``program``: a drained ``telemetry.Trace``; ``events``: the
    window's kineto events (none without a device trace); ``outer``:
    (start, end, name) spans of the caller's own that do not overlap,
    under which the idle time is split by program span as well."""
    spans = program.spans
    n = len(spans)
    seg_a, seg_b, seg_i = _segments(spans)
    dev, rt = read_events(events, t0_ns, t1_ns)
    per = {f: np.zeros(n + 1) for f in FIELDS}  # index n: no span

    def lab(x):
        li = _label(np.asarray(x, np.int64), seg_a, seg_b, seg_i, -1)
        return np.where(li < 0, n, li)

    np.add.at(per["wall_s"], seg_i, (seg_b - seg_a) / 1e9)
    rt_lab = lab([r[0] for r in rt]) if rt else np.zeros(0, np.int64)
    launch = np.array([is_launch(r[1]) for r in rt], bool)
    dtoh = {c for _, _, c, name in dev if "DtoH" in name}
    sync = _syncs(rt, dtoh)
    np.add.at(per["launches"], rt_lab[launch], 1)
    np.add.at(per["syncs"], rt_lab[sync], 1)
    by_corr = {r[2]: int(li) for r, li in zip(rt, rt_lab)}
    for a, b, corr, _ in dev:
        per["device_s"][by_corr.get(corr, n)] += (b - a) / 1e9

    # Idle time, cut at the spans' (and the outer spans') boundaries.
    d = np.array([(a, b) for a, b, _, _ in dev], np.int64).reshape(-1, 2)
    starts, ends = _blocks(d[:, 0], d[:, 1])
    gap_a, gap_b = np.r_[t0_ns, ends], np.r_[starts, t1_ns]
    keep = gap_b > gap_a
    gap_a, gap_b = gap_a[keep], gap_b[keep]
    names_out = sorted({nm for _, _, nm in outer})
    out_sp = np.array([(a, b, names_out.index(nm)) for a, b, nm in
                       sorted(outer)], np.int64).reshape(-1, 3)
    cuts = np.unique(np.r_[gap_a, gap_b, seg_a, seg_b, out_sp[:, 0],
                           out_sp[:, 1]])
    cuts = cuts[(cuts >= t0_ns) & (cuts <= t1_ns)]
    x, w = cuts[:-1], np.diff(cuts)
    idle = _label(x, gap_a, gap_b, np.ones(len(gap_a), np.int64), 0) > 0
    x, w = x[idle], w[idle] / 1e9
    x_lab = lab(x)
    np.add.at(per["idle_s"], x_lab, w)
    x_out = _label(x, out_sp[:, 0], out_sp[:, 1], out_sp[:, 2], -1)
    m = x_out >= 0
    by_outer = np.zeros((len(names_out), n + 1))
    np.add.at(by_outer, (x_out[m], x_lab[m]), w[m])
    within = defaultdict(lambda: defaultdict(float))
    for o, i in zip(*np.nonzero(by_outer)):
        inner = spans[i].name if i < n else "-"
        within[names_out[o]][inner] += float(by_outer[o, i])

    # By name: self sums, and totals over each span's chain of names.
    by_name = {}
    tree = defaultdict(lambda: defaultdict(lambda: [0, 0.0]))
    chain: list = [None] * n
    for i, s in enumerate(spans):
        p = s.parent if 0 <= s.parent < i else -1
        up = chain[p] if p >= 0 else ()
        chain[i] = up if s.name in up else up + (s.name,)
        rec = by_name.setdefault(s.name, {
            "n": 0, "self": dict.fromkeys(FIELDS, 0.0),
            "total": dict.fromkeys(FIELDS, 0.0)})
        rec["n"] += 1
        for f in FIELDS:
            v = float(per[f][i])
            rec["self"][f] += v
            if v:
                for nm in chain[i]:
                    by_name[nm]["total"][f] += v
        if s.end_ns is not None:
            node = tree[spans[p].name if p >= 0 else "-"][s.name]
            node[0] += 1
            node[1] += (s.end_ns - s.start_ns) / 1e9
    return {
        "window_s": (t1_ns - t0_ns) / 1e9,
        "spans": by_name,
        "outside": {f: float(per[f][n]) for f in FIELDS if f != "wall_s"},
        "tree": {p: {c: list(v) for c, v in ch.items()}
                 for p, ch in tree.items()},
        "idle_within": {o: dict(v) for o, v in within.items()},
        "counts": dict(program.counts),
        "device_events": len(dev),
        "runtime_events": len(rt),
        "runtime_calls": Counter(r[1] for r in rt).most_common(16),
    }


# -- the per-layer metrics that read the program's spans ------------------

def _mean(summary, name, scale):
    s = summary["spans"].get(name)
    return scale * s["total"]["wall_s"] / s["n"] if s and s["n"] else None


def _per(summary, name, field, scale=1.0, need="device_events"):
    s = summary["spans"].get(name)
    if not s or not s["n"] or not summary[need]:
        return None
    return scale * s["total"][field] / s["n"]


def _decide_idle(summary):
    s = summary["spans"].get("tuner.decide")
    if not s or not summary["device_events"] or summary["window_s"] <= 0:
        return None
    return 100.0 * s["total"]["idle_s"] / summary["window_s"]


def _per_count(summary, name, field, counter, scale,
               need="device_events"):
    """``field`` summed over the spans named ``name``, per unit of the
    program's counter ``counter``."""
    s = summary["spans"].get(name)
    n = summary["counts"].get(counter, 0)
    if not s or not n or (need and not summary[need]):
        return None
    return scale * s["total"][field] / n


# name: (unit, reader)
METRICS = {
    "decide_ms": ("ms", lambda s: _mean(s, "tuner.decide", 1e3)),
    "decide_idle": ("%", _decide_idle),
    "cycle_launches": ("launches", lambda s: _per(
        s, "tuner.cycle", "launches", need="runtime_events")),
    "cycle_syncs": ("syncs", lambda s: _per(
        s, "tuner.cycle", "syncs", need="runtime_events")),
    "build_device_ms": ("ms", lambda s: _per(
        s, "index.build", "device_s", 1e3)),
    "crack_adopt_ms": ("ms", lambda s: _mean(s, "executor.crack_adopt",
                                             1e3)),
    "account_us": ("us", lambda s: _mean(s, "runner.account", 1e6)),
    "build_device_us_per_page": ("us", lambda s: _per_count(
        s, "index.build", "device_s", "index.pages_built", 1e6)),
    "crack_adopt_us_per_page": ("us", lambda s: _per_count(
        s, "executor.crack_adopt", "wall_s", "index.pages_adopted", 1e6,
        need=None)),
}


def metrics(summary) -> dict:
    """{name: {"value", "unit"}} of every metric the summary holds
    something for."""
    out = {}
    for name, (unit, read) in METRICS.items():
        v = read(summary)
        if v is not None:
            out[name] = {"value": float(v), "unit": unit}
    return out


def idle_by_span(summary, top: int = 12):
    """[[span name, idle s]] by the spans' own idle time, largest
    first; ``-`` is idle time under no program span."""
    rows = [(k, v["self"]["idle_s"]) for k, v in summary["spans"].items()]
    rows.append(("-", summary["outside"]["idle_s"]))
    return [[k, v] for k, v in sorted(rows, key=lambda kv: -kv[1])[:top]
            if v > 0]
