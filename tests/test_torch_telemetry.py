"""The port's tracer (``repro_torch.telemetry``) and its sites.

The tracer on its own: off, it records nothing and every ``span()`` is
one shared object; on, spans nest by thread, and ``drain()`` hands
back the spans and counters and starts afresh.  Then whole
``run_workload`` runs on a small TUNER table on the CPU with the tracer
on: one ``tuner.cycle`` span per cycle the tuner counts, every span
the run reaches, under the span it belongs to, and the pages the
counters saw built or adopted equal to those the indexes hold.
"""
import _torch_threads  # noqa: F401  (first: pins torch's threads)

import threading
from collections import Counter

import pytest
import torch

from repro_torch import api as P
from repro_torch import telemetry
from repro_torch.core.table import clone_table

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


@pytest.fixture
def tracer():
    """The tracer on for one test; off and empty after it."""
    telemetry.drain()
    telemetry.enable()
    try:
        yield telemetry
    finally:
        telemetry.disable()
        telemetry.drain()


def test_off_records_nothing_and_shares_one_object():
    telemetry.disable()
    telemetry.drain()
    a, b = telemetry.span("x.a"), telemetry.span("x.b")
    assert a is b
    with a:
        with b:
            telemetry.count("x.n", 3)
    out = telemetry.drain()
    assert out.spans == [] and out.counts == {}
    with telemetry.stopwatch("x.sw") as sw:
        pass
    assert sw.seconds >= 0.0 and telemetry.drain().spans == []


def test_on_spans_nest_and_drain_starts_afresh(tracer):
    with tracer.span("outer.a"):
        with tracer.span("inner.b"):
            tracer.count("inner.n")
            tracer.count("inner.n", 4)
        with tracer.stopwatch("inner.c") as sw:
            with tracer.span("leaf.d"):
                pass
    with tracer.span("outer.e"):
        pass
    out = tracer.drain()
    names = [s.name for s in out.spans]
    assert names == ["outer.a", "inner.b", "inner.c", "leaf.d", "outer.e"]
    assert [s.parent for s in out.spans] == [-1, 0, 0, 2, -1]
    for s in out.spans:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = out.spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert sw.seconds == (out.spans[2].end_ns - out.spans[2].start_ns) / 1e9
    assert out.counts == {"inner.n": 5}
    again = tracer.drain()
    assert again.spans == [] and again.counts == {}
    with tracer.span("after.f"):
        pass
    assert [s.name for s in tracer.drain().spans] == ["after.f"]


def test_a_span_open_across_a_drain_parents_nothing_after_it(tracer):
    with tracer.span("outer.a"):
        tracer.drain()
        with tracer.span("inner.b"):
            pass
    out = tracer.drain()
    assert [(s.name, s.parent) for s in out.spans] == [("inner.b", -1)]


def test_threads_keep_their_own_parents(tracer):
    def work():
        with tracer.span("thread.t"):
            with tracer.span("thread.u"):
                pass

    with tracer.span("main.m"):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    spans = tracer.drain().spans
    assert [(s.name, s.parent) for s in spans] == [
        ("main.m", -1), ("thread.t", -1), ("thread.u", 1)]


def test_the_clock_is_monotonic_on_the_wall_clock_scale(tracer,
                                                       monkeypatch):
    """Spans read ``perf_counter_ns`` on the scale of ``time_ns`` (one
    offset, taken at ``enable()``): a step of the wall clock inside a
    span moves neither its stamps nor a stopwatch's seconds."""
    import time

    before = time.time_ns()
    tracer.enable()
    after = time.time_ns()
    real = time.time_ns
    monkeypatch.setattr(time, "time_ns", lambda: real() - 10**12)
    with tracer.stopwatch("x.sw") as sw:
        pass
    monkeypatch.setattr(time, "time_ns", real)
    (s,) = tracer.drain().spans
    assert before - 10**6 <= s.start_ns <= s.end_ns <= time.time_ns() + 10**6
    assert after - 10**6 <= s.start_ns
    assert 0 <= sw.seconds < 1.0


class _Event:
    def __init__(self, name, cuda, a, b, corr):
        from torch.autograd import DeviceType

        self._n, self._a, self._b, self._c = name, a, b, corr
        self._d = DeviceType.CUDA if cuda else DeviceType.CPU

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a

    def correlation_id(self):
        return self._c

    def is_user_annotation(self):
        return False


def test_kernels_under_finds_launches_by_correlation():
    """A kernel counts under a span when the runtime call that launched
    it was made inside one of the spans of that name, at any depth and
    whenever the kernel itself ran; overlapping spans count once, a
    span still open and the window's edges are kept to."""
    S = telemetry.Span
    trace = telemetry.Trace([
        S("r.a", 100, 200, -1), S("r.inner", 120, 150, 0),
        S("r.a", 180, 260, -1), S("r.b", 300, 400, -1),
        S("r.a", 500, None, -1)], {})
    ev = [_Event("cudaLaunchKernel", False, 90, 91, 1),    # before
          _Event("k1", True, 95, 99, 1),
          _Event("cudaLaunchKernel", False, 130, 131, 2),  # in r.inner
          _Event("k2", True, 270, 290, 2),                 # runs later
          _Event("cuLaunchKernel", False, 250, 251, 3),    # second r.a
          _Event("k3", True, 252, 262, 3),
          _Event("cudaLaunchKernel", False, 260, 261, 4),  # at its end
          _Event("k4", True, 262, 263, 4),
          _Event("cudaLaunchKernel", False, 350, 351, 5),  # in r.b
          _Event("k5", True, 352, 353, 5),
          _Event("cudaLaunchKernel", False, 600, 601, 6),  # open r.a
          _Event("k6", True, 602, 603, 6)]
    n, ks = telemetry.kernels_under(trace, ev, "r.a")
    assert n == 3 and sorted(ks) == [("k2", 20), ("k3", 10)]
    assert telemetry.kernels_under(trace, ev, "r.inner")[1] == [("k2", 20)]
    assert telemetry.kernels_under(trace, ev, "r.a", 0, 200) == (3, [])
    assert telemetry.kernels_under(trace, ev, "r.c") == (0, [])


# -- the program's sites --------------------------------------------------

SRC = P.make_tuner_db(n_rows=3_000, page_size=128, device="cpu")
# A full scan costs 10 simulated ms, as at 10M rows at 1e-6 ms a tuple:
# the tuner's cycles fire as often per scan.
TIME_PER_UNIT_MS = 10.0 / 3_000

TUNER_SPANS = ("tuner.monitor", "tuner.classify", "tuner.utility",
               "tuner.knapsack", "tuner.transition", "tuner.plan_quanta",
               "tuner.forecast")


def fresh_db(**kw):
    tables = {k: clone_table(t) for k, t in SRC.tables.items()}
    return P.Database(tables, time_per_unit_ms=TIME_PER_UNIT_MS, **kw)


def traced_run(mixture, batch, use_kernel, tuner_cfg, **tuning):
    """One traced ``run_workload``: (trace, tuner cycles run, pages the
    indexes built or adopted, dropped ones included)."""
    db = fresh_db()
    tuner = P.make_dl_tuner(db, "predictive", P.TunerConfig(**tuner_cfg))
    gen = P.QueryGen(SRC, selectivity=0.01, seed=23)
    wl = P.hybrid_workload(gen, mixture, total=240, phase_len=80, seed=2)
    held = []
    drop = db.drop_index

    def drop_index(name):
        held.append(covered(db.indexes[name]))
        drop(name)

    db.drop_index = drop_index
    cfg = P.RunConfig(
        execution=P.ExecOptions(read_batch_size=batch,
                                use_kernel=use_kernel),
        tuning=P.TuningOptions(**tuning),
        time_per_unit_ms=TIME_PER_UNIT_MS)
    before = tuner.cycles
    telemetry.drain()
    telemetry.enable()
    try:
        P.run_workload(db, tuner, wl, cfg)
    finally:
        telemetry.disable()
    out = telemetry.drain()
    pages = sum(held) + sum(covered(b) for b in db.indexes.values())
    return out, tuner.cycles - before, pages


def covered(bi):
    if bi.coverage is not None:
        return int(bi.coverage.count())
    return int(bi.vap.built_pages)


def parents(trace):
    return Counter(
        (s.name, trace.spans[s.parent].name if s.parent >= 0 else "-")
        for s in trace.spans)


# The crack run builds 2 pages a cycle, so that scans find pages to
# adopt before the cycles have built the whole table.
@pytest.mark.parametrize(
    "mixture,batch,use_kernel,tuner_cfg,tuning,expect", [
    ("read_heavy", 6, True, {}, {},
     {("engine.dispatch", "executor.execute_batch"),
      ("planner.plan", "executor.execute_batch"),
      ("hybrid_scan.index_gathers", "engine.dispatch"),
      ("executor.update_rows", "executor.execute")}),
    ("write_heavy", 1, False, {}, {},
     {("engine.dispatch", "executor.execute"),
      ("planner.plan", "executor.execute"),
      ("executor.update_rows", "executor.execute")}),
    ("read_only", 6, True,
     {"pages_per_cycle": 2, "max_build_pages_per_cycle": 2},
     {"crack_on_scan": True},
     {("engine.dispatch", "executor.execute_batch"),
      ("executor.crack_adopt", "executor.execute_batch")}),
])
def test_a_run_reaches_every_span_under_its_parent(mixture, batch,
                                                   use_kernel, tuner_cfg,
                                                   tuning, expect):
    trace, cycles, pages = traced_run(mixture, batch, use_kernel,
                                      tuner_cfg, **tuning)
    pairs = parents(trace)
    assert cycles > 0
    assert pairs[("tuner.cycle", "-")] == cycles
    assert pairs[("tuner.decide", "tuner.cycle")] == cycles
    for stage in TUNER_SPANS:
        assert pairs[(stage, "tuner.decide")] >= cycles, stage
    assert pairs[("tuner.monitor", "tuner.decide")] == 2 * cycles
    assert pairs[("index.build", "tuner.cycle")] > 0
    assert pairs[("index.merge", "index.build")] > 0
    assert pairs[("index.sort", "index.merge")] > 0
    assert pairs[("runner.account", "-")] == 240
    for pair in expect:
        assert pairs[pair] > 0, pair
    assert all(s.end_ns is not None for s in trace.spans)
    assert (trace.counts.get("index.pages_built", 0)
            + trace.counts.get("index.pages_adopted", 0)) == pages > 0
    if tuning.get("crack_on_scan"):
        assert trace.counts["index.pages_adopted"] > 0
    else:
        assert "executor.crack_adopt" not in {s.name for s in trace.spans}


# A cycle of 16 pages makes two 8-page quanta per index, so the lane's
# queue outgrows a cap of 4 and its drains escalate.
LANE = dict(tuner_cfg={"pages_per_cycle": 16,
                       "max_build_pages_per_cycle": 16},
            async_tuning="overlap", build_queue_cap=4)


def test_the_overlap_lane_drains_quanta_under_its_spans():
    """On the overlap lane every build runs inside a drain between a
    burst's dispatches, and the merge inside the build; each quantum
    queued is applied, skipped as stale or left when the call
    returns."""
    trace, cycles, pages = traced_run("read_heavy", 6, True, **LANE)
    pairs = parents(trace)
    assert cycles > 0
    assert ("tuner.cycle", "-") not in pairs  # the lane calls decide
    assert pairs[("build.drain", "executor.execute_batch")] > 0
    assert pairs[("index.build", "build.drain")] > 0
    assert sum(n for (name, parent), n in pairs.items()
               if name == "index.build") == pairs[("index.build",
                                                   "build.drain")]
    assert pairs[("index.merge", "index.build")] > 0
    n = trace.counts
    assert n["build.quanta_applied"] > 0 and n["build.escalations"] > 0
    assert n["build.quanta_queued"] == (n["build.quanta_applied"]
                                        + n.get("build.quanta_stale", 0)
                                        + n["build.quanta_left"])
    assert n["index.pages_built"] == pages > 0


def test_off_the_lane_costs_one_shared_no_op(monkeypatch):
    """With the tracer off, every span an overlap run opens, the
    lane's and the merge's among them, is the one shared no-op."""
    telemetry.disable()
    telemetry.drain()
    opened = Counter()
    span = telemetry.span

    def counted(name):
        out = span(name)
        opened[name, id(out)] += 1
        return out

    monkeypatch.setattr(telemetry, "span", counted)
    db = fresh_db()
    tuner = P.make_dl_tuner(db, "predictive", P.TunerConfig(
        **LANE["tuner_cfg"]))
    gen = P.QueryGen(SRC, selectivity=0.01, seed=23)
    wl = P.hybrid_workload(gen, "read_heavy", total=120, phase_len=60,
                           seed=2)
    P.run_workload(db, tuner, wl, P.RunConfig(
        execution=P.ExecOptions(read_batch_size=6),
        tuning=P.TuningOptions(async_tuning="overlap", build_queue_cap=4),
        time_per_unit_ms=TIME_PER_UNIT_MS))
    names = {name for name, _ in opened}
    assert {"build.drain", "index.build", "index.merge"} <= names
    assert {obj for _, obj in opened} == {id(telemetry._NOOP)}
    out = telemetry.drain()
    assert out.spans == [] and out.counts == {}


def test_exec_stats_wall_is_the_dispatch_span(tracer):
    db = fresh_db()
    gen = P.QueryGen(SRC, selectivity=0.01, seed=5)
    stats = db.execute(gen.low_s())
    spans = tracer.drain().spans
    (dispatch,) = [s for s in spans if s.name == "engine.dispatch"]
    assert stats.wall_s == (dispatch.end_ns - dispatch.start_ns) / 1e9
    assert spans[dispatch.parent].name == "executor.execute"


def test_stage_three_is_one_batched_step_per_cycle(tracer, monkeypatch):
    """Each cycle calls the forecaster's update and forecast once,
    however many descriptors the tuner has seen; ``tuner.forecast_series``
    counts them, and the batched state's rows follow ``names``: row i
    is the scalar state of ``names[i]``'s observations, bit for bit."""
    from repro_torch.core import forecaster as hw

    calls = Counter()
    for fn in ("update", "update_batch", "forecast", "forecast_batch"):
        def counted(*a, _fn=getattr(hw, fn), _name=fn, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(hw, fn, counted)
    db = fresh_db()
    tuner = P.make_dl_tuner(db, "predictive",
                            P.TunerConfig(candidate_min_count=2))
    seen = []
    utilities = tuner._utilities

    def recorded(*a):
        out = utilities(*a)
        seen.append((out[0], out[4]))
        return out

    tuner._utilities = recorded
    gen = P.QueryGen(SRC, selectivity=0.01, seed=31)
    for cycle, (a, b) in enumerate([(2, 5)] * 3 + [(7, 1)] * 3
                                   + [(4, 9)] * 3):
        for q in [gen.low_s(attr=a), gen.low_s(attr=a),
                  gen.mod_s(attrs=(a, b)), gen.mod_s(attrs=(b, a))]:
            db.execute(q)
        calls.clear()
        tracer.drain()
        tuner.decide()
        names = seen[-1][0]
        assert names == list(tuner.descs) and names
        assert tracer.drain().counts["tuner.forecast_series"] == len(names)
        assert dict(calls) == {"update": 1, "update_batch": 1,
                               "forecast": 1, "forecast_batch": 1}
        assert len(tuner.hw_state.t) == len(names)
    widths = [len(names) for names, _ in seen]
    assert widths == sorted(widths) and len(set(widths)) >= 3
    cfg = tuner.cfg
    for i, name in enumerate(seen[-1][0]):
        st = hw.init_state(cfg.season_len, device="cpu")
        for names, observed in seen:
            if name in observed:
                st = hw.update(st, observed[name], cfg.alpha, cfg.beta,
                               cfg.gamma)
        for got, want in zip(tuner.hw_state, st):
            assert torch.equal(got[i], want), name
        assert tuner.forecasts[name] == float(hw.forecast(st, 1))


def test_range_heat_counts_the_window_ranges(tracer):
    """A ``decide`` on a crack-mode database counts in
    ``tuner.heat_ranges`` the window's range predicates on the building
    index's leading attribute, and in ``tuner.heat_direct`` those ranges
    and pages that took the direct compare: none while every range is
    ordinary, some once an inverted range is in the window."""
    db = fresh_db()
    db.crack_on_scan = True
    tuner = P.make_dl_tuner(db, "predictive", P.TunerConfig(
        pages_per_cycle=2, max_build_pages_per_cycle=2))
    gen = P.QueryGen(SRC, selectivity=0.01, seed=5)
    inverted = P.Query(kind="scan", table="narrow", attrs=(1,),
                       los=(600_000,), his=(500_000,), agg_attr=2,
                       template="inverted")

    def decide_counts():
        tracer.drain()
        tuner.decide()
        (b,) = [b for b in db.indexes.values() if b.building]
        assert b.coverage is not None
        lead = b.desc.key_attrs[0]
        ranges = sum(attr == lead
                     for r in db.monitor.scan_records("narrow")
                     for attr, _, _ in r.pred_ranges)
        counts = tracer.drain().counts
        assert counts["tuner.heat_ranges"] == ranges > 0
        return counts["tuner.heat_direct"]

    for _ in range(12):
        db.execute(gen.low_s(attr=1))
    assert decide_counts() == 0
    db.execute(inverted)
    db.execute(gen.low_s(attr=1))
    assert decide_counts() > 0
