"""The reader of the program's spans beside the device trace
(``pibench/program_trace.py``) on synthetic kineto events with
correlation ids, each metric that reads it on known inputs, and, on
the card, that a K1 launch made inside a program span is found under
it: the program's spans and the device trace share one clock."""
import pytest
from torch.autograd import DeviceType

from pibench import program_trace as pt
from pibench import trace as trace_reader
from repro_torch import telemetry

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


class Event:
    def __init__(self, name, dev, a, b, corr=0, note=False):
        self._n, self._d, self._a, self._b = name, dev, a, b
        self._c, self._u = corr, note

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
        return self._u


def span(name, a, b, parent):
    return telemetry.Span(name, a, b, parent)


# A window of [0, 1000) ns: one tuning cycle (decide with its forecast
# stage, then a build with its sort), a statement's bookkeeping and a
# crack adoption.
PROGRAM = telemetry.Trace([
    span("tuner.cycle", 100, 600, -1),
    span("tuner.decide", 110, 400, 0),
    span("tuner.forecast", 150, 300, 1),
    span("index.build", 420, 590, 0),
    span("index.sort", 450, 550, 3),
    span("runner.account", 700, 720, -1),
    span("executor.crack_adopt", 800, 900, -1),
], {"index.pages_built": 32, "index.pages_adopted": 8})

DTOH = "Memcpy DtoH (Device -> Pageable)"
EVENTS = [
    Event("cudaLaunchKernel", CPU, 50, 55, 9),
    Event("k_outside", CUDA, 60, 90, 9),
    Event("cudaLaunchKernel", CPU, 160, 165, 1),
    Event("k_forecast", CUDA, 170, 200, 1),
    # A read to the host: a copy and a synchronise, one wait.
    Event("cudaMemcpyAsync", CPU, 210, 211, 2),
    Event("cudaStreamSynchronize", CPU, 212, 222, 3),
    Event(DTOH, CUDA, 215, 220, 2),
    # A copy to the host that no synchronise follows: a wait.
    Event("cudaMemcpyAsync", CPU, 350, 361, 4),
    Event(DTOH, CUDA, 355, 360, 4),
    Event("cudaLaunchKernel", CPU, 430, 431, 6),
    Event("k_build", CUDA, 500, 520, 6),
    Event("cudaLaunchKernel", CPU, 460, 461, 5),
    Event("DeviceRadixSortOnesweepKernel", CUDA, 465, 545, 5),
    Event("cudaDeviceSynchronize", CPU, 560, 580, 7),
    Event("cudaLaunchKernel", CPU, 810, 811, 8),
    Event("k_crack", CUDA, 820, 830, 8),
    # Outside the window, an aten:: device row and an annotation.
    Event("cudaLaunchKernel", CPU, 2000, 2001, 10),
    Event("k_late", CUDA, 2010, 2020, 10),
    Event("aten::sort", CUDA, 0, 900),
    Event("tuner.cycle", CUDA, 100, 600, note=True),
]
# The harness's own spans: its tuning cycle and a statement.
OUTER = [(95, 605, "tuning_cycle"), (795, 905, "execute")]


def test_summary_puts_calls_kernels_and_idle_under_spans():
    s = pt.summarize(PROGRAM, EVENTS, 0, 1000, OUTER)
    sp = s["spans"]
    assert s["device_events"] == 7 and s["runtime_events"] == 9
    # Self: each span's own; total: with its children's.
    assert sp["tuner.cycle"]["self"]["wall_s"] == pytest.approx(40e-9)
    assert sp["tuner.cycle"]["total"]["wall_s"] == pytest.approx(500e-9)
    assert sp["tuner.decide"]["self"]["launches"] == 0
    assert sp["tuner.decide"]["self"]["syncs"] == 1
    assert sp["tuner.forecast"]["self"]["launches"] == 1
    assert sp["tuner.forecast"]["self"]["syncs"] == 1
    assert sp["tuner.forecast"]["self"]["device_s"] == pytest.approx(35e-9)
    assert sp["tuner.cycle"]["total"]["launches"] == 3
    assert sp["tuner.cycle"]["total"]["syncs"] == 3
    assert sp["index.build"]["self"]["device_s"] == pytest.approx(20e-9)
    assert sp["index.build"]["total"]["device_s"] == pytest.approx(100e-9)
    assert s["outside"]["launches"] == 1
    # Idle [0, 60), [90, 170), [200, 215), [220, 355), [360, 465),
    # [545, 820), [830, 1000), by the innermost span the host was in.
    idle = {k: v["self"]["idle_s"] * 1e9 for k, v in sp.items()}
    assert idle == pytest.approx({
        "tuner.cycle": 40, "tuner.decide": 135, "tuner.forecast": 115,
        "index.build": 70, "index.sort": 20, "runner.account": 20,
        "executor.crack_adopt": 90})
    assert s["outside"]["idle_s"] == pytest.approx(350e-9)
    assert sp["tuner.decide"]["total"]["idle_s"] == pytest.approx(250e-9)
    within = {k: v * 1e9 for k, v in s["idle_within"]["tuning_cycle"].items()}
    assert within == pytest.approx({
        "-": 10, "tuner.cycle": 40, "tuner.decide": 135,
        "tuner.forecast": 115, "index.build": 70, "index.sort": 20})
    assert s["tree"]["tuner.cycle"]["tuner.decide"] == pytest.approx(
        [1, 290e-9])
    assert s["counts"] == {"index.pages_built": 32, "index.pages_adopted": 8}
    assert pt.idle_by_span(s, top=2) == [
        ["-", pytest.approx(350e-9)], ["tuner.decide", pytest.approx(135e-9)]]


def test_idle_under_program_spans_adds_up_to_the_harness_idle():
    """The idle time the harness's reader puts under its tuning cycle
    is the idle time the program's spans split inside it."""
    harness = trace_reader.summarize(
        type("Prof", (), {"profiler": type("P", (), {"kineto_results": type(
            "R", (), {"events": lambda self: EVENTS})()})()})(),
        0, 1000, OUTER)
    s = pt.summarize(PROGRAM, EVENTS, 0, 1000, OUTER)
    gaps = dict(harness["idle_gaps"])
    assert sum(s["idle_within"]["tuning_cycle"].values()) == pytest.approx(
        gaps["tuning_cycle"])
    assert sum(s["idle_within"]["execute"].values()) == pytest.approx(
        gaps["execute"])


def test_metrics_on_known_inputs():
    m = pt.metrics(pt.summarize(PROGRAM, EVENTS, 0, 1000, OUTER))
    assert {k: v["unit"] for k, v in m.items()} == {
        "decide_ms": "ms", "decide_idle": "%", "cycle_launches": "launches",
        "cycle_syncs": "syncs", "build_device_ms": "ms",
        "crack_adopt_ms": "ms", "account_us": "us",
        "build_device_us_per_page": "us", "crack_adopt_us_per_page": "us"}
    got = {k: v["value"] for k, v in m.items()}
    # The counters: 32 pages built under the build's 100 ns of device
    # time, 8 adopted in the adoption's 100 ns.
    assert got == pytest.approx({
        "decide_ms": 290e-6, "decide_idle": 25.0, "cycle_launches": 3.0,
        "cycle_syncs": 3.0, "build_device_ms": 100e-6,
        "crack_adopt_ms": 100e-6, "account_us": 0.02,
        "build_device_us_per_page": 0.1 / 32,
        "crack_adopt_us_per_page": 0.1 / 8})


def test_metrics_without_a_device_trace_or_its_runtime_calls():
    """Without a device trace only the spans' own times are read;
    with device activity but no runtime calls, launches and syncs are
    left out; with no spans, nothing."""
    bare = pt.metrics(pt.summarize(PROGRAM, [], 0, 1000))
    assert set(bare) == {"decide_ms", "crack_adopt_ms", "account_us",
                         "crack_adopt_us_per_page"}
    device_only = [e for e in EVENTS if e.device_type() == CUDA]
    some = pt.metrics(pt.summarize(PROGRAM, device_only, 0, 1000))
    assert set(some) == {"decide_ms", "decide_idle", "build_device_ms",
                         "crack_adopt_ms", "account_us",
                         "build_device_us_per_page",
                         "crack_adopt_us_per_page"}
    empty = telemetry.Trace([], {})
    assert pt.metrics(pt.summarize(empty, EVENTS, 0, 1000)) == {}


def test_kernels_under_a_span_by_correlation():
    n, ks = telemetry.kernels_under(PROGRAM, EVENTS, "index.build", 0, 1000)
    assert n == 1
    assert sorted(ks) == [("DeviceRadixSortOnesweepKernel", 80),
                          ("k_build", 20)]
    n, ks = telemetry.kernels_under(PROGRAM, EVENTS, "tuner.decide", 0,
                                    1000)
    assert n == 1 and sorted(ks) == [(DTOH, 5), (DTOH, 5),
                                     ("k_forecast", 30)]


def test_spans_that_close_at_one_instant_nest():
    """A child that starts with its parent and one that ends with it,
    and a span of no length, keep the innermost span right."""
    prog = telemetry.Trace([
        span("a.outer", 0, 100, -1),
        span("a.first", 0, 50, 0),
        span("a.last", 50, 100, 0),
        span("a.empty", 60, 60, 2),
    ], {})
    ev = [Event("cudaLaunchKernel", CPU, 0, 1, 1),
          Event("cudaLaunchKernel", CPU, 50, 51, 2),
          Event("cudaLaunchKernel", CPU, 99, 100, 3)]
    s = pt.summarize(prog, ev, 0, 100)["spans"]
    assert s["a.outer"]["self"]["wall_s"] == 0
    assert s["a.first"]["self"]["launches"] == 1
    assert s["a.last"]["self"]["launches"] == 2
    assert s["a.outer"]["total"]["launches"] == 3
    assert s["a.empty"]["n"] == 1


@pytest.mark.cuda
def test_a_k1_launch_lies_inside_its_program_span(cuda_device):
    """A read burst on the card with the tracer on, under a device-only
    profile as the harness takes it: the K1 launch's runtime call and
    its kernel are found under the program's ``engine.dispatch``."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import api as P

    src = P.make_tuner_db(n_rows=20_000, device=cuda_device)
    db = P.Database(dict(src.tables))
    gen = P.QueryGen(src, selectivity=0.01, seed=3)
    scans = [gen.low_s() for _ in range(6)]
    db.execute_batch(scans, use_kernel=True)  # build and load K1
    torch.cuda.synchronize()
    telemetry.drain()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time_ns()
        telemetry.enable()
        try:
            db.execute_batch(scans, use_kernel=True)
        finally:
            telemetry.disable()
        torch.cuda.synchronize()
        t1 = time.time_ns()
    program = telemetry.drain()
    events = prof.profiler.kineto_results.events()
    n, ks = telemetry.kernels_under(program, events, "engine.dispatch", t0,
                                    t1)
    assert n == 1
    assert any(trace_reader.K1_KERNEL in name for name, _ in ks), ks
    s = pt.summarize(program, events, t0, t1)
    assert s["spans"]["engine.dispatch"]["total"]["launches"] >= 1
    assert s["spans"]["engine.dispatch"]["total"]["syncs"] >= 1


def test_a_cell_run_with_the_tracer_on():
    """A tiny crack cell on the CPU through ``program_run``: one
    ``tuner.cycle`` span per cycle the harness timed, and every metric
    that reads the spans and counters alone; the benchmark's own run
    (``harness.run_cell``, as ``run.py`` runs it) leaves the tracer off."""
    import io

    from conftest import tiny_cell

    from pibench import harness, program_run

    result, got = program_run.run_with_tracer(
        tiny_cell("narrow-ro-crack"), 2**31 + 9, 1.0, True, device="cpu",
        log=io.StringIO())
    assert result["correct"], result["checks"]
    s = got["summary"]
    assert s["spans"]["tuner.cycle"]["n"] == len(got["cycle_walls_s"]) > 0
    assert set(pt.metrics(s)) == {"decide_ms", "crack_adopt_ms",
                                  "account_us", "crack_adopt_us_per_page"}
    assert s["counts"]["index.pages_adopted"] > 0
    assert telemetry.span("a.b") is telemetry.span("a.c")  # off again
    assert harness.measure is program_run._MEASURE
    off, _ = harness.run_cell(tiny_cell("narrow-ro-crack"), 2**31 + 9, 0.2,
                              False, device="cpu", log=io.StringIO())
    assert off["correct"]
    assert telemetry.drain() == telemetry.Trace([], {})


def test_main_is_the_harness_main_with_the_program_added(monkeypatch,
                                                          tmp_path):
    """``program_run.main`` hands every argument but ``--out`` to
    ``harness.main``, whose ``run_cell`` then runs with the tracer on
    and the program's readings on the result; both are restored."""
    import io

    from conftest import tiny_cell

    from pibench import harness, program_run

    seen = {}

    def fake_main(argv, t_start):
        seen["argv"] = argv
        seen["result"], _ = harness.run_cell(
            tiny_cell("narrow-ro-crack"), 2**31 + 9, 0.3, False,
            device="cpu", log=io.StringIO())
        return 0

    monkeypatch.setattr(harness, "main", fake_main)
    out = tmp_path / "x.json"
    argv = ["--workload", "narrow-ro-crack", "--seed", "7", "--seconds",
            "0.3", "--trace", "0"]
    assert program_run.main(argv + ["--out", str(out)], 0.0) == 0
    assert seen["argv"] == argv
    r = seen["result"]
    assert r["correct"] and "decide_ms" in r["metrics"]
    assert r["program"]["counts"]["index.pages_adopted"] > 0
    assert "summary" in out.read_text()
    assert harness.run_cell is program_run._RUN_CELL
    assert harness.measure is program_run._MEASURE
