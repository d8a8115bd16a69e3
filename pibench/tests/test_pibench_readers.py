"""Each metric reader, and the trace and bound arithmetic under them,
on synthetic inputs."""
import importlib.util

import pytest
from torch.autograd import DeviceType

from pibench import bounds, harness, spec
from pibench import trace as trace_reader

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


class Event:
    def __init__(self, name, dev, a, b, note=False):
        self._n, self._d, self._a, self._b, self._u = name, dev, a, b, note

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a

    def is_user_annotation(self):
        return self._u


class Prof:
    def __init__(self, events):
        results = type("R", (), {"events": lambda self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


def synthetic_trace():
    """A 1,000 ns window: kernels over [100, 300) and [250, 400) and a
    memset over [700, 800), one before the window; a device-side
    annotation and an aten:: device row that must not count; a host
    row the device reading ignores."""
    return Prof([
        Event("stream_filter_agg_kernel<4>", CUDA, 100, 300),
        Event("masked_filter_agg_kernel", CUDA, 250, 400),
        Event("Memset (Device)", CUDA, 700, 800),
        Event("pibench.tuning_cycle", CUDA, 0, 500, note=True),
        Event("aten::sort", CUDA, 0, 900),
        Event("cudaLaunchKernel", CPU, 420, 480),
        Event("stream_filter_agg_kernel<4>", CUDA, 2000, 2100),
    ])


# The harness's spans: a tuning cycle [0, 500), a burst [600, 1000).
SPANS = [(0, 500, "tuning_cycle"), (600, 1000, "execute_batch")]


def test_trace_summary():
    t = trace_reader.summarize(synthetic_trace(), 0, 1000, SPANS)
    assert t["busy_s"] == pytest.approx(400e-9)
    assert t["window_s"] == pytest.approx(1e-6)
    assert t["k1_device_s"] == pytest.approx(200e-9)
    assert t["k3_device_s"] == pytest.approx(150e-9)
    assert t["device_events"] == 3
    # Idle [0, 100), [400, 700), [800, 1000): 100 + 100 ns in the
    # cycle, 100 in the runner between the calls, 100 + 200 in the
    # burst.
    assert dict(t["idle_gaps"]) == pytest.approx({
        "tuning_cycle": 200e-9, "runner": 100e-9, "execute_batch": 300e-9})
    assert [n for n, _ in t["device_ops"]][0].startswith("stream_filter")
    bare = trace_reader.summarize(Prof([]), 0, 1000, [])
    assert bare["busy_s"] == 0 and bare["idle_gaps"] == [["runner", 1e-6]]


def reader(name):
    path = spec.PACKAGE / "metrics" / f"{name}.py"
    s = importlib.util.spec_from_file_location("m", path)
    m = importlib.util.module_from_spec(s)
    s.loader.exec_module(m)
    return m.read


def test_readers_on_a_synthetic_run():
    tr = trace_reader.summarize(synthetic_trace(), 0, 1000, SPANS)
    run = harness.Run(
        statements=50, window_s=2.0, setup_s=9.5,
        latencies_ms=[float(x) for x in range(1, 101)], peak_bytes=300,
        user_bytes=100, traced=True, trace=tr, burst_walls_s=[0.01, 0.03],
        cycle_walls_s=[0.04], vap_pages=64, k1_launches=3, k3_launches=1,
        k1_bound_s=100e-9, k3_bound_s=120e-9, plans={})
    assert reader("queries_per_s")(run) == 25.0
    assert reader("query_p95_ms.host")(run) == pytest.approx(95.05)
    assert reader("space_amp")(run) == 3.0
    assert reader("setup_s")(run) == 9.5
    assert reader("burst_ms")(run) == pytest.approx(20.0)
    assert reader("tuner_cycle_ms")(run) == pytest.approx(40.0)
    assert reader("vap_pages_per_s")(run) == 32.0
    assert reader("k1_roofline")(run) == pytest.approx(50.0)
    assert reader("k3_roofline")(run) == pytest.approx(80.0)
    assert reader("device_idle")(run) == pytest.approx(60.0)


def test_readers_find_nothing_to_read():
    run = harness.Run(
        statements=0, window_s=1.0, setup_s=1.0, latencies_ms=[],
        peak_bytes=0, user_bytes=100, traced=False, trace=None,
        burst_walls_s=[], cycle_walls_s=[], vap_pages=0, k1_launches=0,
        k3_launches=0, k1_bound_s=0.0, k3_bound_s=0.0, plans={})
    for name in ("query_p95_ms.host", "space_amp",
                 "burst_ms", "tuner_cycle_ms", "vap_pages_per_s",
                 "k1_roofline", "k3_roofline", "device_idle"):
        assert reader(name)(run) is None, name


def test_bounds():
    # 10 pages of 256 rows, 4 planes, two queries from pages 0 and 5:
    # bytes bound 10 * 256 * 4 * 4 + operands.
    b = bounds.k1_bound_s(10, 256, 4, [0, 5])
    assert b == pytest.approx((10 * 256 * 16 + 2 * 32)
                              / bounds.HBM_BYTES_PER_S)
    # Pages 0-39 real; words cover pages 0-3 and 32-35 (and 40, 41,
    # which are not real): 32 uncovered.
    words = [[0b1111, 0b1100001111]]
    assert bounds.uncovered_pages(words, [40]) == 32
    assert bounds.uncovered_pages([[-1, 0]], [40]) == 8
    k3 = bounds.k3_bound_s(32, 256, 5, 3, 2)
    assert k3 == pytest.approx(max(
        (32 * 256 * 20 + 8 + 3 * 28) / bounds.HBM_BYTES_PER_S,
        32 * 256 * 3 * bounds.OPS_PER_ROW_QUERY / bounds.INT32_OPS_PER_S))
