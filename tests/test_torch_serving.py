"""Parity of the port's serving front end with the reference.

``repro_torch.serving`` (admission, SLO report) against
``repro.serving``, and whole open-loop ``run_workload`` runs against the
reference's on the same numpy inputs.  Tolerance: none.  Arrival arrays
are equal element for element (numpy generators from one seed); burst
plans, backlog depths, pressure predicates and SLO digests are equal;
every ``RunResult`` field but ``wall_s``, ``execution_tiers`` and
``build_pages_per_ms`` is equal (the SLO report by value), and so are
the clock, the monitor window and each index's build state.  Overlap
runs assert ``build_escalations == 0`` (past ``build_queue_cap`` the
lane's drains read the wall clock).

The reference's open-loop oracles of tests/test_serving.py are ported:
deadline bursts beat fixed bursts on a sparse stream, the throttle
never starves builds, replays are deterministic, and a closed-loop
configuration keeps the closed loop.
"""

import _torch_threads  # noqa: F401  (first: pins torch's threads)

import dataclasses

import numpy as np
import pytest

from repro.serving import admission as R_ad
from repro.serving import slo as R_slo
from repro_torch import serving as P_serving
from repro_torch.serving import admission as P_ad
from repro_torch.serving import slo as P_slo
from test_torch_build_service import assert_same_run, run_pair
from test_torch_runner import assert_same_db, hybrid, lost_slots

# ---------------------------------------------------------------------------
# Arrival generators: equal arrays from one seed
# ---------------------------------------------------------------------------

ARRIVAL_CASES = [
    ("uniform", 300, 2.0, 3, 8.0, 0.125, 1),
    ("poisson", 500, 2.0, 3, 8.0, 0.125, 1),
    ("poisson", 500, 0.7, 11, 8.0, 0.125, 3),
    ("bursty", 800, 5.0, 0, 8.0, 0.125, 1),
    ("bursty", 800, 5.0, 11, 4.0, 0.25, 1),
    ("bursty", 600, 1.5, 7, 8.0, 0.125, 4),
    ("uniform", 50, 1.0, 0, 8.0, 0.125, 2),
    ("bursty", 4, 0.0, 1, 8.0, 0.125, 1),     # mean <= 0: all at t = 0
    ("poisson", 0, 2.0, 1, 8.0, 0.125, 1),    # empty stream
]


@pytest.mark.parametrize("kind,n,mean,seed,peak,on,tenants", ARRIVAL_CASES)
def test_arrivals_equal_reference(kind, n, mean, seed, peak, on, tenants):
    kw = dict(seed=seed, peak_ratio=peak, on_frac=on, tenants=tenants)
    got = P_ad.make_arrivals(kind, n, mean, **kw)
    want = R_ad.make_arrivals(kind, n, mean, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if n:
        assert np.all(np.diff(got) >= 0.0)


def test_single_stream_generators_equal_reference():
    np.testing.assert_array_equal(P_ad.poisson_arrivals(200, 3.0, seed=4),
                                  R_ad.poisson_arrivals(200, 3.0, seed=4))
    np.testing.assert_array_equal(
        P_ad.bursty_arrivals(500, 2.0, seed=9, peak_ratio=6.0, on_frac=0.2,
                             epoch_ms=40.0, alpha=1.8),
        R_ad.bursty_arrivals(500, 2.0, seed=9, peak_ratio=6.0, on_frac=0.2,
                             epoch_ms=40.0, alpha=1.8))
    np.testing.assert_array_equal(P_ad.uniform_arrivals(7, 1.5),
                                  R_ad.uniform_arrivals(7, 1.5))
    assert P_ad.ARRIVAL_KINDS == R_ad.ARRIVAL_KINDS
    with pytest.raises(ValueError):
        P_ad.make_arrivals("fractal", 4, 1.0)


# ---------------------------------------------------------------------------
# Burst former and backlog primitives over a bursty stream
# ---------------------------------------------------------------------------

def _stream(seed=5, n=400):
    rng = np.random.default_rng(seed)
    arr = R_ad.make_arrivals("bursty", n, 1.0, seed=seed)
    batchable = rng.uniform(size=n) > 0.1
    phases = np.repeat(np.arange(4), n // 4)
    return arr, batchable, phases


@pytest.mark.parametrize("size,deadline", [(1, None), (8, None), (8, 0.5),
                                           (6, 2.0), (16, 0.0)])
def test_next_burst_walk_equals_reference(size, deadline):
    """Walk a whole stream with each package's burst former, the server
    busy for a hashed service time after each dispatch."""
    arr, batchable, phases = _stream()
    rng = np.random.default_rng(1)
    service = rng.exponential(1.0, size=len(arr))
    start, now, plans = 0, 0.0, 0
    while start < len(arr):
        got = P_ad.next_burst(arr, batchable, phases, start, now, size,
                              deadline)
        want = R_ad.next_burst(arr, batchable, phases, start, now, size,
                               deadline)
        assert (got.end, got.dispatch_at) == (want.end, want.dispatch_at)
        assert got.dispatch_at >= now
        now = got.dispatch_at + float(service[start])
        start = got.end
        plans += 1
    assert plans > 1


def test_close_rules_of_the_reference_hold():
    """tests/test_serving.py's close-rule cases through the port."""

    def plan(arr, batchable, phases, start=0, now=0.0, size=4, dl=None):
        return P_ad.next_burst(np.asarray(arr, float), batchable, phases,
                               start, now, size, dl)

    d = plan([1, 2, 3, 4, 50], [True] * 5, [0] * 5)
    assert (d.end, d.dispatch_at) == (4, 4.0)
    d = plan([1, 2, 10, 11], [True] * 4, [0] * 4, dl=2.0)
    assert (d.end, d.dispatch_at) == (2, 3.0)
    d = plan([1, 2, 3, 4, 5], [True] * 5, [0] * 5, now=100.0, dl=2.0)
    assert (d.end, d.dispatch_at) == (4, 100.0)
    d = plan([1, 2, 6, 7], [True, True, False, True], [0] * 4, dl=50.0)
    assert (d.end, d.dispatch_at) == (2, 6.0)
    d = plan([1, 2, 60, 61], [True, True, False, True], [0] * 4, dl=5.0)
    assert (d.end, d.dispatch_at) == (2, 6.0)
    d = plan([1, 2, 3, 4], [True] * 4, [0, 0, 1, 1])
    assert (d.end, d.dispatch_at) == (2, 3.0)
    d = plan([5, 6], [False, True], [0, 0])
    assert (d.end, d.dispatch_at) == (1, 5.0)
    d = plan([1, 2], [True, True], [0, 0], size=8)
    assert (d.end, d.dispatch_at) == (2, 2.0)


def test_backlog_gap_and_pressure_equal_reference():
    arr, _, _ = _stream(seed=8)
    for now in np.linspace(0.0, float(arr[-1]) + 5.0, 37):
        for served in (0, 10, 200, 399):
            assert P_ad.backlog_depth(arr, served, now) == (
                R_ad.backlog_depth(arr, served, now))
        for window in (4, 16):
            assert P_ad.recent_arrival_gap_ms(arr, now, window) == (
                R_ad.recent_arrival_gap_ms(arr, now, window))
    for depth in range(0, 12):
        for service in (0.0, 0.3, 1.0):
            for slo in (None, 2.0, 6.0):
                for frac in (1.0, 0.5):
                    args = (depth, service, slo, 0.5, frac)
                    assert P_ad.slo_pressure(*args) == (
                        R_ad.slo_pressure(*args))


# ---------------------------------------------------------------------------
# SLO report
# ---------------------------------------------------------------------------

def test_slo_digest_and_report_equal_reference():
    rng = np.random.default_rng(3)
    lat = list(rng.lognormal(0.0, 1.0, size=517))
    phases = list(rng.integers(0, 4, size=517))
    for slo in (None, 2.0, 5.0):
        assert dataclasses.astuple(P_slo.digest(lat, slo)) == (
            dataclasses.astuple(R_slo.digest(lat, slo)))
        got = P_slo.compute_slo(lat, phases, slo, availability=0.9,
                                downtime_ms=3.5, dropped=2)
        want = R_slo.compute_slo(lat, phases, slo, availability=0.9,
                                 downtime_ms=3.5, dropped=2)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert got.summary() == want.summary()
        assert dataclasses.astuple(got.phase(9)) == (
            dataclasses.astuple(R_slo.EMPTY_SLICE))
    assert P_slo.digest([], 5.0).n == 0
    with pytest.raises(ValueError):
        P_slo.compute_slo([1.0], [0, 1])
    assert set(P_serving.__all__) == {
        "BatchScheduler", "BurstDecision", "PredictivePrefixCache",
        "Request", "SloReport", "SloSlice", "backlog_depth",
        "compute_slo", "make_arrivals", "next_burst", "slo_pressure"}


# ---------------------------------------------------------------------------
# Whole open-loop runs against the reference
# ---------------------------------------------------------------------------

def open_pair(mode=None, total=160, use_kernel=False, shards=1, **serving):
    """test_serving.py's open-loop run (read_heavy, phases of 40, read
    bursts of 6, tuning every 2 ms) in both packages; asserts the runs
    equal field for field."""
    ref, rdb, port, pdb = run_pair(
        hybrid("read_heavy", total=total, phase_len=40),
        use_kernel=use_kernel, tuning_interval_ms=2.0, read_batch_size=6,
        num_shards=shards, async_tuning=mode, **serving)
    assert port.build_escalations == ref.build_escalations == 0
    assert_same_run(ref, port)
    assert_same_db(rdb, pdb)
    assert port.slo_report is not None
    assert port.deadline_miss_rate == port.slo_report.overall.miss_rate
    return port, pdb


STORM = dict(arrival_stream="bursty", arrival_ms=0.5, arrival_seed=7,
             slo_ms=2.0, burst_deadline_ms=0.5)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("throttle", [False, True],
                         ids=["free", "throttle_shed"])
@pytest.mark.parametrize("mode", [None, "deterministic", "overlap"])
def test_open_loop_run_matches_reference(mode, throttle, use_kernel):
    port, _ = open_pair(mode, use_kernel=use_kernel, build_throttle=throttle,
                        load_shed_tuning=throttle, build_queue_cap=8,
                        **STORM)
    assert len(port.latencies_ms) == 160
    assert all(lat > 0.0 for lat in port.latencies_ms)
    assert port.tuner_work_units > 0.0
    if mode == "overlap":
        assert port.tuner_overlapped_ms > 0.0
    if throttle and mode is not None:
        assert port.build_throttle_deferrals > 0


@pytest.mark.parametrize("kw", [
    dict(arrival_stream="poisson", arrival_ms=0.5, arrival_seed=3,
         slo_ms=2.0),
    dict(arrival_stream="uniform", arrival_ms=1.0, slo_ms=1.5,
         burst_deadline_ms=0.3),
    dict(burst_deadline_ms=0.4, slo_ms=2.0),   # deadline alone: t = 0
    dict(arrival_stream="bursty", arrival_ms=0.4, arrival_seed=7,
         arrival_tenants=3, slo_ms=2.0, burst_deadline_ms=0.5,
         build_throttle=True, load_shed_tuning=True, build_queue_cap=4),
], ids=["poisson", "uniform_deadline", "deadline_only", "tenants_shed"])
def test_open_loop_streams_match_reference(kw):
    mode = "deterministic" if kw.get("build_throttle") else "overlap"
    open_pair(mode, **kw)


def test_open_loop_on_four_shards_matches_reference():
    open_pair("overlap", shards=4, use_kernel=True, build_throttle=True,
              **STORM)


# ---------------------------------------------------------------------------
# The reference's open-loop oracles, held to the reference as well
# ---------------------------------------------------------------------------

def test_deadline_bursts_beat_fixed_bursts_on_sparse_stream():
    """On a sparse stream a fixed-size burst head waits for its batch to
    fill; the deadline close bounds that wait."""
    sparse = dict(arrival_stream="poisson", arrival_ms=1.0, arrival_seed=5,
                  slo_ms=2.0)
    fixed, _ = open_pair(**sparse)
    dead, _ = open_pair(burst_deadline_ms=0.3, **sparse)
    assert np.mean(dead.latencies_ms) < np.mean(fixed.latencies_ms)
    assert dead.deadline_miss_rate <= fixed.deadline_miss_rate


def test_throttle_never_starves_builds():
    """The urgent share builds through pressure: with the throttle on,
    the run still builds and ends with indexes serving queries.

    At the reference test's 240 statements the updates fill the table
    to its last slot, where the reference parks writes and loses the
    real row (ROADMAP.md queue 3 item 1).  The port keeps it, so the
    one scan that reads that row counts one more; every other field
    is equal."""
    ref, rdb, thr, pdb = run_pair(
        hybrid("read_heavy", total=240, phase_len=40),
        tuning_interval_ms=2.0, read_batch_size=6,
        async_tuning="deterministic", arrival_stream="bursty",
        arrival_ms=0.4, arrival_seed=7, slo_ms=2.0, burst_deadline_ms=0.5,
        build_throttle=True, load_shed_tuning=True, build_queue_cap=8)
    cap = pdb.tables["narrow"].capacity
    assert lost_slots(rdb, pdb).tolist() == [cap - 1]
    diff = [i for i, (a, b) in enumerate(zip(thr.results, ref.results))
            if a != b]
    assert len(diff) == 1
    (s, c, m), (rs, rc, rm) = thr.results[diff[0]], ref.results[diff[0]]
    assert c == rc + 1 and m == rm == 0
    thr.results = ref.results
    assert_same_run(ref, thr)
    assert thr.tuner_work_units > 0.0
    assert max(thr.index_counts) > 0
    assert thr.build_throttle_deferrals > 0


def test_open_loop_replay_is_deterministic():
    runs = [open_pair("overlap", build_throttle=True, load_shed_tuning=True,
                      build_queue_cap=8, **STORM)[0] for _ in range(2)]
    assert runs[0].latencies_ms == runs[1].latencies_ms
    assert runs[0].tuner_work_units == runs[1].tuner_work_units


def test_closed_loop_config_routes_to_closed_loop():
    """No arrival stream and no deadline: the closed loop, no SLO
    report (arrival_ms alone is the closed loop's client cadence)."""
    ref, _, port, _ = run_pair(hybrid("read_heavy", total=48),
                               tuning_interval_ms=2.0, read_batch_size=6,
                               arrival_ms=0.35)
    assert_same_run(ref, port)
    assert port.slo_report is None and port.deadline_miss_rate == 0.0
    assert "cumulative_ms" in port.summary()
