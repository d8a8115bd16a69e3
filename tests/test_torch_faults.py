"""Parity of the port's fault injection (``repro_torch.faults``) with the
reference, on one engine and on the replica tier.

``unit_hash``, the schedule generators and ``FaultInjector``'s draw
sequence equal the reference's draw for draw; whole ``run_workload``
runs under a fault schedule equal the reference's under the same
schedule.  Tolerance: none -- every ``RunResult`` field but ``wall_s``,
``execution_tiers`` and ``build_pages_per_ms``, the fault counters
included, is equal.

The single-engine invariants of tests/test_faults.py are ported: a
zero-fault schedule is bit-identical to no schedule (results AND cost
/ clock / tuner accounting, every async mode, 1 and 4 shards); with
recovery on, transient scan errors, stragglers and build failures
change latency and build pacing but never results; with recovery off
failed quanta are dropped and results still hold; an outage schedule
on one engine raises; and the build lane's retry / backoff /
quarantine / drop stub tests.

So are the replica cases: chaos with outages keeps the fault-free
results on mirrored and divergent tiers, 1 and 4 shards; recovery off
drops statements; a rejoined replica's tables and window equal a
replica that never crashed; all replicas down raises
``ClusterUnavailable``; a one-horse route consults no planner; crack
adoption under failover never double-counts a page; the open loop's
degraded mode; and the chaos trajectory replays across hash seeds.
"""

import _torch_threads  # noqa: F401  (first: pins torch's threads)

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.api as R
from repro.core import build_service as R_bs
from repro.faults import injector as R_inj
from repro.faults import schedule as R_sch
from repro_torch import api as P
from repro_torch import faults as P_faults
from repro_torch.core import build_service as P_bs
from repro_torch.core.cost_model import index_size_bytes
from repro_torch.faults import injector as P_inj
from repro_torch.faults import schedule as P_sch
from test_torch_build_service import _StubDB, assert_same_run
from test_torch_runner import assert_same_db, port_src

N_ROWS = 4_000
SRC = R.make_tuner_db(n_rows=N_ROWS)


# ---------------------------------------------------------------------------
# Schedules and the injector: draw for draw
# ---------------------------------------------------------------------------

def test_unit_hash_equals_reference():
    tags = ([f"scan:{i}:{r}" for i in range(300) for r in range(3)]
            + [f"straggler:{i}" for i in range(300)]
            + [f"build:{i}" for i in range(300)] + ["", "outage-len:7"])
    for seed in (0, 7, 11, -3, 2**40):
        assert [P_sch.unit_hash(seed, t) for t in tags] == [
            R_sch.unit_hash(seed, t) for t in tags]
    draws = [P_sch.unit_hash(7, f"scan:{i}:0") for i in range(200)]
    assert all(0.0 <= u < 1.0 for u in draws)
    assert abs(np.mean(draws) - 0.5) < 0.1


@pytest.mark.parametrize("n,horizon,seed,count,frac", [
    (3, 120.0, 3, 6, 0.25), (1, 50.0, 0, None, 0.25), (4, 1e3, 11, 9, 0.5),
    (2, 0.0, 1, None, 0.25), (3, 10.0, 2, 0, 0.25)])
def test_staggered_outages_equal_reference(n, horizon, seed, count, frac):
    got = P_sch.staggered_outages(n, horizon, seed=seed, count=count,
                                  down_frac=frac)
    want = R_sch.staggered_outages(n, horizon, seed=seed, count=count,
                                   down_frac=frac)
    assert [dataclasses.astuple(o) for o in got] == [
        dataclasses.astuple(o) for o in want]
    with pytest.raises(ValueError):
        P_sch.staggered_outages(0, 10.0)


@pytest.mark.parametrize("kw", [
    dict(seed=5), dict(seed=7, intensity=0.3, straggler_ms=0.5),
    dict(seed=2, n_replicas=3, horizon_ms=90.0, intensity=0.05)])
def test_chaos_schedule_equals_reference(kw):
    got, want = P_sch.chaos_schedule(**kw), R_sch.chaos_schedule(**kw)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.is_zero_fault() == want.is_zero_fault()
    assert P_faults.FaultSchedule().is_zero_fault()
    assert [(f.name, f.default) for f in dataclasses.fields(
        P_sch.FaultSchedule)] == [(f.name, f.default) for f in
                                  dataclasses.fields(R_sch.FaultSchedule)]


@pytest.mark.parametrize("recovery", [True, False])
@pytest.mark.parametrize("rates", [(0.08, 0.1, 0.2), (0.5, 0.0, 0.0),
                                   (0.0, 0.3, 0.0), (0.0, 0.0, 0.0),
                                   (0.9, 0.9, 0.9)])
def test_injector_draw_sequence_equals_reference(rates, recovery):
    """Scan and build draws interleaved as a run interleaves them; the
    counters and every answer equal the reference's."""
    scan, strag, build = rates
    sched = dict(seed=11, scan_error_rate=scan, straggler_rate=strag,
                 straggler_ms=0.3, build_fail_rate=build)
    p = P_inj.FaultInjector(P_sch.FaultSchedule(**sched), recovery)
    r = R_inj.FaultInjector(R_sch.FaultSchedule(**sched), recovery)
    rng = np.random.default_rng(4)
    for step in range(400):
        if rng.uniform() < 0.6:
            assert p.scan_fault() == r.scan_fault(), step
        else:
            assert p.build_fault() == r.build_fault(), step
    assert (p.scan_retries, p.straggler_events, p.build_failures,
            p._scan_seq, p._build_seq) == (
        r.scan_retries, r.straggler_events, r.build_failures, r._scan_seq,
        r._build_seq)
    outs = (P_sch.ReplicaOutage(0, 1.0, 2.0),)
    q = P_inj.FaultInjector(P_sch.FaultSchedule(outages=outs), recovery)
    assert [q.replica_down(0, t) for t in (0.5, 1.0, 1.5, 2.0, 9.0)] == (
        [False, True, True, False, False] if recovery
        else [False, True, True, True, True])


def test_typed_errors_and_exports():
    assert issubclass(P_faults.ClusterUnavailable, P_faults.FaultError)
    assert issubclass(P_faults.ReplicaUnavailable, P_faults.FaultError)
    assert issubclass(P_faults.FaultError, RuntimeError)
    for name in ("ClusterUnavailable", "FaultError", "FaultInjector",
                 "FaultSchedule", "ReplicaOutage", "ReplicaUnavailable",
                 "chaos_schedule", "staggered_outages", "SloReport"):
        assert name in P.__all__ and hasattr(P, name), name


# ---------------------------------------------------------------------------
# Whole runs under a schedule
# ---------------------------------------------------------------------------

def families_workload(pkg, dbt, total=90, tenants=3, seed=29, update_every=9):
    """tests/test_faults.py's per-tenant scans with a sprinkle of
    updates."""
    gen = pkg.QueryGen(dbt, seed=seed)
    items = []
    for i in range(total):
        if update_every and i % update_every == update_every - 1:
            items.append((0, gen.low_u()))
        else:
            items.append((0, gen.low_s(attr=1 + (i % tenants))))
    return pkg.Workload(items, "tenant families")


def run_one(pkg, tsrc, schedule=None, recovery=True,
            async_tuning="deterministic", num_shards=1, serving=None,
            use_kernel=False, total=90):
    """test_faults.py's ``run_once`` on one engine (n_replicas 1), with
    two build pages per cycle so that each index builds over many
    quanta (the default budget builds the 31-page table in one)."""
    sched_cls = R.FaultSchedule if pkg is R else P.FaultSchedule
    db = pkg.Database(dict(tsrc.tables))
    tuner = pkg.PredictiveTuner(db, pkg.TunerConfig(
        storage_budget_bytes=index_size_bytes(N_ROWS) * 1.25,
        pages_per_cycle=2, max_build_pages_per_cycle=4))
    cfg = pkg.RunConfig(
        execution=pkg.ExecOptions(num_shards=num_shards,
                                  use_kernel=use_kernel and pkg is P),
        tuning=pkg.TuningOptions(tuning_interval_ms=10.0,
                                 async_tuning=async_tuning),
        faults=pkg.FaultOptions(
            fault_schedule=None if schedule is None
            else sched_cls(**schedule), fault_recovery=recovery),
        serving=pkg.ServingOptions(**(serving or {})))
    return pkg.run_workload(db, tuner, families_workload(pkg, tsrc, total),
                            cfg), db


def fault_pair(**kw):
    """The same run in both packages; asserts them equal."""
    ref, rdb = run_one(R, SRC, **kw)
    port, pdb = run_one(P, port_src(SRC), **kw)
    assert port.build_escalations == ref.build_escalations == 0
    assert_same_run(ref, port)
    assert_same_db(rdb, pdb)
    return port, pdb


def fingerprint(res):
    return (res.latencies_ms, res.cumulative_ms, res.tuner_work_units,
            res.tuner_charged_ms, res.index_counts, res.built_fraction,
            res.results)


CHAOS = dict(seed=7, scan_error_rate=0.15, straggler_rate=0.2,
             straggler_ms=0.3, build_fail_rate=0.3)
OPEN = dict(arrival_stream="bursty", arrival_ms=0.5, arrival_seed=7,
            slo_ms=2.0, burst_deadline_ms=0.5, build_throttle=True)


def test_outages_on_one_engine_raise_before_any_state_change():
    src = port_src(SRC)
    db = P.Database(dict(src.tables))
    sched = P.FaultSchedule(outages=(P.ReplicaOutage(0, 1.0, 2.0),))
    cfg = P.RunConfig(execution=P.ExecOptions(num_shards=4),
                      faults=P.FaultOptions(fault_schedule=sched))
    with pytest.raises(ValueError, match="replica tier"):
        P.run_workload(db, P.make_dl_tuner(db, "predictive"),
                       families_workload(P, src, total=6), cfg)
    assert db.num_shards == 1 and db.fault_injector is None
    assert db.clock_ms == 0.0 and not db.monitor.records


@pytest.mark.parametrize("async_tuning", [None, "deterministic", "overlap"])
def test_zero_fault_schedule_bit_identical(async_tuning):
    """An attached schedule that can never fire leaves results AND
    accounting untouched, in every async mode; both equal the
    reference's."""
    base, _ = fault_pair(async_tuning=async_tuning)
    res, _ = fault_pair(async_tuning=async_tuning, schedule=dict(seed=5))
    assert fingerprint(res) == fingerprint(base)
    for f in dataclasses.fields(P.RunResult):
        if f.name not in ("wall_s", "execution_tiers", "build_pages_per_ms"):
            assert getattr(res, f.name) == getattr(base, f.name), f.name
    assert res.availability == 1.0 and res.dropped_queries == 0


def test_zero_fault_schedule_bit_identical_sharded():
    base, _ = fault_pair(num_shards=4, use_kernel=True)
    res, _ = fault_pair(num_shards=4, use_kernel=True,
                        schedule=dict(seed=5))
    assert fingerprint(res) == fingerprint(base)


@pytest.mark.parametrize("async_tuning,num_shards,use_kernel", [
    ("deterministic", 1, False), ("overlap", 1, True),
    ("deterministic", 4, True), (None, 1, False)])
def test_chaos_without_outages_keeps_results_with_recovery(
        async_tuning, num_shards, use_kernel):
    """Transient scan errors, stragglers and build failures with
    recovery on: results equal the fault-free run's, latency grows,
    and the run equals the reference's under the same schedule."""
    base, _ = fault_pair(async_tuning=async_tuning, num_shards=num_shards,
                         use_kernel=use_kernel)
    res, _ = fault_pair(async_tuning=async_tuning, num_shards=num_shards,
                        use_kernel=use_kernel, schedule=CHAOS)
    assert res.results == base.results
    assert res.availability == 1.0 and res.dropped_queries == 0
    assert res.fault_scan_retries + res.fault_stragglers > 0
    assert res.cumulative_ms > base.cumulative_ms
    if async_tuning is not None:
        assert res.fault_build_failures > 0
    else:  # the serialized path applies quanta inline: never injected
        assert res.fault_build_failures == 0


@pytest.mark.parametrize("recovery", [True, False])
def test_open_loop_overlap_under_faults(recovery):
    """The open loop, overlap lane and throttle under every transient
    category (test_faults.py's degraded-mode stream without its
    outages): results equal the fault-free stream with recovery on and
    off."""
    base, _ = fault_pair(async_tuning="overlap", serving=OPEN)
    res, _ = fault_pair(async_tuning="overlap", serving=OPEN,
                        schedule=CHAOS, recovery=recovery)
    assert res.results == base.results
    assert res.slo_report.availability == 1.0
    assert res.slo_report.dropped == 0
    assert res.fault_build_failures > 0
    assert res.fault_scan_retries + res.fault_stragglers > 0


def test_failed_quanta_retry_or_drop_in_the_lane():
    """With recovery the lane retries failed quanta (some land later);
    without it they are dropped: the recovery-off run builds less."""
    sched = dict(seed=3, build_fail_rate=0.5)
    on, _ = fault_pair(async_tuning="overlap", schedule=sched)
    off, _ = fault_pair(async_tuning="overlap", schedule=sched,
                        recovery=False)
    base, _ = fault_pair(async_tuning="overlap")
    assert on.results == off.results == base.results
    assert on.fault_build_failures > 0 and off.fault_build_failures > 0
    assert off.tuner_work_units < base.tuner_work_units


# ---------------------------------------------------------------------------
# The build lane's retry / backoff / quarantine (tests/test_faults.py)
# ---------------------------------------------------------------------------

class _ScriptedInjector:
    """Fault oracle with a scripted per-attempt outcome list."""

    def __init__(self, fails, recovery=True):
        self.fails = list(fails)
        self.recovery = recovery
        self.build_failures = 0

    def build_fault(self):
        fired = self.fails.pop(0) if self.fails else False
        if fired:
            self.build_failures += 1
        return fired


def _state(svc):
    return (svc.failed_applies, svc.retried_quanta, svc.dropped_quanta,
            [q.attempt for q in svc.quarantined],
            [(d, s, q.attempt) for d, s, q in svc.retry_queue],
            svc.pending(), svc.db.indexes["ix"].applied,
            svc.db.indexes["ix"].building)


@pytest.mark.parametrize("bs", [P_bs, R_bs], ids=["port", "reference"])
def test_build_retry_waits_out_backoff_then_applies(bs):
    db = _StubDB()
    svc = bs.BuildService(db, tuner=None, injector=_ScriptedInjector([True]),
                          max_attempts=3, backoff_ms=2.0)
    svc.queue.append(bs.BuildQuantum("ix", pages=4))
    assert svc.apply_next() == 0.0  # fault fires BEFORE any apply
    assert db.indexes["ix"].applied == 0
    assert svc.failed_applies == 1 and svc.retried_quanta == 1
    assert svc.pending() == 0  # parked: backoff deadline not due
    assert svc.drain() == 0.0  # drain terminates with everything parked
    db.clock_ms = 1.99
    assert svc.pending() == 0
    db.clock_ms = 2.0  # backoff_ms * 2**0
    assert svc.pending() == 1
    assert svc.apply_next() == 4.0
    assert db.indexes["ix"].applied == 4
    assert svc.retry_queue == [] and not svc.quarantined


@pytest.mark.parametrize("bs", [P_bs, R_bs], ids=["port", "reference"])
def test_build_quarantine_after_max_attempts_releases_index(bs):
    db = _StubDB()
    svc = bs.BuildService(db, tuner=None,
                          injector=_ScriptedInjector([True] * 10),
                          max_attempts=3, backoff_ms=1.0)
    svc.queue.append(bs.BuildQuantum("ix", pages=4))
    for _ in range(3):  # attempts 0, 1, 2 all fail
        svc.drain()
        db.clock_ms += 100.0
    assert [q.attempt for q in svc.quarantined] == [3]
    assert not db.indexes["ix"].building  # budget share released
    assert db.indexes["ix"].applied == 0
    assert svc.failed_applies == 3 and svc.retried_quanta == 2
    assert svc.retry_queue == [] and svc.pending() == 0


@pytest.mark.parametrize("bs", [P_bs, R_bs], ids=["port", "reference"])
def test_build_failure_without_recovery_drops_quantum(bs):
    db = _StubDB()
    svc = bs.BuildService(db, tuner=None,
                          injector=_ScriptedInjector([True], recovery=False))
    svc.queue.append(bs.BuildQuantum("ix", pages=4))
    assert svc.drain() == 0.0
    assert svc.dropped_quanta == 1 and svc.retried_quanta == 0
    assert svc.retry_queue == [] and svc.pending() == 0
    assert db.indexes["ix"].building  # no quarantine in the baseline


@pytest.mark.parametrize("recovery", [True, False])
def test_scripted_failures_walk_both_services_alike(recovery):
    """A longer script of failures, clock steps and drains through both
    packages' services: every counter and queue equal at every step."""
    rng = np.random.default_rng(9)
    script = list(rng.uniform(size=60) < 0.45)
    svcs = []
    for bs in (R_bs, P_bs):
        svc = bs.BuildService(_StubDB(), tuner=None,
                              injector=_ScriptedInjector(script, recovery),
                              max_attempts=3, backoff_ms=1.5)
        for k in range(12):
            svc.queue.append(bs.BuildQuantum("ix", pages=1 + k % 3))
        svcs.append(svc)
    for step in range(30):
        for svc in svcs:
            if step % 3 == 2:
                svc.drain()
            else:
                svc.apply_next()
            svc.db.clock_ms += 0.75
        assert _state(svcs[1]) == _state(svcs[0]), step


# ---------------------------------------------------------------------------
# The replica tier under faults (tests/test_faults.py's replica cases)
# ---------------------------------------------------------------------------

def run_replicas(pkg, tsrc, n_replicas=3, divergent=False,
                 async_tuning="deterministic", num_shards=1, schedule=None,
                 recovery=True, total=90, serving=None):
    """test_faults.py's ``run_once``: a replica tier with the default
    build budget; ``schedule`` is a FaultSchedule's fields (outages as
    (replica, start, end) tuples)."""
    if schedule is not None:
        schedule = dict(schedule, outages=tuple(
            pkg.ReplicaOutage(*o) for o in schedule.get("outages", ())))
    db = pkg.Database(dict(tsrc.tables))
    tuner = pkg.PredictiveTuner(db, pkg.TunerConfig(
        storage_budget_bytes=index_size_bytes(N_ROWS) * 1.25))
    cfg = pkg.RunConfig(
        execution=pkg.ExecOptions(num_shards=num_shards),
        tuning=pkg.TuningOptions(tuning_interval_ms=10.0,
                                 async_tuning=async_tuning),
        replica=pkg.ReplicaOptions(n_replicas=n_replicas,
                                   divergent_tuning=divergent),
        faults=pkg.FaultOptions(
            fault_schedule=None if schedule is None
            else pkg.FaultSchedule(**schedule), fault_recovery=recovery),
        serving=pkg.ServingOptions(**(serving or {})))
    return pkg.run_workload(db, tuner, families_workload(pkg, tsrc, total),
                            cfg), db


def replica_pair(**kw):
    """The same replica-tier run in both packages, asserted equal field
    for field (replica 0's clock, window and catalog too)."""
    ref, rdb = run_replicas(R, SRC, **kw)
    port, pdb = run_replicas(P, port_src(SRC), **kw)
    assert port.build_escalations == ref.build_escalations == 0
    assert_same_run(ref, port)
    assert_same_db(rdb, pdb)
    return port


def chaos_sched(horizon_ms, seed=7):
    """test_faults.py's ``chaos``: staggered quorum-safe outages and
    every transient category."""
    outs = P_sch.staggered_outages(3, horizon_ms, seed=seed)
    return dict(CHAOS, seed=seed, outages=tuple(
        dataclasses.astuple(o) for o in outs))


@pytest.mark.parametrize("divergent,num_shards",
                         [(False, 1), (True, 1), (False, 4), (True, 4)])
def test_chaos_results_bit_identical_with_recovery(divergent, num_shards):
    """Crashes, rejoins, scan retries, stragglers and build failures with
    recovery on keep the fault-free results, on mirrored and divergent
    tiers, 1 and 4 shards; each run equals the reference's."""
    base = replica_pair(divergent=divergent, num_shards=num_shards)
    res = replica_pair(divergent=divergent, num_shards=num_shards,
                       schedule=chaos_sched(0.8 * base.cumulative_ms))
    assert res.results == base.results
    assert res.availability == 1.0 and res.dropped_queries == 0
    assert res.fault_downtime_ms > 0.0
    assert res.fault_scan_retries + res.fault_stragglers > 0
    assert res.cumulative_ms > base.cumulative_ms


def test_no_recovery_baseline_degrades_availability():
    """Recovery off: permanent crashes drop the statements routed to dead
    replicas, as in the reference."""
    base = replica_pair()
    res = replica_pair(schedule=chaos_sched(0.8 * base.cumulative_ms),
                       recovery=False)
    assert res.dropped_queries > 0 and res.availability < 1.0
    assert len(res.results) < len(base.results)


def _tables_equal(a, b):
    return all(
        ta.n_rows == tb.n_rows and all(torch.equal(x, y) for x, y in zip(
            (ta.data, ta.begin_ts, ta.end_ts),
            (tb.data, tb.begin_ts, tb.end_ts)))
        for ta, tb in ((a[k], b[k]) for k in a))


def test_rejoin_replays_catchup_bit_identical():
    """A replica that crashes through scans and UPDATEs rejoins with
    tables and monitor window equal to a replica that never crashed
    (catch-up replay at the original base clocks); every statement,
    clock and counter equals the reference's set."""
    rsrc = R.make_tuner_db(n_rows=2_000)
    sets = []
    for pkg, tsrc in ((R, rsrc), (P, port_src(rsrc))):
        gen = pkg.QueryGen(tsrc, seed=11)

        def stmt(i):
            return gen.low_u() if i % 4 == 3 else gen.low_s(attr=1 + (i % 2))

        rs = pkg.ReplicaSet(pkg.Database(dict(tsrc.tables)), 3)
        stats = [rs.execute(stmt(i)) for i in range(6)]
        lat = rs.execute(gen.low_s(attr=1)).latency_ms
        down, up = rs.clock_ms + 0.25 * lat, rs.clock_ms + 6.0 * lat
        rs.fault_injector = pkg.FaultInjector(pkg.FaultSchedule(
            outages=(pkg.ReplicaOutage(1, down, up),)), recovery=True)
        i = 7
        while rs.clock_ms <= up + lat:
            stats.append(rs.execute(stmt(i)))
            i += 1
        sets.append((rs, [_stats_key(s) for s in stats], i))
    (ref, ref_stats, n_ref), (rs, port_stats, n) = sets
    assert port_stats == ref_stats and n == n_ref
    assert (rs.rejoins, rs.downtime_ms, rs.failover_routes, rs._down) == (
        ref.rejoins, ref.downtime_ms, ref.failover_routes, ref._down)
    assert rs.rejoins == 1 and rs.downtime_ms[1] > 0.0
    assert rs.failover_routes > 0 and not any(rs._down)
    assert _tables_equal(rs.dbs[1].tables, rs.dbs[2].tables)
    assert _tables_equal(rs.dbs[1].tables, rs.dbs[0].tables)
    assert list(rs.dbs[1].monitor.records) == list(rs.dbs[2].monitor.records)
    assert rs.dbs[1].clock_ms == rs.dbs[2].clock_ms == ref.dbs[1].clock_ms


def _stats_key(s):
    return (s.cost_units, s.latency_ms, s.used_index, s.agg_sum, s.count,
            s.rows_modified)


def test_all_replicas_down_raises_typed_error():
    src = port_src(R.make_tuner_db(n_rows=1_000))
    gen = P.QueryGen(src, seed=5)
    outs = (P.ReplicaOutage(0, 0.0, 1e9), P.ReplicaOutage(1, 0.0, 1e9))
    rs = P.ReplicaSet(P.Database(dict(src.tables)), 2)
    rs.fault_injector = P.FaultInjector(P.FaultSchedule(outages=outs),
                                        recovery=True)
    with pytest.raises(P.ClusterUnavailable):
        rs.execute(gen.low_s())
    with pytest.raises(P.ClusterUnavailable):
        rs.execute(gen.low_u())
    # recovery off: the blind router drops instead of raising
    rs2 = P.ReplicaSet(P.Database(dict(src.tables)), 2)
    rs2.fault_injector = P.FaultInjector(P.FaultSchedule(outages=outs),
                                         recovery=False)
    assert rs2.execute(gen.low_s()) is None
    assert rs2.execute(gen.low_u()) is None
    assert rs2.execute_batch([gen.low_s(), gen.low_s()]) == [None, None]
    assert rs2.dropped_statements == 4


def test_route_short_circuits_skip_planner():
    """A single candidate never consults a planner: one-replica sets,
    empty bursts and a lone failover survivor."""
    src = port_src(R.make_tuner_db(n_rows=1_000))
    q = P.QueryGen(src, seed=3).low_s()

    def boom(*a, **k):
        raise AssertionError("planner consulted on a one-horse race")

    rs1 = P.ReplicaSet(P.Database(dict(src.tables)), 1)
    rs1.dbs[0].planner.estimate_scan_cost = boom
    assert rs1.route_scan(q) == 0
    assert rs1.route_burst([]) == 0
    assert rs1.route_burst([q, q]) == 0
    rs3 = P.ReplicaSet(P.Database(dict(src.tables)), 3)
    for d in rs3.dbs:
        d.planner.estimate_scan_cost = boom
    rs3.fault_injector = P.FaultInjector(P.FaultSchedule(), recovery=True)
    rs3._down = [False, True, True]
    assert rs3.route_scan(q) == 0
    assert rs3.route_burst([q]) == 0
    assert rs3.failover_routes == 2


_CRACK_SRC = R.make_tuner_db(n_rows=2_000)


@pytest.mark.parametrize("seed", [0, 5, 8168])
def test_crack_under_failover_never_double_counts(seed):
    """Crack adoption, build quanta and failover together: every
    replica's coverage index holds exactly page_size entries per
    covered page, results stay the no-index engine's, and every
    statement and catalog equals the reference's (the masked scans run
    K3's plain version)."""
    runs = []
    for pkg, tsrc in ((R, _CRACK_SRC), (P, port_src(_CRACK_SRC))):
        gen, gen_o = pkg.QueryGen(tsrc, seed=seed), pkg.QueryGen(tsrc,
                                                                 seed=seed)
        rs = pkg.ReplicaSet(pkg.Database(dict(tsrc.tables)), 3)
        rs.crack_on_scan = True
        rs.crack_pages_per_scan = 4
        outs = P_sch.staggered_outages(3, 12.0, seed=seed)
        rs.fault_injector = pkg.FaultInjector(pkg.FaultSchedule(
            seed=seed, outages=tuple(pkg.ReplicaOutage(
                *dataclasses.astuple(o)) for o in outs)),
            recovery=True)
        tuner = pkg.ReplicaSetTuner(rs, pkg.PredictiveTuner(
            rs.dbs[0], pkg.TunerConfig(
                storage_budget_bytes=index_size_bytes(2_000) * 1.25)))
        oracle = pkg.Database(dict(tsrc.tables))
        stats = []
        for i in range(40):
            q, qo = gen.low_s(attr=1 + (i % 2)), gen_o.low_s(attr=1 + (i % 2))
            s, so = rs.execute(q), oracle.execute(qo)
            assert (s.agg_sum, s.count) == (so.agg_sum, so.count), i
            stats.append(_stats_key(s))
            tuner.on_query(q, s)
            if i % 8 == 7:
                tuner.tuning_cycle()
        runs.append((rs, stats))
    (ref, ref_stats), (rs, stats) = runs
    assert stats == ref_stats
    assert rs.routed_queries == ref.routed_queries
    checked = 0
    for d, rd in zip(rs.dbs, ref.dbs):
        assert sorted(d.indexes) == sorted(rd.indexes)
        for name, bi in d.indexes.items():
            if bi.coverage is None:
                continue
            t = d.tables[bi.desc.table]
            elig = set(int(p) for p in P.eligible_global_pages(t))
            covered = np.flatnonzero(bi.coverage.built)
            assert set(int(p) for p in covered) <= elig
            assert bi.vap.n_entries == bi.coverage.count() * t.page_size
            np.testing.assert_array_equal(
                covered, np.flatnonzero(rd.indexes[name].coverage.built))
            checked += 1
    assert checked > 0


OPEN_REPLICA = dict(arrival_stream="bursty", arrival_ms=0.5, arrival_seed=7,
                    slo_ms=2.0, burst_deadline_ms=0.5, build_throttle=True)


def test_degraded_mode_open_loop_recovery_vs_baseline():
    """The open loop through a mid-run crash: with recovery the SLO
    report shows full availability and downtime and the results equal
    the fault-free stream's; without it statements drop.  Each run
    equals the reference's."""
    base = replica_pair(async_tuning="overlap", serving=OPEN_REPLICA)
    sched = dict(seed=3, outages=((1, 2.0, 6.0), (2, 8.0, 12.0)),
                 straggler_rate=0.1, straggler_ms=0.2)
    rec = replica_pair(async_tuning="overlap", serving=OPEN_REPLICA,
                       schedule=sched)
    assert rec.results == base.results
    assert rec.slo_report.availability == 1.0
    assert rec.slo_report.downtime_ms > 0.0 and rec.slo_report.dropped == 0
    bad = replica_pair(async_tuning="overlap", serving=OPEN_REPLICA,
                       schedule=sched, recovery=False)
    assert bad.dropped_queries > 0 and bad.slo_report.availability < 1.0
    assert bad.slo_report.dropped == bad.dropped_queries


def test_lost_capacity_trips_throttle_earlier():
    """``slo_pressure`` scales its headroom by the up fraction, as the
    reference's does; full capacity is the healthy predicate."""
    from repro.serving.admission import slo_pressure as r_pressure
    from repro_torch.serving.admission import slo_pressure

    assert not slo_pressure(2, 1.0, slo_ms=6.0)
    assert slo_pressure(2, 1.0, slo_ms=6.0, capacity_frac=0.5)
    for depth in range(8):
        for frac in (1.0, 2 / 3, 0.5, 1 / 3):
            assert slo_pressure(depth, 1.0, 6.0, 0.5, frac) == r_pressure(
                depth, 1.0, 6.0, 0.5, frac)
        assert slo_pressure(depth, 1.0, slo_ms=6.0) == slo_pressure(
            depth, 1.0, slo_ms=6.0, capacity_frac=1.0)


_HASHSEED_SCRIPT = """
import warnings
warnings.simplefilter("ignore")
from repro_torch import api as P
from repro_torch.core.cost_model import index_size_bytes

def run(schedule=None):
    src = P.make_tuner_db(n_rows=4000, device="cpu")
    gen = P.QueryGen(src, seed=29)
    wl = P.Workload([(0, gen.low_u() if i % 9 == 8
                      else gen.low_s(attr=1 + i % 3)) for i in range(90)],
                    "families")
    db = P.Database(dict(src.tables))
    tuner = P.PredictiveTuner(db, P.TunerConfig(
        storage_budget_bytes=index_size_bytes(4000) * 1.25))
    return P.run_workload(db, tuner, wl, P.RunConfig(
        tuning=P.TuningOptions(tuning_interval_ms=10.0,
                               async_tuning="deterministic"),
        replica=P.ReplicaOptions(n_replicas=3),
        faults=P.FaultOptions(fault_schedule=schedule)))

base = run()
res = run(P.FaultSchedule(
    seed=7, outages=P.staggered_outages(3, 0.8 * base.cumulative_ms, seed=7),
    scan_error_rate=0.15, straggler_rate=0.2, straggler_ms=0.3,
    build_fail_rate=0.3))
print(res.results == base.results)
print(res.fault_scan_retries, res.fault_stragglers,
      res.fault_build_failures, round(res.fault_downtime_ms, 9))
print([round(x, 9) for x in res.latencies_ms[-10:]])
"""


def test_chaos_deterministic_across_hash_seeds():
    """The whole fault trajectory replays bit for bit under different
    PYTHONHASHSEED values (the script imports only the port)."""
    outs = []
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    for seed in ("0", "1"):
        env = dict(os.environ, PYTHONHASHSEED=seed, PYTHONPATH=src)
        out = subprocess.run([sys.executable, "-c", _HASHSEED_SCRIPT],
                             capture_output=True, text=True, env=env,
                             check=True)
        outs.append(out.stdout)
    assert outs[0] == outs[1]
    assert outs[0].startswith("True")
