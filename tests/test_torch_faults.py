"""Parity of the port's fault injection (``repro_torch.faults``) with the
reference, on one engine.

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
"""

import dataclasses

import numpy as np
import pytest

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
