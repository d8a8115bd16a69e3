"""Parity of the port's async build lane (``core.build_service``) with
the reference.

``BuildService`` in both packages, and whole ``run_workload`` runs with
``async_tuning`` None / "deterministic" / "overlap" against the
reference's on the same numpy inputs (``test_torch_runner.run_pair``).
Tolerance: none.  Every ``RunResult`` field but ``wall_s``,
``execution_tiers`` (which tier served each query) and
``build_pages_per_ms`` (the lane's measured throughput, a wall clock)
is equal, and so are the clock, the monitor window and each index's
build state.  Overlap runs assert ``build_escalations == 0``: past
``build_queue_cap`` the lane's drain sizes read the wall clock, in
both packages.  The escalation arithmetic itself is held by stub-DB
tests that give both services the same ``pages_per_ms``.

The oracles of tests/test_async_tuning.py are ported: deterministic
equals serialized on 1 and 4 shards, decide + apply equals the
monolithic cycle, baseline tuners run whole cycles in ``decide``,
mid-burst quanta leave the burst's results as planned (on a VAP index
and on a coverage index with page-list quanta), overlap takes build
work out of the blocking path, and stale quanta are skipped.
"""

import _torch_threads  # noqa: F401  (first: pins torch's threads)

import dataclasses

import numpy as np
import pytest

import repro.api as R
from repro.bench_db import runner as R_run
from repro.core import build_service as R_bs
from repro.core.baselines import OnlineTuner as ROnlineTuner
from repro_torch import api as P
from repro_torch.core import build_service as P_bs
from test_torch_runner import SRC, _cfg, assert_same_db, hybrid, port_src

EXEMPT = ("wall_s", "execution_tiers", "build_pages_per_ms")
N_PAGES = int(SRC.tables["narrow"].n_pages)
STAT_FIELDS = ("agg_sum", "count", "cost_units", "latency_ms", "used_index",
               "populate_units")


def assert_same_run(ref, port):
    """Every RunResult field but the exempt ones (an SLO report by
    value: the packages have their own ``SloReport`` classes)."""
    for f in dataclasses.fields(R_run.RunResult):
        if f.name in EXEMPT:
            continue
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if f.name == "slo_report" and b is not None:
            a, b = dataclasses.astuple(a), dataclasses.astuple(b)
        assert a == b, f.name
    assert port.summary().keys() == ref.summary().keys()


def run_pair(make_workload, tuner="predictive", use_kernel=False, **cfg):
    """One run in each package: (reference result, reference db, port
    result, port db).  ``tuner`` is "predictive" or "online"; the port
    runs its kernel path when ``use_kernel``."""
    out = []
    for pkg, tsrc in ((R, SRC), (P, port_src())):
        db = pkg.Database(dict(tsrc.tables))
        t = (pkg.make_dl_tuner(db, "predictive") if tuner == "predictive"
             else (ROnlineTuner if pkg is R else P.OnlineTuner)(db))
        res = pkg.run_workload(db, t, make_workload(pkg, tsrc), _cfg(
            pkg, use_kernel=use_kernel and pkg is P, **cfg))
        out += [res, db]
    return tuple(out)


def lane_pair(mode, batch=6, shards=1, use_kernel=False, tuner="predictive",
              total=72, **kw):
    """run_pair on test_async_tuning.py's workload (read_heavy, phases of
    24, tuning every 2 ms); asserts the runs equal field for field."""
    ref, rdb, port, pdb = run_pair(
        hybrid("read_heavy", total=total), tuner, use_kernel=use_kernel,
        tuning_interval_ms=2.0, read_batch_size=batch, num_shards=shards,
        async_tuning=mode, **kw)
    assert port.build_escalations == ref.build_escalations == 0
    assert_same_run(ref, port)
    assert_same_db(rdb, pdb)
    return ref, rdb, port, pdb


# ---------------------------------------------------------------------------
# Whole runs against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("batch", [1, 6])
@pytest.mark.parametrize("mode", ["deterministic", "overlap"])
def test_async_run_matches_reference(mode, batch, shards, use_kernel):
    _, _, port, pdb = lane_pair(mode, batch, shards, use_kernel)
    assert port.tuner_work_units > 0.0 and pdb.indexes
    if mode == "overlap":
        assert port.tuner_charged_ms == 0.0 < port.tuner_overlapped_ms
    else:
        assert port.tuner_overlapped_ms == 0.0


@pytest.mark.parametrize("mode", [None, "deterministic", "overlap"])
def test_online_tuner_through_the_lane_matches_reference(mode):
    """OnlineTuner has no ``decide``: the service runs its whole cycle
    (a FULL build) inside ``decide`` and queues nothing."""
    _, _, port, pdb = lane_pair(mode, tuner="online")
    assert port.tuner_overlapped_ms == 0.0
    assert any(b.scheme == "full" for b in pdb.indexes.values())


@pytest.mark.parametrize("shards", [1, 4])
def test_deterministic_mode_bit_identical_to_serialized(shards):
    """test_async_tuning.py's acceptance run in the port: the decide /
    apply pipeline equals serialized tuning in results and cost /
    clock / monitor accounting, for 1 and 4 shards."""
    ser, _, ser_port, ser_db = lane_pair(None, shards=shards)
    _, _, det_port, det_db = lane_pair("deterministic", shards=shards)
    assert ser_port.tuner_work_units > 0.0
    for f in dataclasses.fields(P.RunResult):
        if f.name not in EXEMPT:
            assert getattr(det_port, f.name) == getattr(ser_port, f.name), (
                f.name)
    assert det_db.clock_ms == ser_db.clock_ms
    assert list(det_db.monitor.records) == list(ser_db.monitor.records)
    assert [(n, b.vap.built_pages, b.vap.n_entries)
            for n, b in det_db.indexes.items()] == [
        (n, b.vap.built_pages, b.vap.n_entries)
        for n, b in ser_db.indexes.items()]


def test_overlap_mode_removes_blocking_and_carries_over():
    """Overlap charges no cycle work to the blocking path: it rides the
    concurrent lane, and what a burst cannot drain stays queued."""
    ser = lane_pair(None)[2]
    _, _, got, db = lane_pair("overlap")
    assert ser.tuner_charged_ms > 0.0
    assert got.tuner_charged_ms == 0.0 < got.tuner_overlapped_ms
    assert got.tuner_work_units > 0.0 and db.indexes


def test_overlap_without_bursts_still_builds():
    """read_batch_size 1 has no burst groups to interleave with: the
    lane drains at the single dispatches and in idle credit."""
    _, _, got, db = lane_pair("overlap", batch=1)
    assert got.tuner_work_units > 0.0 and got.tuner_charged_ms == 0.0
    assert any(b.vap.built_pages > 0 for b in db.indexes.values())


def test_overlap_with_crack_on_scan_matches_reference():
    """Bitmap-mode quanta (hot-range page lists, chunked in order) on
    the overlap lane, with crack adoption between them."""
    _, _, port, pdb = lane_pair("overlap", use_kernel=True,
                                crack_on_scan=True, index_decay=True)
    assert any(b.coverage is not None for b in pdb.indexes.values())
    assert port.tuner_overlapped_ms > 0.0


def test_adaptive_build_budget_resizes_the_cycle():
    """The wall-clock path: the lane's measured pages/ms resizes
    pages_per_cycle within [1, max_build_pages_per_cycle].  No parity
    is claimed for it (it reads the wall clock)."""
    src = port_src()
    db = P.Database(dict(src.tables))
    tuner = P.make_dl_tuner(db, "predictive")
    res = P.run_workload(db, tuner, hybrid("read_heavy")(P, src),
                         P.RunConfig(
                             execution=P.ExecOptions(read_batch_size=6),
                             tuning=P.TuningOptions(
                                 tuning_interval_ms=2.0,
                                 async_tuning="overlap",
                                 adaptive_build_budget=True)))
    assert res.build_pages_per_ms > 0.0
    assert 1 <= res.build_pages_per_cycle <= (
        tuner.cfg.max_build_pages_per_cycle)
    assert tuner.cfg.pages_per_cycle == res.build_pages_per_cycle


# ---------------------------------------------------------------------------
# Decide / apply and the service against the reference's
# ---------------------------------------------------------------------------

def _warm_pair(seed, n=8):
    """A reference and a port database that ran the same LOW-S scans."""
    gen_r = R.QueryGen(SRC, selectivity=0.01, seed=seed)
    psrc = port_src()
    gen_p = P.QueryGen(psrc, selectivity=0.01, seed=seed)
    rdb, pdb = R.Database(dict(SRC.tables)), P.Database(dict(psrc.tables))
    for _ in range(n):
        rdb.execute(gen_r.low_s(attr=1))
        pdb.execute(gen_p.low_s(attr=1))
    return rdb, pdb


def test_decide_apply_split_matches_monolithic_cycle_and_reference():
    """decide + apply_quantum does the work of the monolithic cycle, and
    the port's quanta equal the reference's, cycle by cycle."""
    (rdb, pdb), (_, pdb2) = _warm_pair(31), _warm_pair(31)
    rt = R.make_dl_tuner(rdb, "predictive")
    pt, pt2 = (P.make_dl_tuner(pdb, "predictive"),
               P.make_dl_tuner(pdb2, "predictive"))
    for _ in range(3):
        rplan, pplan = rt.decide(), pt.decide()
        assert [(q.index_name, q.pages, q.shard, q.utility, q.page_list)
                for q in pplan.quanta] == [
            (q.index_name, q.pages, q.shard, q.utility, q.page_list)
            for q in rplan.quanta]
        rwork = rplan.decide_work + sum(R_bs.apply_quantum(rdb, q)
                                        for q in rplan.quanta)
        pwork = pplan.decide_work + sum(P_bs.apply_quantum(pdb, q)
                                        for q in pplan.quanta)
        assert pwork == rwork == pt2.tuning_cycle()
    for name, rb in rdb.indexes.items():
        for db in (pdb, pdb2):
            assert (db.indexes[name].vap.built_pages,
                    db.indexes[name].vap.n_entries) == (
                int(rb.vap.built_pages), int(rb.vap.n_entries))


@pytest.mark.parametrize("quantum_pages", [None, 3])
def test_service_queue_matches_reference(quantum_pages):
    """BuildService.decide slices a cycle's quanta as the reference's
    does (``split_build_pages``), and ``drain`` charges the same work."""
    rdb, pdb = _warm_pair(37)
    rs = R_bs.BuildService(rdb, R.make_dl_tuner(rdb, "predictive"),
                           quantum_pages=quantum_pages)
    ps = P_bs.BuildService(pdb, P.make_dl_tuner(pdb, "predictive"),
                           quantum_pages=quantum_pages)
    queued = 0
    for _ in range(4):
        assert ps.decide() == rs.decide()
        assert [(q.index_name, q.pages, q.utility) for q in ps.queue] == [
            (q.index_name, q.pages, q.utility) for q in rs.queue]
        assert ps.pending() == rs.pending()
        queued += ps.pending()
        assert ps.drain() == rs.drain()
        assert ps.drained_quanta == rs.drained_quanta
    assert queued > 0 and ps.pages_per_ms > 0.0


def test_legacy_tuner_fallback_runs_whole_cycle_in_decide():
    rdb, pdb = _warm_pair(41, n=6)
    ref_work = ROnlineTuner(rdb).tuning_cycle()
    service = P_bs.BuildService(pdb, P.OnlineTuner(pdb))
    assert service.decide() == ref_work
    assert service.pending() == 0
    assert sorted(pdb.indexes) == sorted(rdb.indexes)


def _mk_vap(pkg, src):
    db = pkg.Database(dict(src.tables))
    bi = db.create_index(pkg.IndexDescriptor("narrow", (1,)), "vap")
    db.vap_build_step(bi, N_PAGES // 4)
    return db


def _midburst_queries(pkg, src):
    gen = pkg.QueryGen(src, selectivity=0.01, seed=37)
    # Two plan groups: the table-scan group dispatches first, then the
    # hybrid group -- the drain hook fires between them.
    return ([gen.low_s(attr=2) for _ in range(4)]
            + [gen.low_s(attr=1) for _ in range(4)])


def _stats(s):
    return tuple(getattr(s, f) for f in STAT_FIELDS)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_overlap_midburst_builds_do_not_perturb_inflight_burst(use_kernel):
    """test_async_tuning.py's oracle: quanta drained between the
    dispatches of one burst leave its results and accounting as planned
    at burst start (the planner's snapshot), while built_pages advances
    underneath -- and every stats field equals the reference's."""
    psrc = port_src()
    queries = _midburst_queries(P, psrc)
    ref_db = _mk_vap(P, psrc)
    ref = [ref_db.execute(q) for q in queries]
    db = _mk_vap(P, port_src())
    service = P_bs.BuildService(db, tuner=None)
    for _ in range(4):
        service.queue.append(P_bs.BuildQuantum("narrow:1", 4))
    before = db.indexes["narrow:1"].vap
    db.engine.after_dispatch = service.apply_next
    try:
        got = db.execute_batch(queries, use_kernel=use_kernel)
    finally:
        db.engine.after_dispatch = None
    assert [_stats(s) for s in got] == [_stats(s) for s in ref]
    assert db.indexes["narrow:1"].vap.built_pages > (
        ref_db.indexes["narrow:1"].vap.built_pages)
    assert service.pending() < 4
    # The pinned state was not written in place.
    assert db.indexes["narrow:1"].vap is not before
    assert before.built_pages == N_PAGES // 4

    # The reference's run of the same burst agrees stat for stat.
    rdb = _mk_vap(R, SRC)
    rservice = R_bs.BuildService(rdb, tuner=None)
    for _ in range(4):
        rservice.queue.append(R_bs.BuildQuantum("narrow:1", 4))
    rdb.engine.after_dispatch = rservice.apply_next
    try:
        rgot = rdb.execute_batch(_midburst_queries(R, SRC))
    finally:
        rdb.engine.after_dispatch = None
    assert [_stats(s) for s in got] == [_stats(s) for s in rgot]
    assert db.indexes["narrow:1"].vap.built_pages == int(
        rdb.indexes["narrow:1"].vap.built_pages)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_overlap_midburst_page_list_quanta_on_a_coverage_index(use_kernel):
    """The same oracle on a coverage (bitmap-mode) index: page-list
    quanta set bits of the live ``PageCoverage`` in place between the
    groups, while the burst's hybrid_masked group still scans against
    the ``CoverageView`` pinned at burst start."""

    def mk(pkg, src):
        db = pkg.Database(dict(src.tables))
        db.crack_on_scan = True  # attaches the bitmap at create_index
        bi = db.create_index(pkg.IndexDescriptor("narrow", (1,)), "vap")
        db.crack_on_scan = False  # quanta alone move the bitmap
        db.vap_build_step(bi, 4, page_list=[1, 5, 9, 13])
        return db

    psrc = port_src()
    queries = _midburst_queries(P, psrc)
    ref_db = mk(P, psrc)
    ref = [ref_db.execute(q) for q in queries]
    db = mk(P, port_src())
    bi = db.indexes["narrow:1"]
    assert bi.coverage is not None and not bi.coverage.is_prefix()
    service = P_bs.BuildService(db, tuner=None)
    lists = [(0, 2), (3, 4), (6, 7, 8), (10, 11)]
    for pl in lists:
        service.queue.append(P_bs.BuildQuantum("narrow:1", len(pl),
                                               page_list=pl))
    db.engine.after_dispatch = service.apply_next
    try:
        got = db.execute_batch(queries, use_kernel=use_kernel)
    finally:
        db.engine.after_dispatch = None
    assert [_stats(s) for s in got] == [_stats(s) for s in ref]
    assert bi.coverage.count() > ref_db.indexes["narrow:1"].coverage.count()
    assert service.pending() < len(lists)

    rdb = mk(R, SRC)
    rservice = R_bs.BuildService(rdb, tuner=None)
    for pl in lists:
        rservice.queue.append(R_bs.BuildQuantum("narrow:1", len(pl),
                                                page_list=pl))
    rdb.engine.after_dispatch = rservice.apply_next
    try:
        rgot = rdb.execute_batch(_midburst_queries(R, SRC))
    finally:
        rdb.engine.after_dispatch = None
    assert [_stats(s) for s in got] == [_stats(s) for s in rgot]
    np.testing.assert_array_equal(bi.coverage.built,
                                  rdb.indexes["narrow:1"].coverage.built)
    assert bi.vap.n_entries == int(rdb.indexes["narrow:1"].vap.n_entries)


def test_stale_quanta_skipped_after_drop_or_completion():
    db = P.Database(dict(port_src().tables))
    bi = db.create_index(P.IndexDescriptor("narrow", (1,)), "vap")
    service = P_bs.BuildService(db, tuner=None)
    service.queue.append(P_bs.BuildQuantum("narrow:1", 4))
    service.queue.append(P_bs.BuildQuantum("narrow:9", 4))  # never existed
    assert service.apply_next() > 0.0
    assert service.apply_next() == 0.0
    db.vap_build_step(bi, N_PAGES)  # finish the build
    assert not bi.building
    service.queue.append(P_bs.BuildQuantum("narrow:1", 4))
    assert service.apply_next() == 0.0  # completed index: no-op
    db.drop_index("narrow:1")
    service.queue.append(P_bs.BuildQuantum("narrow:1", 4))
    assert service.apply_next() == 0.0  # dropped index: no-op
    assert service.drain() == 0.0  # empty queue


def test_constants_and_quantum_fields_match_reference():
    for name in ("THROUGHPUT_EWMA_ALPHA", "MAX_DRAIN_BURST_MS",
                 "URGENT_UTILITY_FRAC", "CYCLE_DRAIN_TARGET_MS"):
        assert getattr(P_bs, name) == getattr(R_bs, name), name
    for cls in ("BuildQuantum", "CyclePlan"):
        assert [(f.name, f.default) for f in dataclasses.fields(
            getattr(P_bs, cls))] == [(f.name, f.default) for f in
                                     dataclasses.fields(getattr(R_bs, cls))]


# ---------------------------------------------------------------------------
# Stub databases: the queue arithmetic, both packages side by side
# ---------------------------------------------------------------------------

class _StubIndex:
    def __init__(self):
        self.building = True
        self.scheme = "vap"
        self.applied = 0


class _StubDB:
    def __init__(self, names=("ix",)):
        self.clock_ms = 0.0
        self.indexes = {n: _StubIndex() for n in names}

    def vap_build_step(self, bi, pages, shard=None, page_list=None):
        bi.applied += pages
        return float(pages)


def _services(quanta, **kw):
    """One service per package over its own stub DB, each queue filled
    with the same (name, pages, utility) quanta."""
    out = []
    for bs in (R_bs, P_bs):
        svc = bs.BuildService(_StubDB({q[0] for q in quanta}), tuner=None,
                              **kw)
        for name, pages, util in quanta:
            svc.queue.append(bs.BuildQuantum(name, pages, utility=util))
        out.append(svc)
    return out


def _queue(svc):
    return [(q.index_name, q.pages, q.utility) for q in svc.queue]


@pytest.mark.parametrize("rate", [0.0, 1.0, 3.0, 40.0, 1e3])
@pytest.mark.parametrize("depth,cap", [(0, 4), (3, None), (4, 4), (9, 4),
                                       (17, 4), (40, 3)])
def test_drain_burst_size_matches_reference(depth, cap, rate):
    """The escalation arithmetic with the same measured ``pages_per_ms``
    (quanta of 1-3 pages): burst sizes, escalation counts and the
    estimate, call after call as the queue drains."""
    quanta = [(f"ix{i % 3}", 1 + i % 3, 0.0) for i in range(depth)]
    r, p = _services(quanta, max_queue_depth=cap)
    for svc in (r, p):
        svc.pages_per_ms = rate
    for _ in range(depth + 1):
        size = p.drain_burst_size()
        assert size == r.drain_burst_size()
        assert p.escalations == r.escalations
        assert p.estimated_drain_ms() == r.estimated_drain_ms()
        assert p.suggested_pages_per_cycle() == r.suggested_pages_per_cycle()
        for _ in range(max(size, 1)):
            for svc in (r, p):
                svc.queue.popleft() if svc.queue else None
    paused = _services(quanta, max_queue_depth=cap)[1]
    paused.paused = True
    assert paused.drain_burst_size() == 0


@pytest.mark.parametrize("keep", [0, 2, 3, 5, 8])
@pytest.mark.parametrize("utilities", [
    [5.0, 1.0, 3.0, 1.0, 4.0],
    [1.0, 1.0, 2.0, 1.0],
    [0.0, 0.0, 0.0],
    [2.5, 7.0, 7.0, 0.1, 9.0, 0.1, 3.0],
])
def test_shed_lowest_utility_matches_reference(utilities, keep):
    quanta = [(f"ix{i}", 1, u) for i, u in enumerate(utilities)]
    r, p = _services(quanta)
    assert p.shed_lowest_utility(keep) == r.shed_lowest_utility(keep)
    assert _queue(p) == _queue(r)
    assert p.shed_quanta == r.shed_quanta


@pytest.mark.parametrize("frac", [0.0, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("utilities", [
    [10.0, 2.0, 8.0, 1.0],
    [0.0, 0.0, 0.0],
    [3.0, 3.0, 1.5, 6.0, 2.9],
])
def test_drain_urgent_matches_reference(utilities, frac):
    """The urgent share applies (work charged), the rest stays queued
    in order; no spread drains everything."""
    quanta = [(f"ix{i}", 2 + i, u) for i, u in enumerate(utilities)]
    r, p = _services(quanta)
    assert p.drain_urgent(frac=frac) == r.drain_urgent(frac=frac)
    assert _queue(p) == _queue(r)
    assert [(n, ix.applied) for n, ix in sorted(p.db.indexes.items())] == [
        (n, ix.applied) for n, ix in sorted(r.db.indexes.items())]
    if len(set(utilities)) == 1:
        assert p.pending() == 0
