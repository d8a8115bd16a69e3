"""Exit test of the port's first slice: the paper's loop, end to end.

A quickstart-shaped loop -- LOW-S and MOD-S read bursts through
``execute_batch(use_kernel=True)`` and ``execute``, interleaved UPDATE
and INSERT statements, one predictive tuning cycle per burst -- runs in
the reference and in the port, started from one state through
``from_reference``.  Every ``ExecStats`` field except ``wall_s`` and
``tier``, the simulated clock, the monitor window and the tuner's
decisions (indexes created and dropped, build quanta emitted, pages
built) must match exactly.

Forecasts are float32 and bit-equal too: the port rounds each
Holt-Winters update as XLA on the CPU contracts it, with one fused
multiply-add (``repro_torch.core.forecaster``).
"""

import _torch_threads  # noqa: F401  (first: pins torch's threads)

import dataclasses

import numpy as np
import pytest
import torch

import repro.api as R
from repro.core import build_service as R_bs
from repro.core import forecaster as R_hw
from repro_torch import api as P
from repro_torch.core import build_service as P_bs
from repro_torch.core import forecaster as P_hw
from repro_torch.core.convert import from_reference
from repro_torch.core.executor import Query as PQuery

STAT_FIELDS = ("cost_units", "latency_ms", "used_index", "agg_sum", "count",
               "rows_modified", "populate_units", "shard_pages")


def _port_query(q):
    return PQuery(**{f.name: getattr(q, f.name)
                     for f in dataclasses.fields(q)})


def _stats(s):
    return tuple(getattr(s, f) for f in STAT_FIELDS)


def _twin(n_rows=3000, page_size=64, seed=5, **cfg):
    src = R.make_tuner_db(n_rows=n_rows, page_size=page_size, seed=seed)
    tables, _ = from_reference(
        tables={k: [np.asarray(x) for x in t] for k, t in src.tables.items()},
        device="cpu")
    rdb, pdb = R.Database(dict(src.tables)), P.Database(tables)
    rt = R.PredictiveTuner(rdb, R.TunerConfig(**cfg))
    pt = P.PredictiveTuner(pdb, P.TunerConfig(**cfg))
    return src, rdb, pdb, rt, pt


def _assert_same_state(rdb, pdb):
    assert rdb.clock_ms == pdb.clock_ms
    assert [dataclasses.astuple(r) for r in rdb.monitor.records] == [
        dataclasses.astuple(r) for r in pdb.monitor.records]
    assert sorted(rdb.indexes) == sorted(pdb.indexes)
    for name, rb in rdb.indexes.items():
        pb = pdb.indexes[name]
        assert (int(rb.vap.built_pages), int(rb.vap.n_entries)) == (
            pb.vap.built_pages, pb.vap.n_entries)
        assert (rb.complete, rb.building, rb.last_used_ms) == (
            pb.complete, pb.building, pb.last_used_ms)
    rt, pt = rdb.tables["narrow"], pdb.tables["narrow"]
    assert int(rt.n_rows) == pt.n_rows
    np.testing.assert_array_equal(pt.data.numpy(), np.asarray(rt.data))
    np.testing.assert_array_equal(pt.end_ts.numpy(), np.asarray(rt.end_ts))


def _assert_same_cycle(rp, pp, rtun, ptun):
    assert [(q.index_name, q.pages, q.shard, q.page_list)
            for q in rp.quanta] == [(q.index_name, q.pages, None, q.page_list)
                                    for q in pp.quanta]
    assert [q.utility for q in pp.quanta] == [q.utility for q in rp.quanta]
    assert rp.decide_work == pp.decide_work
    assert ptun.forecasts == rtun.forecasts
    assert (rtun.last_label, rtun.cycles) == (ptun.last_label, ptun.cycles)


def test_quickstart_loop_matches_reference():
    """The slice's exit test (see the module docstring)."""
    src, rdb, pdb, rtun, ptun = _twin(
        storage_budget_bytes=50e3, pages_per_cycle=8,
        max_build_pages_per_cycle=12, candidate_min_count=2)
    gen = R.QueryGen(src, selectivity=0.02, seed=3)
    kernel_tiers, hybrid_bursts = 0, 0
    for burst in range(8):
        qs = [gen.low_s(attr=3) for _ in range(5)] + [
            gen.mod_s() for _ in range(5)]
        qs.insert(4, gen.low_u())
        qs.insert(8, gen.ins(n=8))
        rs = rdb.execute_batch(qs, use_kernel=True)
        ps = pdb.execute_batch([_port_query(q) for q in qs], use_kernel=True)
        for i, (a, b) in enumerate(zip(rs, ps)):
            assert _stats(a) == _stats(b), (burst, i, qs[i].template)
            assert b.wall_s >= 0.0
        kernel_tiers += sum(s.tier == "kernel" for s in ps)
        hybrid_bursts += any(s.used_index for s in ps)
        q1 = gen.low_s(attr=3)
        assert _stats(rdb.execute(q1)) == _stats(pdb.execute(_port_query(q1)))
        _assert_same_state(rdb, pdb)
        rp, pp = rtun.decide(), ptun.decide()
        _assert_same_cycle(rp, pp, rtun, ptun)
        rw = sum(R_bs.apply_quantum(rdb, q) for q in rp.quanta)
        pw = sum(P_bs.apply_quantum(pdb, q) for q in pp.quanta)
        assert rw == pw
        _assert_same_state(rdb, pdb)
    assert kernel_tiers > 0 and hybrid_bursts > 0


@pytest.mark.parametrize("use_kernel", [False, True])
def test_tuning_cycle_bursts_match_reference(use_kernel):
    """``tuning_cycle`` (decide + apply) with the default budget, and
    read bursts with kernels off and on, over a FULL index too."""
    src, rdb, pdb, rtun, ptun = _twin(n_rows=2000, seed=8,
                                      candidate_min_count=2,
                                      pages_per_cycle=16)
    for db in (rdb, pdb):
        mod = R if db is rdb else P
        bi = db.create_index(mod.IndexDescriptor("narrow", (2,)), "full")
        db.vap_build_step(bi, pages=10_000)
        assert bi.complete
    gen = R.QueryGen(src, selectivity=0.05, seed=4)
    for burst in range(4):
        qs = [gen.low_s(attr=2) for _ in range(3)] + [
            gen.low_s(attr=1) for _ in range(3)] + [gen.mod_s(), gen.ins(4)]
        rs = rdb.execute_batch(qs, use_kernel=use_kernel)
        ps = pdb.execute_batch([_port_query(q) for q in qs],
                               use_kernel=use_kernel)
        assert [_stats(s) for s in rs] == [_stats(s) for s in ps]
        assert rtun.tuning_cycle() == ptun.tuning_cycle()
        _assert_same_state(rdb, pdb)
    assert "narrow:2" in pdb.indexes


def _assert_hw_equal(ref, port):
    """Holt-Winters states are bit-equal (float32 bits compared)."""
    for name in ("level", "trend", "season", "t"):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)


@pytest.mark.parametrize("params", [(0.5, 0.3, 0.4), (0.37, 0.21, 0.63)])
def test_forecaster_matches_reference_within_float32_ulps(params):
    """Bit-equal: 0 ulps, at the default smoothing parameters and at
    ones whose products are all inexact, with no re-sync between
    steps; the unbatched jitted update, the vmapped batch form and
    forecasts at h in {1, 2, 3} (h * trend exact and not)."""
    rng = np.random.default_rng(0)
    rs, ps = R_hw.init_state(16), P_hw.init_state(16, device="cpu")
    for y in rng.uniform(0.0, 3e5, 200):
        rs = R_hw.update(rs, float(y), *params)
        ps = P_hw.update(ps, float(y), *params)
        _assert_hw_equal(rs, ps)
        for h in (1, 3):
            assert float(P_hw.forecast(ps, h)) == float(R_hw.forecast(rs, h))
    rb = R_hw.init_state(8, batch=64)
    pb = P_hw.init_state(8, batch=64, device="cpu")
    for ys in rng.uniform(0.0, 3e5, (20, 64)).astype(np.float32):
        rb = R_hw.update_batch(rb, ys, *params)
        pb = P_hw.update_batch(pb, ys, *params)
        _assert_hw_equal(rb, pb)
    for h in (1, 2, 3):
        np.testing.assert_array_equal(P_hw.forecast_batch(pb, h).numpy(),
                                      np.asarray(R_hw.forecast_batch(rb, h)))


def test_unported_features_raise():
    src = P.make_tuner_db(n_rows=500, page_size=64, device="cpu")
    db = P.Database(dict(src.tables))
    gen = P.QueryGen(src)
    # HIGH-S joins and VBP indexes are ported: a join and a VBP
    # population equal the reference's on the same tables
    # (tests/test_torch_joins.py, tests/test_torch_vbp.py).
    rsrc = R.make_tuner_db(n_rows=500, page_size=64)
    rdb = R.Database(dict(rsrc.tables))
    rgen = R.QueryGen(rsrc)
    assert _stats(db.execute(gen.high_s())) == _stats(
        rdb.execute(rgen.high_s()))
    pbi = db.create_index(P.IndexDescriptor("narrow", (1,)), "vbp")
    rbi = rdb.create_index(R.IndexDescriptor("narrow", (1,)), "vbp")
    q, rq = gen.low_s(pos=0.4), rgen.low_s(pos=0.4)
    cap = src.tables["narrow"].capacity
    assert db.vbp_populate(pbi, q, cap) == rdb.vbp_populate(rbi, rq, cap)
    assert _stats(db.execute(q)) == _stats(rdb.execute(rq))
    assert db.planner.plan_scan(q).path == "pure_vbp"
    assert db.clock_ms == rdb.clock_ms
    db.drop_index(pbi.desc.name)
    # Sharded storage is ported: the tables are partitioned round-robin
    # (parity with the reference in tests/test_torch_sharded.py).
    sharded = P.Database(dict(src.tables), num_shards=2)
    assert sharded.num_shards == 2
    assert isinstance(sharded.tables["narrow"], P.ShardedTable)
    assert sharded.execute_batch([gen.low_s()])[0].count >= 0
    # Coverage bitmaps are ported: crack-on-scan and decay now run.
    db.crack_on_scan = True
    db.index_decay = True
    assert db.execute_batch([gen.low_s()])[0].count >= 0
    P.PredictiveTuner(db).decide()
    # Shard-aware tuning is ported: on a plain table it changes nothing
    # (tests/test_torch_shard_tuning.py).
    db.shard_aware_tuning = True
    assert db.execute_batch([gen.low_s()])[0].shard_pages == ()
    P.PredictiveTuner(db).decide()
    # Fault injection is ported too (tests/test_torch_faults.py): one
    # schedule prices the same retries and straggler time as in the
    # reference, on single scans and on batched groups.
    fdb, rfdb = P.Database(dict(src.tables)), R.Database(dict(rsrc.tables))
    sched = dict(seed=3, scan_error_rate=0.5, straggler_rate=0.5)
    fdb.fault_injector = P.FaultInjector(P.FaultSchedule(**sched))
    rfdb.fault_injector = R.FaultInjector(R.FaultSchedule(**sched))
    fgen, rfgen = P.QueryGen(src, seed=9), R.QueryGen(rsrc, seed=9)
    for _ in range(3):
        qs = [fgen.low_s(), fgen.mod_s()]
        rqs = [rfgen.low_s(), rfgen.mod_s()]
        assert [_stats(s) for s in fdb.execute_batch(qs + qs[:1])] == [
            _stats(s) for s in rfdb.execute_batch(rqs + rqs[:1])]
        assert _stats(fdb.execute(qs[1])) == _stats(rfdb.execute(rqs[1]))
    assert fdb.clock_ms == rfdb.clock_ms
    assert fdb.fault_injector.scan_retries == (
        rfdb.fault_injector.scan_retries) > 0


def test_zone_map_matches_reference():
    src, rdb, pdb, _, _ = _twin(n_rows=1000, seed=2)
    for attr in (1, 3):
        for a, b in zip(rdb.zone_map("narrow", attr),
                        pdb.zone_map("narrow", attr)):
            np.testing.assert_array_equal(b, a)
